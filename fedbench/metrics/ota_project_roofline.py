"""``ota_project``'s share of its roofline: the least time of its launches
on the H100's peaks (``fedbench.cost.kernels.ota_project`` per chunk, the
m devices' rows at once) over their device time in the trace, in
percent."""
from fedbench.cost import kernels


def read(trace):
    n, seconds = trace.kernel_s("ota_project_kernel")
    if n == 0 or seconds <= 0:
        return None
    sh = trace.shapes
    ms, _ = kernels.bound(*kernels.ota_project(sh["m"], sh["blocks"],
                                               sh["c"], sh["s"]))
    return 100.0 * n * ms * 1e-3 / seconds
