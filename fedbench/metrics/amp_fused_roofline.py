"""``amp_fused``'s share of its roofline: the least time of its launches
on the H100's peaks (``fedbench.cost.kernels.amp_fused`` per chunk) over
their device time in the trace, in percent."""
from fedbench.cost import kernels


def read(trace):
    n, seconds = trace.kernel_s("amp_fused_kernel")
    if n == 0 or seconds <= 0:
        return None
    sh = trace.shapes
    ms, _ = kernels.bound(*kernels.amp_fused(1, sh["blocks"], sh["s"],
                                             sh["c"], sh["iters"]))
    return 100.0 * n * ms * 1e-3 / seconds
