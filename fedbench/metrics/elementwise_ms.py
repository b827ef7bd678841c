"""Device time a round of every kernel that is neither one of the port's
CUDA kernels nor a library's matrix-product or attention kernel: the RNG
draws, the elementwise passes, casts, reductions and sorts
(``fedbench.trace.kernel_class``)."""
from fedbench.trace import kernel_class


def read(trace):
    lo, hi = trace.window
    us = sum(min(e, hi) - max(s, lo) for n, s, e in trace.kernels
             if kernel_class(n) == "other" and e > lo and s < hi)
    return us * 1e-3 / trace.rounds if trace.kernels else None
