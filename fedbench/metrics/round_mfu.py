"""The whole round's share of the H100's peaks: the round's least time
(``fedbench.cost.round.least_round_s``: the busiest of tensor cores,
CUDA cores and HBM for the work the cell's shapes need) over the traced
round's time, in percent.  The round is timed on the host's clock
without the profiler, which slows the host-paced gradients."""
from fedbench.cost.round import least_round_s


def read(trace):
    if trace.round_s <= 0:
        return None
    least = least_round_s(trace.config, trace.shapes)["least_s"]
    return 100.0 * least * trace.rounds / trace.round_s
