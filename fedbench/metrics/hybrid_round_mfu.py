"""The hybrid round's share of the H100's peaks: the round's least time
(``fedbench.cost.hybrid_round.least_round_s``) over the traced window's
unprofiled round on the host's clock, in percent, as ``round_mfu`` reads
a dense or MoE round."""
from fedbench.cost.hybrid_round import least_round_s


def read(trace):
    if trace.round_s <= 0 or "layer_types" not in trace.config:
        return None
    least = least_round_s(trace.config, trace.shapes)["least_s"]
    return 100.0 * least * trace.rounds / trace.round_s
