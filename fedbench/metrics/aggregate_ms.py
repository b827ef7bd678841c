"""Device time of the streamed aggregation a round (encode, MAC, decode of
every chunk): CUDA events around each call of ``fedllm.stream_round``,
per round."""


def read(trace):
    ms = trace.spans.get("aggregate")
    return sum(ms) / trace.rounds if ms else None
