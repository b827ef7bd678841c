"""Device time a round of the Mamba2 mixers' forward passes (the models
layer): the port's ``model.mamba`` spans (``repro_torch.tracing``) of the
traced window's unprofiled round, summed.  Backward and remat's
recompute run on autograd's device thread outside the round's spans, so
it is the forward alone."""


def read(trace):
    ms = trace.spans.get("model.mamba")
    return sum(ms) / trace.rounds if ms else None
