"""Device time of the hybrid's devices' gradients a round (the models
layer, Mamba2 and attention together): CUDA events around each call of
``CompiledFedLLM._grads``, the forward, remat's recompute and the
backward, per round, as ``grads_ms`` reads the dense and MoE cells."""


def read(trace):
    ms = trace.spans.get("grads")
    return sum(ms) / trace.rounds if ms else None
