"""Device time of the devices' gradients a round (the models layer): CUDA
events around each call of ``CompiledFedLLM._grads``, per round."""


def read(trace):
    ms = trace.spans.get("grads")
    return sum(ms) / trace.rounds if ms else None
