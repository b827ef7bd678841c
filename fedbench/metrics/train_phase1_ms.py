"""Device time of the sharded trainer's phase 1 a step (each OTA device's
gradient on its rank thread): the port's ``step.grads`` span
(``repro_torch.train.trainer``) of the traced window's unprofiled step."""


def read(trace):
    ms = trace.spans.get("step.grads")
    return sum(ms) / trace.rounds if ms else None
