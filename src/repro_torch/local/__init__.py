"""repro_torch.local: the local-compute axis (FedAvg-E / FedProx / FedDyn).

What each device does between two uplink uses, as an axis orthogonal to
the MAC scheme registry: the port of the reference's ``repro.local``
(:mod:`repro_torch.local.work`).
"""

from repro_torch.local.work import (  # noqa: F401
    LOCAL_OVERRIDE_ATTRS,
    LOCAL_REGISTRY,
    LocalWork,
    get_local,
    local_device_grads,
    register_local,
)
