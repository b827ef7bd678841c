from repro_torch.models.model import (  # noqa: F401
    init_params, loss_fn, param_count,
)
