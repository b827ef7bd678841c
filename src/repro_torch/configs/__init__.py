from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS, ArchConfig, OTAConfig, approx_param_count, get_config,
    ota_overrides,
)
