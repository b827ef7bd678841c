from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS, INPUT_SHAPES, ArchConfig, EncoderConfig, MoEConfig, OTAConfig,
    RWKVConfig, SSMConfig, ShapeConfig, TrainConfig, active_param_count,
    approx_param_count, get_config, ota_overrides,
)
