"""RWKV6 (Finch) 3B — attention-free, data-dependent decay. [arXiv:2404.05892]"""
from repro_torch.configs.base import ArchConfig, RWKVConfig

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab=65536, head_dim=64,
    rwkv=RWKVConfig(head_dim=64, chunk=256, decay_lora=64),
    citation="arXiv:2404.05892",
)
