"""Zamba2-7B — hybrid Mamba2 backbone with a shared GQA attention block
applied every 6 Mamba2 layers (weights reused). [arXiv:2411.15242]"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000, head_dim=112,
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, conv_width=4, chunk=256),
    shared_attn_every=6,
    citation="arXiv:2411.15242",
)
