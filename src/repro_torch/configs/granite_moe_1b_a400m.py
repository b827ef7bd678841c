"""Granite-3.0-1B-A400M — MoE, 32 experts top-8, per-expert d_ff=512.
[hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=512, vocab=49155, head_dim=64,
    moe=MoEConfig(num_experts=32, top_k=8, d_expert=512),
    tie_embeddings=True,
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
