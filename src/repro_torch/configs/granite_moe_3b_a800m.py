"""Granite-3.0-3B-A800M — MoE, 40 experts top-8, per-expert d_ff=512.
[hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab=49155, head_dim=64,
    moe=MoEConfig(num_experts=40, top_k=8, d_expert=512),
    tie_embeddings=True,
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
