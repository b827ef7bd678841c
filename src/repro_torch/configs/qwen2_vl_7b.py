"""Qwen2-VL-7B backbone — M-RoPE decoder; vision tower STUBBED (patch
embeddings in). [arXiv:2409.12191]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab=152064, head_dim=128,
    rope_theta=1000000.0,
    mrope_sections=(16, 24, 24),
    n_vision_tokens=256,
    citation="arXiv:2409.12191",
)
