"""Whisper-base — enc-dec; conv/mel frontend STUBBED (frame embeddings in).
[arXiv:2212.04356]"""
from repro_torch.configs.base import ArchConfig, EncoderConfig

CONFIG = ArchConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865, head_dim=64,
    encoder=EncoderConfig(n_layers=6, n_frames=1500, d_model=512,
                          n_heads=8, d_ff=2048),
    citation="arXiv:2212.04356",
)
