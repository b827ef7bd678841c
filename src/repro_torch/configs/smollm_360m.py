"""SmolLM-360M — llama-arch small dense GQA. [hf:HuggingFaceTB/SmolLM-135M]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab=49152, head_dim=64, tie_embeddings=True,
    citation="hf:HuggingFaceTB/SmolLM-135M",
)
