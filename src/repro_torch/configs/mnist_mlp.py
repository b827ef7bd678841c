"""The paper's own model: single-layer network on 28x28 inputs, 10 classes,
d = 784*10 + 10 = 7850 parameters (paper §VI)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mnist-mlp", family="mlp",
    n_layers=1, d_model=784, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=10,
    citation="Amiri & Gunduz 2020, §VI",
)
