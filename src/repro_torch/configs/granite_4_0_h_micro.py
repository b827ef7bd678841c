"""Granite-4.0-H-Micro — hybrid decoder: 36 published Mamba2 mixers and 4
NoPE GQA attention layers (indices 5, 15, 25, 35), each followed by a
dense SwiGLU MLP in the same block, with Granite's embedding, attention,
residual and logits multipliers.  The port's own config: it is not in
``ARCH_IDS``.  [hf:ibm-granite/granite-4.0-h-micro]"""
from repro_torch.configs.base import ATTN, MAMBA2_MLP, ArchConfig, SSMConfig

#: the published ``layer_types``: attention at 5, 15, 25 and 35
LAYER_TYPES = tuple("attention" if i % 10 == 5 else "mamba"
                    for i in range(40))

CONFIG = ArchConfig(
    name="granite-4.0-h-micro", family="hybrid",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab=100352, head_dim=64,
    tie_embeddings=True, norm_eps=1e-5,
    block_pattern=tuple(ATTN if t == "attention" else MAMBA2_MLP
                        for t in LAYER_TYPES),
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, conv_width=4,
                  chunk=256, published=True, n_groups=1),
    embedding_multiplier=12.0, attention_multiplier=0.015625,
    residual_multiplier=0.22, logits_scaling=8.0,
    position_embedding="nope",
    citation="hf:ibm-granite/granite-4.0-h-micro",
)
