"""The least time a streamed A-DSGD round on granite-4.0-h's hybrid decoder
could take on one H100, counted from the cell's shapes alone.

As :mod:`fedbench.cost.round` counts a dense or MoE round, with the
tensor cores' work of the hybrid's forward and backward passes (three
forward passes, no recompute) in place of the dense model's:

* each Mamba2 layer: the input and output projections, and the chunked
  SSD's products, causal within a chunk: ``C B^T`` per group and its
  product with the discretised x per head, each chunk's state (``x^T B``
  decayed to the chunk's end) and the carried state's output (``C h``);
* each attention layer: the q, k, v, o projections and the causal score
  and value products;
* every layer's SwiGLU MLP, and the tied head over the predicted
  positions.

The kernels' operations at the float32 CUDA-core peak and the HBM bytes
are :mod:`fedbench.cost.round`'s terms.  The maximum of the three times is
a lower bound of the round's time; a share of it cannot pass 100 %.
"""
from __future__ import annotations

from fedbench.cost import kernels
from fedbench.cost.round import BF16_FLOPS_PER_S


def _causal(q: int) -> int:
    """Entries on or below the diagonal of a ``q x q`` matrix."""
    return q * (q + 1) // 2


def forward_flops(arch: dict, batch: int, seq_len: int) -> float:
    """FLOPs of one forward pass of ``batch`` sequences of ``seq_len``
    tokens; ``arch`` holds the configuration file's published keys."""
    d, V = arch["hidden_size"], arch["vocab_size"]
    hq, hkv = arch["num_attention_heads"], arch["num_key_value_heads"]
    h = d // hq
    H, P = arch["mamba_n_heads"], arch["mamba_d_head"]
    N, G = arch["mamba_d_state"], arch["mamba_n_groups"]
    Q = arch["mamba_chunk_size"]
    d_in = arch["mamba_expand"] * d
    conv_dim = d_in + 2 * G * N
    tokens = batch * seq_len
    n_chunks = -(-seq_len // Q)
    mlp = 2 * 3 * d * arch["shared_intermediate_size"] * tokens
    mamba = (2 * d * (d_in + conv_dim + H) * tokens
             + 2 * d_in * d * tokens
             + 2 * batch * n_chunks * _causal(Q) * (G * N + H * P)
             + 2 * 2 * batch * n_chunks * Q * H * P * N)
    attn = (2 * d * (2 * hq * h + 2 * hkv * h) * tokens
            + 2 * 2 * hq * h * batch * _causal(seq_len))
    head = 2 * d * V * batch * (seq_len - 1)
    kinds = arch["layer_types"][: arch["num_hidden_layers"]]
    n_attn = sum(k == "attention" for k in kinds)
    return (len(kinds) * mlp + n_attn * attn
            + (len(kinds) - n_attn) * mamba + head)


def least_round_s(arch: dict, shapes: dict) -> dict:
    """The round's least time and each resource's share of the work
    (``shapes`` as :func:`fedbench.cost.round.least_round_s` reads them)."""
    m, nch, nb = shapes["m"], shapes["n_chunks"], shapes["blocks"]
    c, s, d = shapes["c"], shapes["s"], shapes["d"]
    flops = 3 * m * forward_flops(arch, shapes["batch"], shapes["seq_len"])
    per_chunk = [kernels.ef_sparsify(m, nb * c),
                 kernels.ota_project(m, nb, c, s),
                 kernels.amp_fused(1, nb, s, c, shapes["iters"])]
    k_ops = nch * sum(k.n_ops for k in per_chunk)
    k_bytes = nch * sum(k.n_bytes for k in per_chunk)
    outside = 4 * (m * d + d + 7 * d)
    times = {"tensor_s": flops / BF16_FLOPS_PER_S,
             "cuda_core_s": k_ops / kernels.FP32_OPS_PER_S,
             "hbm_s": (k_bytes + outside) / kernels.HBM_BYTES_PER_S}
    return dict(times, least_s=max(times.values()))
