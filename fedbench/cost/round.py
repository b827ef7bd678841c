"""The least time a streamed A-DSGD round could take on one H100, counted
from the cell's shapes alone, whatever implements it.

A round is the m devices' forward and backward passes, the stream of
chunks through the three kernels (error feedback and sparsification, the
projection, the fused AMP decode) and Adam at the PS.  Its work is put on
the three resources of the card, and the round can be no faster than the
busiest of them:

* tensor cores: the models' forward and backward FLOPs at the bfloat16
  peak, counted as three forward passes (no recompute): the dense or
  active-expert products, the causal attention's score and value products,
  and the tied head over the predicted positions;
* CUDA cores: the kernels' operations (:mod:`fedbench.cost.kernels`) at
  the float32 peak;
* HBM: the kernels' bytes, and outside them the gradients written once,
  the parameters read once, and Adam's read of ĝ, parameters and moments
  and write of parameters and moments.

The maximum of the three times is a lower bound of the round's time; a
share of it cannot pass 100 %.
"""
from __future__ import annotations

from fedbench.cost import kernels

#: H100 SXM dense bfloat16 tensor-core peak (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12


def forward_flops(arch: dict, batch: int, seq_len: int) -> float:
    """FLOPs of one forward pass of ``batch`` sequences of ``seq_len``
    tokens; ``arch`` holds a configuration file's published keys."""
    d, L = arch["hidden_size"], arch["num_hidden_layers"]
    hq, hkv = arch["num_attention_heads"], arch["num_key_value_heads"]
    h = arch.get("head_dim", d // hq)
    tokens = batch * seq_len
    proj = 2 * d * (2 * hq * h + 2 * hkv * h)
    if arch.get("num_local_experts"):
        e, k = arch["num_local_experts"], arch["num_experts_per_tok"]
        mlp = 2 * d * e + k * 2 * 3 * d * arch["intermediate_size"]
    else:
        mlp = 2 * 3 * d * arch["intermediate_size"]
    # causal attention: query i meets i + 1 keys, in the score and the
    # value products
    attn = 2 * 2 * hq * h * batch * seq_len * (seq_len + 1) // 2
    head = 2 * d * arch["vocab_size"] * batch * (seq_len - 1)
    return L * (tokens * (proj + mlp) + attn) + head


def least_round_s(arch: dict, shapes: dict) -> dict:
    """The round's least time and each resource's share of the work.

    ``shapes``: ``m`` devices, ``batch`` x ``seq_len`` tokens each, ``d``
    parameters, ``n_chunks`` chunks of ``blocks`` blocks of ``c`` entries
    projected to ``s``, ``iters`` AMP iterations.
    """
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
