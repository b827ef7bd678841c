"""Shared model layers: norms, RoPE / M-RoPE, GQA attention, SwiGLU and GELU
MLPs.

The port of the reference's ``repro/models/layers.py``.  Params are nested
dicts of tensors; every ``init_*`` takes a key of :mod:`repro_torch.rng`,
or a stack of keys ``(..., 2)``, which gives every leaf that leading shape
with the bits ``jax.vmap`` of the reference's init gives (the stacked
layers of a model).  Every ``apply`` is a pure function.  Activations may
be bfloat16; the casts follow the reference's ``.astype`` one for one:
norms, RoPE and the softmax run in float32 and cast back, the attention
scores are taken to float32 before the scale and the additive mask
(``-1e30``), and the probabilities go back to the activations' dtype.
Attention stays plain torch, as the reference computes it outside any
Pallas kernel; ``scaled_dot_product_attention`` would change those
numerics.  The KV-cache branch of :func:`attention` (decode) writes the
new keys and values into the cache in place and attends over the whole
cache.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import rng

Params = Dict[str, Any]


def _lead(key: torch.Tensor) -> Tuple[int, ...]:
    return tuple(key.shape[:-1])


def _dense_init(key, in_dim, out_dim, scale=None):
    """``truncated_normal(key, -2, 2, (in_dim, out_dim)) * scale``, the
    scale ``1 / sqrt(in_dim)`` in float32 unless given."""
    if scale is None:
        scale = np.float32(1.0) / np.sqrt(np.float32(in_dim))
    return (rng.truncated_normal(key, -2.0, 2.0, (in_dim, out_dim))
            * float(np.float32(scale)))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, lead: Tuple[int, ...] = (), device=None) -> Params:
    return {"w": torch.ones(lead + (d,), dtype=torch.float32, device=device)}


def rms_norm(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["w"]
    return out.to(x.dtype)


def init_layernorm(d: int, lead: Tuple[int, ...] = (), device=None) -> Params:
    return {"w": torch.ones(lead + (d,), dtype=torch.float32, device=device),
            "b": torch.zeros(lead + (d,), dtype=torch.float32, device=device)}


def layer_norm(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, -1, keepdim=True)
    var = torch.var(xf, -1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["w"] + p["b"]).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE and M-RoPE
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """``1 / theta ** (arange(half) / half)`` in float32, the power as XLA
    computes it (:func:`repro_torch.rng.pow_f32`); made once per head
    width, theta and device (a constant of the model, read by every
    attention call)."""
    half = head_dim // 2
    expo = torch.arange(half, dtype=torch.float32, device=device) / half
    base = torch.full_like(expo, float(np.float32(theta)))
    return 1.0 / rng.pow_f32(base, expo)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, L, H, Dh); positions: (B, L) int32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (half,)
    return _rotate(x, positions[..., None].float() * freqs)    # (B, L, half)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. positions3: (B, L, 3) = (t, h, w) ids.

    The head_dim/2 frequency slots are split into |sections| groups; group i
    rotates by positions3[..., i] (arXiv:2409.12191 §2.1).
    """
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (half,)
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(sections, device=x.device),
        output_size=half)                                       # (half,)
    pos = positions3.float()[..., sec_id]                       # (B, L, half)
    return _rotate(x, pos * freqs)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None
    causal: bool = True
    mrope_sections: Optional[Tuple[int, int, int]] = None
    norm_eps: float = 1e-5


def init_attention(key, spec: AttnSpec) -> Params:
    ks = rng.split(key, 4).unbind(-2)
    d, h = spec.d_model, spec.head_dim
    p = {
        "wq": _dense_init(ks[0], d, spec.n_heads * h),
        "wk": _dense_init(ks[1], d, spec.n_kv_heads * h),
        "wv": _dense_init(ks[2], d, spec.n_kv_heads * h),
        "wo": _dense_init(ks[3], spec.n_heads * h, d),
    }
    if spec.qk_norm:
        p["q_norm"] = init_rmsnorm(h, _lead(key), key.device)
        p["k_norm"] = init_rmsnorm(h, _lead(key), key.device)
    return p


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: Optional[int], k_valid: Optional[torch.Tensor] = None):
    """(B, 1, Lq, Lk) additive bias in fp32."""
    diff = q_pos[:, :, None] - k_pos[:, None, :]        # (B, Lq, Lk)
    ok = torch.ones_like(diff, dtype=torch.bool)
    if causal:
        ok &= diff >= 0
    if window is not None:
        ok &= diff < window
    if k_valid is not None:
        ok &= k_valid[:, None, :]
    bias = torch.where(ok, 0.0, -1e30).to(torch.float32)
    return bias[:, None, :, :]


def attention(p: Params, spec: AttnSpec, x: torch.Tensor,
              positions: torch.Tensor,
              kv_cache: Optional[Params] = None,
              cache_index=None,
              kv_source: Optional[torch.Tensor] = None,
              kv_positions: Optional[torch.Tensor] = None):
    """GQA attention.

    x: (B, L, D).  positions: (B, L) (or (B, L, 3) for M-RoPE).
    kv_cache: {"k","v": (B, C, Hkv, Dh), "pos": (B, C) int32} -- decode
      mode: the L new K/V entries and their absolute positions are written
      at slot ``cache_index`` (a python int) and attention runs over the
      whole cache.  The cache's tensors are updated in place (the reference
      donates them) and returned as the new cache.
    kv_source: cross-attention source (B, Lsrc, D) (whisper decoder).
    Returns (out, new_kv_cache|None).
    """
    B, L, _ = x.shape
    h, hq, hkv = spec.head_dim, spec.n_heads, spec.n_kv_heads
    q = (x @ p["wq"].to(x.dtype)).reshape(B, L, hq, h)
    src = kv_source if kv_source is not None else x
    k = (src @ p["wk"].to(x.dtype)).reshape(B, src.shape[1], hkv, h)
    v = (src @ p["wv"].to(x.dtype)).reshape(B, src.shape[1], hkv, h)
    if spec.qk_norm:
        q = rms_norm(q, p["q_norm"], spec.norm_eps)
        k = rms_norm(k, p["k_norm"], spec.norm_eps)
    new_cache = None
    if kv_source is None:  # no rope on cross-attention
        kpos = kv_positions if kv_positions is not None else positions
        if spec.mrope_sections is not None:
            q = apply_mrope(q, positions, spec.rope_theta,
                            spec.mrope_sections)
            k = apply_mrope(k, kpos, spec.rope_theta, spec.mrope_sections)
            q_pos1 = positions[..., 0]
        else:
            q = apply_rope(q, positions, spec.rope_theta)
            k = apply_rope(k, kpos, spec.rope_theta)
            q_pos1 = positions
        if kv_cache is not None:
            new_cache = _cache_write(kv_cache, k, v, q_pos1, cache_index)
            k = new_cache["k"].to(x.dtype)
            v = new_cache["v"].to(x.dtype)
            cpos = new_cache["pos"]
            bias = _mask_bias(q_pos1, cpos, spec.causal, spec.sliding_window,
                              cpos >= 0)
        else:
            k_pos = kv_positions if kv_positions is not None else q_pos1
            bias = _mask_bias(q_pos1, k_pos, spec.causal,
                              spec.sliding_window)
    else:
        q_pos1 = positions if positions.dim() == 2 else positions[..., 0]
        k_pos = torch.arange(src.shape[1], device=x.device)[None, :].expand(
            B, src.shape[1])
        bias = _mask_bias(q_pos1, k_pos, False, None)

    # grouped heads: fold group dim into q
    groups = hq // hkv
    qg = q.reshape(B, L, hkv, groups, h)
    scores = torch.einsum("blkgh,bmkh->bklgm", qg, k).float()
    scores = scores / float(np.sqrt(np.float32(h)))
    scores = scores + bias[:, 0][:, None, :, None, :]   # (B,hkv,L,g,M)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bklgm,bmkh->blkgh", probs, v)
    out = out.reshape(B, L, hq * h)
    return out @ p["wo"].to(x.dtype), new_cache


def _cache_write(kv_cache: Params, k, v, q_pos1, cache_index) -> Params:
    """Write L new entries at slot ``cache_index`` of a (B, C, ...) cache.

    ``jax.lax.dynamic_update_slice_in_dim`` clamps its start into
    ``[0, C - L]``, so a write past the end of a full cache lands on its
    last slots; the same clamp here.  K and V are cast to the cache's
    dtype, the positions to int32.
    """
    ck, cv, cpos = kv_cache["k"], kv_cache["v"], kv_cache["pos"]
    L, C = k.shape[1], ck.shape[1]
    i = min(max(int(cache_index), 0), C - L)
    ck[:, i:i + L] = k.to(ck.dtype)
    cv[:, i:i + L] = v.to(cv.dtype)
    cpos[:, i:i + L] = q_pos1.to(cpos.dtype)
    return {"k": ck, "v": cv, "pos": cpos}


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_swiglu(key, d: int, d_ff: int) -> Params:
    k1, k2, k3 = rng.split(key, 3).unbind(-2)
    return {"w_gate": _dense_init(k1, d, d_ff),
            "w_up": _dense_init(k2, d, d_ff),
            "w_down": _dense_init(k3, d_ff, d)}


def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(x @ p["w_gate"].to(x.dtype))
    u = x @ p["w_up"].to(x.dtype)
    return (g * u) @ p["w_down"].to(x.dtype)


def init_gelu_mlp(key, d: int, d_ff: int) -> Params:
    k1, k2 = rng.split(key, 2).unbind(-2)
    lead, dev = _lead(key), key.device
    return {"w_in": _dense_init(k1, d, d_ff),
            "b_in": torch.zeros(lead + (d_ff,), dtype=torch.float32,
                                device=dev),
            "w_out": _dense_init(k2, d_ff, d),
            "b_out": torch.zeros(lead + (d,), dtype=torch.float32,
                                 device=dev)}


def gelu_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default is the tanh approximation."""
    h = F.gelu(x @ p["w_in"].to(x.dtype) + p["b_in"].to(x.dtype),
               approximate="tanh")
    return h @ p["w_out"].to(x.dtype) + p["b_out"].to(x.dtype)
