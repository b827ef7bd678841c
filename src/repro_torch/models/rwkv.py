"""RWKV-6 (Finch) block: time-mix with data-dependent decay, and channel-mix.

The port of the reference's ``repro/models/rwkv.py`` (arXiv:2404.05892):
per-channel token-shift interpolation, the LoRA-parameterised decay
``w_t = exp(-exp(w0 + lora(x)))``, the bonus u and a matrix-valued WKV
state ``S`` of ``(hd, hd)`` per head:

    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

The reference's two-level ``lax.scan`` (chunks of steps, each chunk under
``jax.checkpoint``) is a loop over chunks of a loop over steps, each chunk
under ``torch.utils.checkpoint``: backward keeps the state at chunk
boundaries only and recomputes a chunk's per-step states.  Decode is the
same recurrence from a carried state.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import rng
from repro_torch.configs.base import RWKVConfig
from repro_torch.models.layers import _dense_init, init_layernorm, layer_norm

Params = Dict[str, torch.Tensor]


def init_rwkv6_time(key, d: int, cfg: RWKVConfig) -> Params:
    """A key ``(2,)`` or a stack of keys ``(n, 2)`` (the stacked layers)."""
    ks = rng.split(key, 8).unbind(-2)
    hd = cfg.head_dim
    H = d // hd
    lead, dev = tuple(key.shape[:-1]), key.device
    return {
        "mu": rng.uniform(ks[0], (5, d)),                    # r,k,v,g,w
        "w0": torch.full(lead + (d,), -6.0, device=dev),
        "w_lora_a": _dense_init(ks[1], d, cfg.decay_lora, scale=0.01),
        "w_lora_b": _dense_init(ks[2], cfg.decay_lora, d, scale=0.01),
        "u": torch.zeros(lead + (H, hd), device=dev),
        "wr": _dense_init(ks[3], d, d),
        "wk": _dense_init(ks[4], d, d),
        "wv": _dense_init(ks[5], d, d),
        "wg": _dense_init(ks[6], d, d),
        "wo": _dense_init(ks[7], d, d),
        "ln_x": init_layernorm(d, lead, dev),
    }


def init_rwkv6_channel(key, d: int, d_ff: int) -> Params:
    k1, k2, k3 = rng.split(key, 3).unbind(-2)
    return {
        "mu": rng.uniform(k1, (2, d)),                       # k, r
        "wk": _dense_init(k2, d, d_ff),
        "wv": _dense_init(k3, d_ff, d),
        "wr": _dense_init(rng.fold_in(k1, 7), d, d),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]):
    """xx_t = x_{t-1}; prev: (B, 1, D) carried last token (decode) or None."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    xx = torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)
    return xx, x[:, -1:]


def _wkv_steps(S, u, r, k, v, w):
    """The recurrence over one chunk's steps; r, k, v, w: (Q, B, H, hd).
    Returns the final state and the outputs (Q, B, H, hd)."""
    ys = []
    for t in range(r.shape[0]):
        kv = k[t][..., :, None] * v[t][..., None, :]         # (B,H,hd,hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[t],
                               S + u[None, :, :, None] * kv))
        S = w[t][..., :, None] * S + kv
    return S, torch.stack(ys)


def _chunk_len(L: int, chunk: int) -> int:
    q = min(chunk, L)
    while L % q:
        q -= 1
    return q


def rwkv6_time_mix(p: Params, x: torch.Tensor, cfg: RWKVConfig,
                   state: Optional[Params] = None
                   ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x: (B, L, D). state: {"shift": (B,1,D), "wkv": (B,H,hd,hd)}."""
    B, L, D = x.shape
    hd = cfg.head_dim
    H = D // hd
    xx, last = _token_shift(x, state["shift"] if state else None)
    mu = p["mu"].to(x.dtype)
    zr = x + (xx - x) * mu[0]
    zk = x + (xx - x) * mu[1]
    zv = x + (xx - x) * mu[2]
    zg = x + (xx - x) * mu[3]
    zw = x + (xx - x) * mu[4]
    r = (zr @ p["wr"].to(x.dtype)).reshape(B, L, H, hd)
    k = (zk @ p["wk"].to(x.dtype)).reshape(B, L, H, hd)
    v = (zv @ p["wv"].to(x.dtype)).reshape(B, L, H, hd)
    g = F.silu(zg @ p["wg"].to(x.dtype))
    lora = (torch.tanh(zw @ p["w_lora_a"].to(x.dtype))
            @ p["w_lora_b"].to(x.dtype))
    w = torch.exp(-torch.exp(p["w0"] + lora.float()))      # (B,L,D)

    def steps_first(a):                                     # -> (L,B,H,hd)
        return a.reshape(B, L, H, hd).float().transpose(0, 1)

    rf, kf, vf, wf = map(steps_first, (r, k, v, w))
    S = (state["wkv"].float() if state
         else x.new_zeros((B, H, hd, hd), dtype=torch.float32))
    # chunks of steps: the state is kept at chunk boundaries and a chunk's
    # steps are recomputed on backward
    Q = _chunk_len(L, cfg.chunk)
    ys = []
    for c in range(0, L, Q):
        S, y = checkpoint(_wkv_steps, S, p["u"], rf[c:c + Q], kf[c:c + Q],
                          vf[c:c + Q], wf[c:c + Q], use_reentrant=False)
        ys.append(y)
    y = torch.cat(ys).transpose(0, 1).reshape(B, L, D)
    y = layer_norm(y.to(x.dtype), p["ln_x"])
    out = (y * g) @ p["wo"].to(x.dtype)
    new_state = None
    if state is not None:
        new_state = {"shift": last, "wkv": S.to(state["wkv"].dtype)}
    return out, new_state


def rwkv6_channel_mix(p: Params, x: torch.Tensor,
                      state: Optional[Params] = None):
    xx, last = _token_shift(x, state["shift"] if state else None)
    mu = p["mu"].to(x.dtype)
    zk = x + (xx - x) * mu[0]
    zr = x + (xx - x) * mu[1]
    k = torch.square(F.relu(zk @ p["wk"].to(x.dtype)))
    out = torch.sigmoid(zr @ p["wr"].to(x.dtype)) * (k @ p["wv"].to(x.dtype))
    new_state = {"shift": last} if state is not None else None
    return out, new_state


def init_rwkv6_state(cfg: RWKVConfig, d: int, batch: int,
                     dtype=torch.float32, device=None) -> Params:
    hd = cfg.head_dim
    H = d // hd
    return {
        "time": {"shift": torch.zeros((batch, 1, d), dtype=dtype,
                                      device=device),
                 "wkv": torch.zeros((batch, H, hd, hd), dtype=dtype,
                                    device=device)},
        "channel": {"shift": torch.zeros((batch, 1, d), dtype=dtype,
                                         device=device)},
    }
