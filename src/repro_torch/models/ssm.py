"""Mamba2 (SSD) mixer block: the chunked scan for train/prefill, the one-step
recurrence for decode.

The port of the reference's ``repro/models/ssm.py`` (the minimal SSD of
Dao & Gu 2024): per-head scalar decay ``a_t = exp(dt_t * A_head)``, shared
(n_groups = 1) B/C of size d_state, a depthwise causal conv on the SSM
input and a gated, normed output.  The chunked algorithm computes each
chunk's own contribution with a lower-triangular decay-weighted
"attention" and carries the ``(H, hd, N)`` state across chunks; the
reference's ``lax.scan`` over chunks is a loop here.

Three places follow the reference's bits rather than torch's defaults:

* ``a_log = log(linspace(1, 16, H))``: ``jnp.linspace``'s float32 formula
  as XLA's CPU backend compiles it (:func:`_linspace_1_16`) and XLA's
  float32 ``log`` (:func:`repro_torch.rng.log_f32`), so the init is the
  reference's bit for bit;
* ``jax.nn.softplus`` is ``logaddexp(x, 0)`` for every x, where
  ``F.softplus`` switches to x above 20 (:func:`softplus`);
* the intra-chunk decay is masked before its ``exp``: an unmasked entry
  (t < s) can overflow, and its gradient through the mask is inf * 0.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import rng
from repro_torch.configs.base import SSMConfig
from repro_torch.models.layers import _dense_init, init_rmsnorm, rms_norm

Params = Dict[str, torch.Tensor]


def _linspace_1_16(n: int) -> torch.Tensor:
    """float32 ``jnp.linspace(1.0, 16.0, n)`` on the CPU, bit for bit for
    n <= 352 (every config: 8 heads reduced, 112 for zamba2-7b).

    jax computes ``start * (1 - s) + stop * s`` for ``s = iota / (n - 1)``;
    XLA turns the division into the product with ``f32(1 / (n - 1))``,
    folds ``stop`` into that constant and fuses the last product into the
    add.  Above 352 its vectorised loop contracts otherwise and a few
    entries move by an ulp (ROADMAP §3).
    """
    if n == 1:
        return torch.ones(1)
    it = torch.arange(n - 1, dtype=torch.float32)
    r = np.float32(1.0) / np.float32(n - 1)
    head = rng.fma_f32(it, float(np.float32(16.0) * r), 1.0 - it * float(r))
    return torch.cat([head, torch.full((1,), 16.0)])


def a_log_init(n_heads: int, device=None) -> torch.Tensor:
    """``log(linspace(1, 16, H))`` with XLA's float32 ``log``; made on the
    CPU and moved, so every device holds the reference's bits."""
    if torch.device(device or "cpu").type == "meta":
        return torch.empty((n_heads,), dtype=torch.float32, device="meta")
    return rng.log_f32(_linspace_1_16(n_heads)).to(device)


def init_mamba2(key, d_model: int, cfg: SSMConfig) -> Params:
    """A key ``(2,)`` or a stack of keys ``(n, 2)`` (the stacked layers)."""
    d_in = cfg.expand * d_model
    n_heads = d_in // cfg.head_dim
    ks = rng.split(key, 8).unbind(-2)
    lead, dev = tuple(key.shape[:-1]), key.device

    def const(v, n):
        return torch.full(lead + (n,), v, dtype=torch.float32, device=dev)

    return {
        "w_z": _dense_init(ks[0], d_model, d_in),
        "w_x": _dense_init(ks[1], d_model, d_in),
        "w_b": _dense_init(ks[3], d_model, cfg.d_state),
        "w_c": _dense_init(ks[4], d_model, cfg.d_state),
        "w_dt": _dense_init(ks[5], d_model, n_heads),
        "conv_w": rng.normal(ks[2], (cfg.conv_width, d_in))
        * float(np.float32(0.1)),
        "conv_b": const(0.0, d_in),
        "a_log": a_log_init(n_heads, dev).expand(lead + (n_heads,)).clone(),
        "dt_bias": const(0.0, n_heads),
        "d_skip": const(1.0, n_heads),
        "out_norm": init_rmsnorm(d_in, lead, dev),
        "w_out": _dense_init(ks[6], d_in, d_model),
    }


def _split_proj(p, x):
    z = x @ p["w_z"].to(x.dtype)
    xs = x @ p["w_x"].to(x.dtype)
    b = x @ p["w_b"].to(x.dtype)
    c = x @ p["w_c"].to(x.dtype)
    dt = x @ p["w_dt"].to(x.dtype)
    return z, xs, b, c, dt


def _causal_conv(xs, conv_w, conv_b, state=None):
    """Depthwise causal conv. xs: (B, L, d_in); state: (B, W-1, d_in).
    The taps are summed left to right, as the reference's python ``sum``."""
    W, L = conv_w.shape[0], xs.shape[1]
    if state is None:
        pad = xs.new_zeros(xs.shape[:1] + (W - 1,) + xs.shape[2:])
    else:
        pad = state.to(xs.dtype)
    xp = torch.cat([pad, xs], dim=1)                   # (B, L+W-1, d_in)
    out = 0
    for i in range(W):
        out = out + xp[:, i:i + L] * conv_w[i].to(xs.dtype)
    new_state = xp[:, xp.shape[1] - (W - 1):] if W > 1 else pad[:, :0]
    return F.silu(out + conv_b.to(xs.dtype)), new_state


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``
    everywhere (``F.softplus`` returns x above its threshold)."""
    return (torch.maximum(x, x.new_zeros(()))
            + torch.log1p(torch.exp(-x.abs())))


#: XLA's CPU backend rewrites a cumulative sum longer than this into blocks
_CUMSUM_BLOCK = 16


def cumsum_xla(x: torch.Tensor, dim: int) -> torch.Tensor:
    """float32 ``jnp.cumsum`` along ``dim`` in XLA's CPU order, bit for bit.

    Up to 16 entries it is the sequential float32 sum; longer, each block
    of 16 is summed sequentially and the exclusive prefix of the blocks'
    totals (itself summed so) is added to each of its entries.
    ``torch.cumsum`` accumulates in float64 on the CPU and in another order
    on the card; in the SSD the chunk's log-decays reach a few hundred, so
    one ulp of the sum is a relative error of ~1e-5 in a decay.
    """
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= _CUMSUM_BLOCK:
        acc, out = x[..., 0], [x[..., 0]]
        for i in range(1, n):
            acc = acc + x[..., i]
            out.append(acc)
        return torch.stack(out, -1).movedim(-1, dim)
    nb = -(-n // _CUMSUM_BLOCK)
    xp = F.pad(x, (0, nb * _CUMSUM_BLOCK - n))
    loc = cumsum_xla(xp.reshape(x.shape[:-1] + (nb, _CUMSUM_BLOCK)), -1)
    pre = cumsum_xla(loc[..., -1], -1)
    excl = F.pad(pre[..., :-1], (1, 0))
    out = (excl[..., None] + loc).reshape(x.shape[:-1] + (nb * _CUMSUM_BLOCK,))
    return out[..., :n].movedim(-1, dim)


def _chunk_len(L: int, chunk: int) -> int:
    q = min(chunk, L)
    while L % q:
        q -= 1
    return q


def _ssd_chunked(dt, decay, xh, bf, cf, chunk, h0):
    """The chunked SSD over ``(B, L, ...)`` float32 inputs from state
    ``h0 (B, H, hd, N)``: ``(y (B, L, H, hd), h_final)``."""
    B, L, H, hd = xh.shape
    N = bf.shape[-1]
    Q = _chunk_len(L, chunk)
    nC = L // Q
    dtc = dt.reshape(B, nC, Q, H)
    dec = decay.reshape(B, nC, Q, H)
    xc = xh.reshape(B, nC, Q, H, hd)
    bc = bf.reshape(B, nC, Q, N)
    cc = cf.reshape(B, nC, Q, N)
    logdec = torch.log(torch.clamp(dec, min=1e-20))
    cum = cumsum_xla(logdec, dim=2)                         # (B,nC,Q,H)
    # intra-chunk: y_t = sum_{s<=t} C_t.B_s dt_s x_s * exp(cum_t - cum_s)
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,nC,Q,Q,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    # mask BEFORE exp (see the module's docstring)
    gate = torch.exp(torch.where(tri[None, None, :, :, None], rel, -1e30))
    cb = torch.einsum("bcqn,bcsn->bcqs", cc, bc)            # (B,nC,Q,Q)
    w = cb[..., None] * gate * dtc[:, :, None, :, :]        # (B,nC,Q,Q,H)
    y_intra = torch.einsum("bcqsh,bcshd->bcqhd", w, xc)
    # inter-chunk: h' = (prod decay) h + sum_s exp(cum_Q - cum_s) dt_s x_s B_s
    tail = cum[:, :, -1:, :] - cum                          # (B,nC,Q,H)
    wx = torch.exp(tail)[..., None] * (dtc[..., None] * xc)
    dS = torch.einsum("bcqhd,bcqn->bchdn", wx, bc)          # (B,nC,H,hd,N)
    chunk_decay = torch.exp(cum[:, :, -1, :])               # (B,nC,H)
    h, h_prev = h0, []
    for c in range(nC):
        h_prev.append(h)
        h = chunk_decay[:, c, :, None, None] * h + dS[:, c]
    h_prev = torch.stack(h_prev, dim=1)                     # (B,nC,H,hd,N)
    yin = torch.einsum("bcqn,bchdn->bcqhd", cc, h_prev)
    # the carried state decays by exp(cum_t) (chunk start -> t, per head)
    yin = yin * torch.exp(cum)[..., None]
    return (y_intra + yin).reshape(B, L, H, hd), h


def mamba2_forward(p: Params, x: torch.Tensor, d_model: int, cfg: SSMConfig,
                   state: Optional[Params] = None
                   ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x: (B, L, D). state (decode): {"ssm": (B,H,hd,N), "conv": (B,W-1,d_in)}.

    Training/prefill: state is None -> chunked scan from the zero state.
    Decode: L == 1 is the one-step recurrence; returns the updated state.
    """
    B, L, _ = x.shape
    d_in = cfg.expand * d_model
    hd, N = cfg.head_dim, cfg.d_state
    H = d_in // hd
    z, xs, b, c, dt = _split_proj(p, x)
    conv_state = state["conv"] if state is not None else None
    xs, new_conv = _causal_conv(xs, p["conv_w"], p["conv_b"], conv_state)
    dt = softplus(dt.float() + p["dt_bias"])               # (B, L, H)
    a = -torch.exp(p["a_log"])                             # (H,) negative
    decay = torch.exp(dt * a)                              # (B, L, H) in (0,1)
    xh = xs.reshape(B, L, H, hd).float()
    bf, cf = b.float(), c.float()                          # (B, L, N)

    if state is not None and L == 1:
        # single step: h' = decay * h + dt * x outer B ; y = C . h'
        h0 = state["ssm"].float()
        dtx = dt[:, 0, :, None] * xh[:, 0]                 # (B,H,hd)
        h1 = (decay[:, 0, :, None, None] * h0
              + dtx[..., None] * bf[:, 0, None, None, :])
        y = torch.einsum("bhdn,bn->bhd", h1, cf[:, 0])[:, None]
        y = y + p["d_skip"][None, None, :, None] * xh
        new_state = {"ssm": h1.to(state["ssm"].dtype), "conv": new_conv}
    else:
        h0 = (state["ssm"].float() if state is not None
              else xh.new_zeros((B, H, hd, N)))
        y, h_fin = _ssd_chunked(dt, decay, xh, bf, cf, cfg.chunk, h0)
        y = y + p["d_skip"][None, None, :, None] * xh
        new_state = None
        if state is not None:
            new_state = {"ssm": h_fin.to(state["ssm"].dtype),
                         "conv": new_conv}

    y = y * F.silu(z.reshape(B, L, H, hd).float())
    y = rms_norm(y.reshape(B, L, d_in).to(x.dtype), p["out_norm"])
    return y @ p["w_out"].to(x.dtype), new_state


def init_mamba2_state(cfg: SSMConfig, d_model: int, batch: int,
                      dtype=torch.float32, device=None) -> Params:
    d_in = cfg.expand * d_model
    H = d_in // cfg.head_dim
    return {"ssm": torch.zeros((batch, H, cfg.head_dim, cfg.d_state),
                               dtype=dtype, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, d_in),
                                dtype=dtype, device=device)}
