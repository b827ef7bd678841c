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

``SSMConfig.published`` selects the published Mamba2 mixer instead, as
``GraniteMoeHybridMambaLayer.torch_forward`` (transformers) computes it:
one input projection to ``[z, xBC, dt]``; the causal depthwise conv with
bias and SiLU over the concatenation of x, B and C (``conv_dim = d_in + 2
n_groups d_state`` channels); B and C in ``n_groups`` groups, head ``h``
reading group ``h // (H / n_groups)``; ``dt = softplus(dt + dt_bias)``
(the time-step limit (0, inf) clamps nothing); the SSD over chunks of
``chunk`` steps, the last zero-padded, with the intra-chunk decay from
segment sums; the D skip; ``rms_norm(y * silu(z))`` over ``d_in`` in
float32; and ``out_proj``.  It has no decode state here.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import rng, tracing
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
    if cfg.published:
        return _init_published(key, d_model, cfg)
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
                   state: Optional[Params] = None, eps: float = 1e-5
                   ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x: (B, L, D). state (decode): {"ssm": (B,H,hd,N), "conv": (B,W-1,d_in)}.
    ``eps``: the published mixer's gated RMSNorm.

    Training/prefill: state is None -> chunked scan from the zero state.
    Decode: L == 1 is the one-step recurrence; returns the updated state.
    """
    if cfg.published:
        if state is not None:
            raise NotImplementedError("the published Mamba2 mixer has no "
                                      "decode state in the port")
        return _published_forward(p, x, d_model, cfg, eps), None
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


# ---------------------------------------------------------------------------
# the published Mamba2 mixer
# ---------------------------------------------------------------------------


def published_sizes(d_model: int, cfg: SSMConfig) -> Tuple[int, int, int]:
    """``(d_in, heads, conv_dim)`` of the published mixer."""
    d_in = cfg.expand * d_model
    return d_in, d_in // cfg.head_dim, d_in + 2 * cfg.n_groups * cfg.d_state


def _init_published(key, d_model: int, cfg: SSMConfig) -> Params:
    """The published mixer's params.  Random weights as the port draws
    them: the projections truncated normal over ``sqrt(fan_in)``, the conv
    taps ``normal / sqrt(conv_width)``, its bias 0; ``a_log = log(1..H)``,
    ``dt_bias = 1`` and ``D = 1`` as transformers initialises them."""
    d_in, H, conv_dim = published_sizes(d_model, cfg)
    ks = rng.split(key, 3).unbind(-2)
    lead, dev = tuple(key.shape[:-1]), key.device

    def const(v, n):
        return torch.full(lead + (n,), v, dtype=torch.float32, device=dev)

    if dev.type == "meta":
        a_log = torch.empty(lead + (H,), dtype=torch.float32, device=dev)
    else:
        a_log = torch.log(torch.arange(1, H + 1, dtype=torch.float32)).to(
            dev).expand(lead + (H,)).clone()
    return {
        "w_in": _dense_init(ks[0], d_model, d_in + conv_dim + H),
        "conv_w": rng.normal(ks[1], (cfg.conv_width, conv_dim))
        * float(np.float32(1.0) / np.sqrt(np.float32(cfg.conv_width))),
        "conv_b": const(0.0, conv_dim),
        "a_log": a_log,
        "dt_bias": const(1.0, H),
        "d_skip": const(1.0, H),
        "out_norm": init_rmsnorm(d_in, lead, dev),
        "w_out": _dense_init(ks[2], d_in, d_model),
    }


def _conv_published(xbc: torch.Tensor, conv_w: torch.Tensor,
                    conv_b: torch.Tensor) -> torch.Tensor:
    """The causal depthwise conv with bias, summed in float32 and rounded
    once to the activations' dtype (as a float32-accumulating conv), then
    SiLU."""
    W, L = conv_w.shape[0], xbc.shape[1]
    xp = F.pad(xbc, (0, 0, W - 1, 0)).float()
    out = conv_b
    for i in range(W):
        out = out + xp[:, i:i + L] * conv_w[i]
    return F.silu(out.to(xbc.dtype))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """``(..., Q) -> (..., Q, Q)``: entry ``[i, j]`` is ``a[j+1] + ... +
    a[i]`` for ``j <= i`` (each a sum of its own, not a difference of two
    cumulative sums), ``-inf`` above the diagonal."""
    Q = a.shape[-1]
    x = a[..., None].expand(*a.shape, Q)
    below = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=a.device),
                       diagonal=-1)
    x = torch.cumsum(x.masked_fill(~below, 0.0), dim=-2)
    keep = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=a.device))
    return x.masked_fill(~keep, -torch.inf)


def ssd_published(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor,
                  chunk: int) -> torch.Tensor:
    """The chunked SSD from the zero state, in float32.

    ``x (B, L, H, P)``, ``dt (B, L, H)``, ``a (H,)`` (negative), ``b``,
    ``c (B, L, G, N)``; returns ``y (B, L, H, P)`` of ``h_t = exp(dt_t a)
    h_{t-1} + dt_t x_t b_t^T``, ``y_t = c_t h_t`` (without the D skip).
    Heads are grouped ``(G, H / G)``.  L is zero-padded to whole chunks
    (``dt = 0`` there: no decay, no input)."""
    Bsz, L, H, P = x.shape
    G, N = b.shape[-2:]
    R = H // G
    pad = (-L) % chunk
    nC = (L + pad) // chunk
    tracing.count("ssd.chunks", nC)

    def chunks(t):
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape((Bsz, nC, chunk) + t.shape[2:])

    xc = chunks(x * dt[..., None]).reshape(Bsz, nC, chunk, G, R, P)
    bc, cc = chunks(b), chunks(c)                           # (B,nC,Q,G,N)
    adt = chunks(dt * a).permute(0, 3, 1, 2)                # (B,H,nC,Q)
    acum = torch.cumsum(adt, dim=-1)
    # 1. within each chunk: y_l = sum_{s<=l} (c_l . b_s) exp(a_{s+1..l}) x_s
    decay = torch.exp(_segsum(adt)).reshape(Bsz, G, R, nC, chunk, chunk)
    cb = torch.einsum("bclgn,bcsgn->bcgls", cc, bc)
    m = cb[:, :, :, None] * decay.permute(0, 3, 1, 2, 4, 5)  # (B,nC,G,R,Q,Q)
    y = torch.einsum("bcgrls,bcsgrp->bclgrp", m, xc)
    # 2. each chunk's own state at its end
    tail = torch.exp(acum[..., -1:] - acum).reshape(Bsz, G, R, nC, chunk)
    states = torch.einsum("bcsgn,bgrcs,bcsgrp->bcgrpn", bc, tail, xc)
    # 3. the states carried across chunks
    edge = torch.exp(acum[..., -1]).reshape(Bsz, G, R, nC)
    h = states.new_zeros(states[:, 0].shape)               # (B,G,R,P,N)
    prev = []
    for i in range(nC):
        prev.append(h)
        h = edge[..., i, None, None] * h + states[:, i]
    prev = torch.stack(prev, dim=1)                         # (B,nC,G,R,P,N)
    # 4. the carried state's output, decayed from the chunk's start
    into = torch.exp(acum).reshape(Bsz, G, R, nC, chunk)
    y = y + torch.einsum("bclgn,bcgrpn,bgrcl->bclgrp", cc, prev, into)
    return y.reshape(Bsz, nC * chunk, H, P)[:, :L]


def _published_forward(p: Params, x: torch.Tensor, d_model: int,
                       cfg: SSMConfig, eps: float) -> torch.Tensor:
    Bsz, L, _ = x.shape
    d_in, H, conv_dim = published_sizes(d_model, cfg)
    G, N, P = cfg.n_groups, cfg.d_state, cfg.head_dim
    z, xbc, dt = (x @ p["w_in"].to(x.dtype)).split([d_in, conv_dim, H], -1)
    xbc = _conv_published(xbc, p["conv_w"], p["conv_b"])
    xs, b, c = xbc.split([d_in, G * N, G * N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])             # (B, L, H)
    a = -torch.exp(p["a_log"].float())
    xh = xs.reshape(Bsz, L, H, P).float()
    y = ssd_published(xh, dt, a, b.reshape(Bsz, L, G, N).float(),
                      c.reshape(Bsz, L, G, N).float(), cfg.chunk)
    y = y + p["d_skip"][:, None] * xh
    # the gated RMSNorm, in float32 as published
    g = y.reshape(Bsz, L, d_in) * F.silu(z.float())
    var = torch.mean(g * g, dim=-1, keepdim=True)
    g = p["out_norm"]["w"] * (g * torch.rsqrt(var + eps))
    return g.to(x.dtype) @ p["w_out"].to(x.dtype)


def init_mamba2_state(cfg: SSMConfig, d_model: int, batch: int,
                      dtype=torch.float32, device=None) -> Params:
    d_in = cfg.expand * d_model
    H = d_in // cfg.head_dim
    return {"ssm": torch.zeros((batch, H, cfg.head_dim, cfg.d_state),
                               dtype=dtype, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, d_in),
                                dtype=dtype, device=device)}
