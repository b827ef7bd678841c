"""Plain reference of granite-4.0-h's hybrid decoder: Mamba2 mixers and
NoPE grouped-query attention, each followed by a SwiGLU MLP in the same
residual block, with Granite's multipliers and a tied head.

Written from the published layer equations (transformers'
``modeling_granitemoehybrid.py``: ``GraniteMoeHybridDecoderLayer``, the
Mamba layer, ``GraniteMoeHybridRMSNormGated``, the shared MLP and the
model's multipliers):

* embeddings times ``embedding_multiplier``;
* each block ``x + r * mixer(rms_norm(x))``, then ``x + r * mlp(rms_norm(x))``
  with ``r = residual_multiplier``; the mixer by ``layer_types``;
* attention: causal GQA without a position embedding, the scores times
  ``attention_multiplier``;
* the Mamba2 mixer: one input projection to ``[z, xBC, dt]``; the causal
  depthwise conv (with bias) and SiLU over ``xBC``; B and C in
  ``mamba_n_groups`` groups, head ``h`` reading group ``h // (H / G)``;
  ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the SSD, whose
  definition is the recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t
  B_t^T`` and ``y_t = C_t h_t + D x_t``; ``rms_norm(y * silu(z))`` in
  float32, then ``out_proj``;
* logits divided by ``logits_scaling``, next-token cross-entropy.

The casts follow the configuration's precision as
:mod:`fedbench.reference.transformer` does: float32 parameters,
activations in the compute dtype, the norms, the conv's sum, the SSD, the
attention scores, the softmax and the logits in float32.

The SSD has two forms here.  ``ssd_scan`` runs the recurrence one step
at a time.  ``ssd_chunked``, the one the mixer runs by default
(``Arch.ssd``), unrolls the same recurrence inside chunks of
``mamba_chunk_size`` steps (the state-space dual: each chunk's outputs
from its own inputs through the decays between their steps, each
chunk's state at its end, the states carried from chunk to chunk by the
recurrence), with the sums taken in the program's chunk and order, so
that the program's float32 SSD is the reference's bit for bit and the
check is left to see everything else.  The two forms part by float32
rounding alone (``tests/test_torch_granite_hybrid.py`` holds them to
each other).  Each Mamba layer's SSD is recomputed in the backward pass
(``torch.utils.checkpoint``), because a whole layer's intermediates would
not fit beside the round's other memory at 1024 tokens; the
recomputation changes no value.

Weights are drawn from the seed with :mod:`fedbench.reference.rng` in the
order the program draws them: the layers' keys split from the blocks' key
one a layer, each kind's layers stacked apart (``blocks[kind]``).  This
file is the benchmark's copy; ``tests/torch_granite_hybrid_ref.py`` holds
the same text for the CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from fedbench.reference import rng
from fedbench.reference.transformer import (
    _dense, _layers, leaves, rms_norm, swiglu, tree_map,
)

Params = Dict[str, object]
ATTN, MAMBA = "attn", "mamba2_mlp"


@dataclasses.dataclass(frozen=True)
class Arch:
    """The sizes a configuration file gives, in the reference's names."""
    n_layers: int
    layer_types: Tuple[str, ...]      # "mamba" | "attention" per layer
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    norm_eps: float
    ssm_heads: int
    ssm_head_dim: int
    d_state: int
    n_groups: int
    conv_width: int
    expand: int
    embedding_multiplier: float = 1.0
    attention_multiplier: float = 0.125
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    chunk: int = 256                  # the SSD's chunk, in steps
    ssd: str = "chunked"              # "chunked" | "scan"

    @classmethod
    def from_config(cls, cfg: dict) -> "Arch":
        """From a configuration file's published keys (Hugging Face
        ``config.json`` names)."""
        heads = cfg["num_attention_heads"]
        if cfg.get("position_embedding_type", "nope") != "nope":
            raise ValueError("the reference runs NoPE attention only")
        return cls(n_layers=cfg["num_hidden_layers"],
                   layer_types=tuple(cfg["layer_types"]),
                   d_model=cfg["hidden_size"], n_heads=heads,
                   n_kv_heads=cfg["num_key_value_heads"],
                   head_dim=cfg["hidden_size"] // heads,
                   d_ff=cfg["shared_intermediate_size"],
                   vocab=cfg["vocab_size"], norm_eps=cfg["rms_norm_eps"],
                   ssm_heads=cfg["mamba_n_heads"],
                   ssm_head_dim=cfg["mamba_d_head"],
                   d_state=cfg["mamba_d_state"],
                   n_groups=cfg["mamba_n_groups"],
                   conv_width=cfg["mamba_d_conv"],
                   expand=cfg["mamba_expand"],
                   embedding_multiplier=float(cfg["embedding_multiplier"]),
                   attention_multiplier=float(cfg["attention_multiplier"]),
                   residual_multiplier=float(cfg["residual_multiplier"]),
                   logits_scaling=float(cfg["logits_scaling"]),
                   chunk=cfg["mamba_chunk_size"])

    @property
    def d_in(self) -> int:
        return self.expand * self.d_model

    @property
    def conv_dim(self) -> int:
        return self.d_in + 2 * self.n_groups * self.d_state

    def kinds(self) -> List[str]:
        return [ATTN if t == "attention" else MAMBA for t in self.layer_types]


# ---------------------------------------------------------------------------
# weights from the seed
# ---------------------------------------------------------------------------


def _ones(lead, n, device):
    return torch.ones(lead + (n,), device=device)


def _init_layers(arch: Arch, kind: str, keys: torch.Tensor,
                 device) -> Params:
    """The stacked params of one kind's layers from their keys ``(n, 2)``."""
    d, lead = arch.d_model, (keys.shape[0],)
    ks = rng.split(keys, 6).unbind(-2)
    kf = rng.split(ks[1], 3).unbind(-2)
    p = {"ln1": {"w": _ones(lead, d, device)},
         "ln2": {"w": _ones(lead, d, device)},
         "mlp": {"w_gate": _dense(kf[0], d, arch.d_ff),
                 "w_up": _dense(kf[1], d, arch.d_ff),
                 "w_down": _dense(kf[2], arch.d_ff, d)}}
    if kind == ATTN:
        h = arch.head_dim
        ka = rng.split(ks[0], 4).unbind(-2)
        p["attn"] = {"wq": _dense(ka[0], d, arch.n_heads * h),
                     "wk": _dense(ka[1], d, arch.n_kv_heads * h),
                     "wv": _dense(ka[2], d, arch.n_kv_heads * h),
                     "wo": _dense(ka[3], arch.n_heads * h, d)}
        return p
    H, W = arch.ssm_heads, arch.conv_width
    km = rng.split(ks[0], 3).unbind(-2)
    a_log = torch.log(torch.arange(1, H + 1, dtype=torch.float32))
    p["mamba"] = {
        "w_in": _dense(km[0], d, arch.d_in + arch.conv_dim + H),
        "conv_w": rng.normal(km[1], (W, arch.conv_dim))
        * float(np.float32(1.0) / np.sqrt(np.float32(W))),
        "conv_b": torch.zeros(lead + (arch.conv_dim,), device=device),
        "a_log": a_log.to(device).expand(lead + (H,)).clone(),
        "dt_bias": _ones(lead, H, device),
        "d_skip": _ones(lead, H, device),
        "out_norm": {"w": _ones(lead, arch.d_in, device)},
        "w_out": _dense(km[2], arch.d_in, d)}
    return p


def init_params(arch: Arch, seed: int, device) -> Params:
    """Weights drawn from ``seed``: the embedding, each kind's stacked
    layers and the final norm."""
    key = rng.PRNGKey(seed, device=device)
    k_embed, k_blocks = rng.split(key, 5).unbind(-2)[:2]
    lk = rng.split(k_blocks, arch.n_layers)
    kinds = arch.kinds()
    blocks = {}
    for kind in dict.fromkeys(kinds):
        idx = [i for i, k in enumerate(kinds) if k == kind]
        blocks[kind] = _init_layers(arch, kind, lk[idx], device)
    return {"embed": rng.normal(k_embed, (arch.vocab, arch.d_model))
            * float(np.float32(0.02)),
            "blocks": blocks,
            "final_norm": {"w": torch.ones((arch.d_model,), device=device)}}


# ---------------------------------------------------------------------------
# the forward pass
# ---------------------------------------------------------------------------


def attention(p: Params, arch: Arch, x: torch.Tensor) -> torch.Tensor:
    """Causal grouped-query attention with no position embedding:
    ``n_heads / n_kv_heads`` query heads share each key and value head, and
    the scores are scaled by ``attention_multiplier``."""
    B, L, _ = x.shape
    h, hq, hkv = arch.head_dim, arch.n_heads, arch.n_kv_heads
    q = (x @ p["wq"].to(x.dtype)).reshape(B, L, hq, h)
    k = (x @ p["wk"].to(x.dtype)).reshape(B, L, hkv, h)
    v = (x @ p["wv"].to(x.dtype)).reshape(B, L, hkv, h)
    pos = torch.arange(L, device=x.device)
    bias = torch.where(pos[:, None] >= pos[None, :], 0.0, -1e30).to(
        torch.float32)
    qg = q.reshape(B, L, hkv, hq // hkv, h)
    scores = torch.einsum("blkgh,bmkh->bklgm", qg, k).float()
    scores = scores * float(np.float32(arch.attention_multiplier))
    scores = scores + bias[None, None, :, None, :]
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bklgm,bmkh->blkgh", probs, v).reshape(B, L, hq * h)
    return out @ p["wo"].to(x.dtype)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The SSD by its recurrence from the zero state, in float32: ``x (B,
    L, H, P)``, ``dt (B, L, H)``, ``a (H,)``, ``b``, ``c (B, L, G, N)``
    (head ``h`` reads group ``h // (H / G)``); returns ``y (B, L, H, P)``
    without the D skip."""
    H, G = x.shape[2], b.shape[2]
    b = b.repeat_interleave(H // G, dim=2)
    c = c.repeat_interleave(H // G, dim=2)
    decay = torch.exp(dt * a)                                 # (B, L, H)
    u = dt[..., None] * x                                     # (B, L, H, P)
    h = x.new_zeros(x.shape[:1] + x.shape[2:] + b.shape[-1:])
    ys = []
    for t in range(x.shape[1]):
        h = (decay[:, t, :, None, None] * h
             + u[:, t, :, :, None] * b[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, c[:, t]))
    return torch.stack(ys, dim=1)


def segment_sums(a: torch.Tensor) -> torch.Tensor:
    """``(..., Q) -> (..., Q, Q)``: entry ``[l, s]`` is ``a[s+1] + ... +
    a[l]`` for ``s <= l`` (each a running sum of its own), ``-inf`` above
    the diagonal, where ``exp`` gives 0."""
    Q = a.shape[-1]
    x = a[..., None].expand(*a.shape, Q)
    below = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=a.device),
                       diagonal=-1)
    x = torch.cumsum(x.masked_fill(~below, 0.0), dim=-2)
    keep = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=a.device))
    return x.masked_fill(~keep, -torch.inf)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor,
                chunk: int) -> torch.Tensor:
    """The SSD's recurrence from the zero state unrolled in chunks of
    ``chunk`` steps, in float32; the arguments and result as
    :func:`ssd_scan`'s.  L is zero-padded to whole chunks (``dt = 0``
    there: no decay and no input).  With ``u_s = dt_s x_s`` and ``S_l`` the
    sum of ``dt_j a`` over a chunk's steps ``j <= l``:

    1. a chunk's own outputs: ``y_l = sum_{s <= l} (c_l . b_s)
       exp(S_l - S_s) u_s``, the exponent summed from ``s + 1`` to ``l``;
    2. its state at its end: ``sum_s exp(S_Q - S_s) u_s b_s^T``;
    3. the state entering chunk ``i + 1``: ``exp(S_Q) h_i`` plus chunk
       ``i``'s own, from ``h_0 = 0``: the recurrence, a chunk a step;
    4. each output adds ``exp(S_l) c_l . h_i``, the entering state decayed
       to its step.
    """
    Bsz, L, H, P = x.shape
    G, N = b.shape[-2:]
    R = H // G
    pad = (-L) % chunk
    nC = (L + pad) // chunk

    def chunks(t):
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape((Bsz, nC, chunk) + t.shape[2:])

    u = chunks(x * dt[..., None]).reshape(Bsz, nC, chunk, G, R, P)
    bc, cc = chunks(b), chunks(c)                           # (B,nC,Q,G,N)
    adt = chunks(dt * a).permute(0, 3, 1, 2)                # (B,H,nC,Q)
    s_cum = torch.cumsum(adt, dim=-1)
    # 1.
    decay = torch.exp(segment_sums(adt)).reshape(Bsz, G, R, nC, chunk,
                                                 chunk)
    cb = torch.einsum("bclgn,bcsgn->bcgls", cc, bc)
    w = cb[:, :, :, None] * decay.permute(0, 3, 1, 2, 4, 5)  # (B,nC,G,R,Q,Q)
    y = torch.einsum("bcgrls,bcsgrp->bclgrp", w, u)
    # 2.
    tail = torch.exp(s_cum[..., -1:] - s_cum).reshape(Bsz, G, R, nC, chunk)
    own = torch.einsum("bcsgn,bgrcs,bcsgrp->bcgrpn", bc, tail, u)
    # 3.
    whole = torch.exp(s_cum[..., -1]).reshape(Bsz, G, R, nC)
    h = own.new_zeros(own[:, 0].shape)                     # (B,G,R,P,N)
    entering = []
    for i in range(nC):
        entering.append(h)
        h = whole[..., i, None, None] * h + own[:, i]
    entering = torch.stack(entering, dim=1)                 # (B,nC,G,R,P,N)
    # 4.
    into = torch.exp(s_cum).reshape(Bsz, G, R, nC, chunk)
    y = y + torch.einsum("bclgn,bcgrpn,bgrcl->bclgrp", cc, entering, into)
    return y.reshape(Bsz, nC * chunk, H, P)[:, :L]


def mamba(p: Params, arch: Arch, x: torch.Tensor) -> torch.Tensor:
    """The Mamba2 mixer of ``x (B, L, D)``."""
    B, L, _ = x.shape
    H, P, G, N = arch.ssm_heads, arch.ssm_head_dim, arch.n_groups, \
        arch.d_state
    z, xbc, dt = (x @ p["w_in"].to(x.dtype)).split(
        [arch.d_in, arch.conv_dim, H], dim=-1)
    # the causal depthwise conv: taps over the last conv_width steps,
    # summed in float32 with the bias, rounded once, then SiLU
    W = arch.conv_width
    xp = F.pad(xbc, (0, 0, W - 1, 0)).float()
    conv = p["conv_b"]
    for i in range(W):
        conv = conv + xp[:, i:i + L] * p["conv_w"][i]
    xbc = F.silu(conv.to(x.dtype))
    xs, b, c = xbc.split([arch.d_in, G * N, G * N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"].float())
    xh = xs.reshape(B, L, H, P).float()
    b, c = b.reshape(B, L, G, N).float(), c.reshape(B, L, G, N).float()
    if arch.ssd == "scan":
        y = checkpoint(ssd_scan, xh, dt, a, b, c, use_reentrant=False)
    else:
        y = checkpoint(ssd_chunked, xh, dt, a, b, c, arch.chunk,
                       use_reentrant=False)
    y = y + p["d_skip"][:, None] * xh
    g = y.reshape(B, L, arch.d_in) * F.silu(z.float())
    var = torch.mean(g * g, dim=-1, keepdim=True)
    g = p["out_norm"]["w"] * (g * torch.rsqrt(var + arch.norm_eps))
    return g.to(x.dtype) @ p["w_out"].to(x.dtype)


def _branch(arch: Arch, h: torch.Tensor) -> torch.Tensor:
    r = arch.residual_multiplier
    return h if r == 1.0 else h * r


def hidden(params: Params, arch: Arch, tokens: torch.Tensor,
           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The final-normed hidden states of ``tokens (B, L)``."""
    x = params["embed"].to(compute_dtype)[tokens.long()]
    if arch.embedding_multiplier != 1.0:
        x = x * arch.embedding_multiplier
    kinds = arch.kinds()
    per = {k: iter(_layers(params["blocks"][k], kinds.count(k)))
           for k in dict.fromkeys(kinds)}
    for kind in kinds:
        lp = next(per[kind])
        h_in = rms_norm(x, lp["ln1"]["w"], arch.norm_eps)
        mixed = (attention(lp["attn"], arch, h_in) if kind == ATTN
                 else mamba(lp["mamba"], arch, h_in))
        x = x + _branch(arch, mixed)
        x = x + _branch(arch, swiglu(lp["mlp"], rms_norm(
            x, lp["ln2"]["w"], arch.norm_eps)))
    return rms_norm(x, params["final_norm"]["w"], arch.norm_eps)


def logits(params: Params, arch: Arch, tokens: torch.Tensor,
           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """float32 logits of every position but the last, over the scaling."""
    h = hidden(params, arch, tokens, compute_dtype)[:, :-1, :]
    out = (h @ params["embed"].T.to(h.dtype)).float()
    if arch.logits_scaling != 1.0:
        out = out / arch.logits_scaling
    return out


def loss(params: Params, arch: Arch, tokens: torch.Tensor,
         compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Next-token cross-entropy of ``tokens`` (B, L)."""
    lg = logits(params, arch, tokens, compute_dtype)
    nll = -torch.gather(torch.log_softmax(lg, dim=-1), -1,
                        tokens[:, 1:].long()[..., None])[..., 0]
    return torch.mean(nll)


def grads(params: Params, arch: Arch, tokens: torch.Tensor,
          out: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The loss of ``tokens`` and its gradient, written flat into ``out``
    (leaves in sorted-key order)."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    value = loss(p, arch, tokens, compute_dtype)
    g = torch.autograd.grad(value, leaves(p))
    torch.cat([t.reshape(-1).float() for t in g], out=out)
    return value.detach()
