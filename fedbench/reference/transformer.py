"""Plain reference of the decoder models the cells train: dense GQA
attention with a SwiGLU MLP, or with a top-k mixture of experts (GShard
dispatch with a capacity limit).

Written from the layer equations: RMSNorm, RoPE, grouped-query attention
with a causal mask, SwiGLU, the router's softmax, top-k and renormalised
weights, the Switch load-balance loss, and a tied embedding head.  The
casts follow the configuration's precision: float32 parameters,
activations in the compute dtype, norms, RoPE, the attention scores, the
softmaxes and the logits in float32.  The weights are drawn from the seed
with the RNG of :mod:`fedbench.reference.rng` in the order the program
draws them, so both sides start from the same weights without the
reference taking any tensor from the program.

Layer parameters are stacked ``(n_layers, ...)`` as the program stacks
them, so the flat gradient has the same layout; leaves are ordered by
sorted key at every level.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from fedbench.reference import rng

Params = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class Arch:
    """The sizes a configuration file gives, in the reference's names."""
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    num_experts: int = 0          # 0: dense SwiGLU blocks
    top_k: int = 0
    d_expert: int = 0
    aux_weight: float = 0.01
    capacity_factor: float = 1.25
    group_size: int = 256

    @classmethod
    def from_config(cls, cfg: dict) -> "Arch":
        """From a configuration file's published keys (Hugging Face
        ``config.json`` names)."""
        heads = cfg["num_attention_heads"]
        return cls(n_layers=cfg["num_hidden_layers"],
                   d_model=cfg["hidden_size"], n_heads=heads,
                   n_kv_heads=cfg["num_key_value_heads"],
                   head_dim=cfg.get("head_dim", cfg["hidden_size"] // heads),
                   d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
                   norm_eps=cfg["rms_norm_eps"],
                   rope_theta=float(cfg["rope_theta"]),
                   num_experts=cfg.get("num_local_experts", 0),
                   top_k=cfg.get("num_experts_per_tok", 0),
                   d_expert=(cfg["intermediate_size"]
                             if cfg.get("num_local_experts") else 0),
                   aux_weight=cfg.get("router_aux_loss_coef", 0.01))

    @property
    def moe(self) -> bool:
        return self.num_experts > 0


def leaves(tree) -> List[torch.Tensor]:
    """Leaves in sorted-key order at every level (the flat layout)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    return [tree]


def leaf_names(tree, prefix: str = "") -> List[str]:
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}.")]
    return [prefix[:-1]]


def unflatten(flat: torch.Tensor, template) -> Params:
    """Views of ``flat`` shaped like ``template``, in the flat layout."""
    off = 0

    def build(node):
        nonlocal off
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        n = node.numel()
        out = flat[off:off + n].view(node.shape)
        off += n
        return out
    return build(template)


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# weights from the seed
# ---------------------------------------------------------------------------


def _dense(key, n_in: int, n_out: int) -> torch.Tensor:
    """Truncated normal on (-2, 2) times ``f32(1 / sqrt(n_in))``."""
    scale = np.float32(1.0) / np.sqrt(np.float32(n_in))
    return (rng.truncated_normal(key, -2.0, 2.0, (n_in, n_out))
            * float(np.float32(scale)))


def init_params(arch: Arch, seed: int, device) -> Params:
    """Weights drawn from ``seed``: embedding, stacked layers, final norm.

    The key tree: the seed's key splits five ways (embedding, layers, head,
    shared block, encoder); the layers' key splits into one key a layer,
    each split six ways (attention, MLP, ...), drawn for all layers at
    once as a stack of keys."""
    key = rng.PRNGKey(seed, device=device)
    k_embed, k_blocks = rng.split(key, 5).unbind(-2)[:2]
    lk = rng.split(k_blocks, arch.n_layers)
    ks = rng.split(lk, 6).unbind(-2)
    d, n, h = arch.d_model, arch.n_layers, arch.head_dim
    ka = rng.split(ks[0], 4).unbind(-2)
    blocks = {
        "ln1": {"w": torch.ones((n, d), device=device)},
        "ln2": {"w": torch.ones((n, d), device=device)},
        "attn": {"wq": _dense(ka[0], d, arch.n_heads * h),
                 "wk": _dense(ka[1], d, arch.n_kv_heads * h),
                 "wv": _dense(ka[2], d, arch.n_kv_heads * h),
                 "wo": _dense(ka[3], arch.n_heads * h, d)},
    }
    if arch.moe:
        km = rng.split(ks[1], 4).unbind(-2)
        e, f = arch.num_experts, arch.d_expert
        sd, sf = float(np.sqrt(np.float32(d))), float(np.sqrt(np.float32(f)))
        blocks["moe"] = {"router": _dense(km[0], d, e),
                         "w_gate": rng.div_f32(rng.normal(km[1], (e, d, f)), sd),
                         "w_up": rng.div_f32(rng.normal(km[2], (e, d, f)), sd),
                         "w_down": rng.div_f32(rng.normal(km[3], (e, f, d)), sf)}
    else:
        kf = rng.split(ks[1], 3).unbind(-2)
        blocks["mlp"] = {"w_gate": _dense(kf[0], d, arch.d_ff),
                         "w_up": _dense(kf[1], d, arch.d_ff),
                         "w_down": _dense(kf[2], arch.d_ff, d)}
    return {"embed": rng.normal(k_embed, (arch.vocab, d))
            * float(np.float32(0.02)),
            "blocks": blocks,
            "final_norm": {"w": torch.ones((d,), device=device)}}


# ---------------------------------------------------------------------------
# the forward pass
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotate the two halves of each head by ``pos / theta ** (i / half)``
    (the power as XLA's float32 ``pow`` gives it)."""
    half = x.shape[-1] // 2
    expo = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / rng.pow_f32(
        torch.full_like(expo, float(np.float32(theta))), expo)
    ang = positions[..., None].float() * freqs
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def attention(p: Params, arch: Arch, x: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    """Causal grouped-query attention: ``n_heads / n_kv_heads`` query
    heads share each key and value head."""
    B, L, _ = x.shape
    h, hq, hkv = arch.head_dim, arch.n_heads, arch.n_kv_heads
    q = rope((x @ p["wq"].to(x.dtype)).reshape(B, L, hq, h), positions,
             arch.rope_theta)
    k = rope((x @ p["wk"].to(x.dtype)).reshape(B, L, hkv, h), positions,
             arch.rope_theta)
    v = (x @ p["wv"].to(x.dtype)).reshape(B, L, hkv, h)
    diff = positions[:, :, None] - positions[:, None, :]
    bias = torch.where(diff >= 0, 0.0, -1e30).to(torch.float32)
    qg = q.reshape(B, L, hkv, hq // hkv, h)
    scores = torch.einsum("blkgh,bmkh->bklgm", qg, k).float()
    scores = scores / float(np.sqrt(np.float32(h)))
    scores = scores + bias[:, None, :, None, :]
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bklgm,bmkh->blkgh", probs, v).reshape(B, L, hq * h)
    return out @ p["wo"].to(x.dtype)


def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(x @ p["w_gate"].to(x.dtype))
    return (g * (x @ p["w_up"].to(x.dtype))) @ p["w_down"].to(x.dtype)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def moe(p: Params, arch: Arch, x: torch.Tensor):
    """Top-k experts over groups of tokens, each expert taking at most
    ``C`` tokens of a group (tokens past it are dropped, the residual
    carries them); returns the output and the load-balance loss."""
    B, L, D = x.shape
    E, K = arch.num_experts, arch.top_k
    n_tok = B * L
    g = min(arch.group_size, n_tok)
    while n_tok % g:
        g -= 1
    G = n_tok // g
    xt = x.reshape(G, g, D)
    probs = torch.softmax((xt @ p["router"].to(xt.dtype)).float(), dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :K], topi[..., :K]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    C = max(1, int(g * K * arch.capacity_factor / E))
    C = max(C, g) if g <= 64 else C
    flat = F.one_hot(topi, E).reshape(G, g * K, E)
    pos = ((torch.cumsum(flat, dim=1) - flat) * flat).sum(-1).reshape(G, g, K)
    dt = x.dtype
    disp = (_one_hot(topi, E, dt)[..., None] * _one_hot(pos, C, dt)[..., None, :]
            * (pos < C)[..., None, None].to(dt))
    combine = (disp * topv[..., None, None].to(dt)).sum(2)
    disp = disp.sum(2)
    xe = torch.einsum("gsec,gsd->gecd", disp, xt)
    hg = F.silu(torch.einsum("gecd,edf->gecf", xe, p["w_gate"].to(dt)))
    u = torch.einsum("gecd,edf->gecf", xe, p["w_up"].to(dt))
    ye = torch.einsum("gecf,efd->gecd", hg * u, p["w_down"].to(dt))
    out = torch.einsum("gsec,gecd->gsd", combine, ye)
    me = probs.mean(dim=(0, 1))
    fe = _one_hot(topi[..., 0], E, torch.float32).mean(dim=(0, 1))
    return out.reshape(B, L, D), E * torch.sum(me * fe)


def _layers(blocks: Params, n: int) -> List[Params]:
    """One params dict a layer, as views of the stacked leaves."""
    out: List[Params] = [dict() for _ in range(n)]

    def fill(node, dsts):
        for k, v in node.items():
            if isinstance(v, dict):
                fill(v, [dst.setdefault(k, {}) for dst in dsts])
            else:
                for dst, leaf in zip(dsts, v.unbind(0)):
                    dst[k] = leaf
    fill(blocks, out)
    return out


def loss(params: Params, arch: Arch, tokens: torch.Tensor,
         compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Next-token cross-entropy of ``tokens`` (B, L), plus the weighted
    load-balance loss summed over the layers."""
    B, L = tokens.shape
    x = params["embed"].to(compute_dtype)[tokens.long()]
    positions = torch.arange(L, dtype=torch.int32,
                             device=x.device)[None].expand(B, L)
    auxs = []
    for lp in _layers(params["blocks"], arch.n_layers):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        x = x + attention(lp["attn"], arch,
                          rms_norm(x, lp["ln1"]["w"], arch.norm_eps),
                          positions)
        h2 = rms_norm(x, lp["ln2"]["w"], arch.norm_eps)
        if arch.moe:
            h2, aux = moe(lp["moe"], arch, h2)
        else:
            h2 = swiglu(lp["mlp"], h2)
        x = x + h2
        auxs.append(aux)
    hidden = rms_norm(x, params["final_norm"]["w"], arch.norm_eps)
    h = hidden[:, :-1, :]
    logits = (h @ params["embed"].T.to(h.dtype)).float()
    nll = -torch.gather(torch.log_softmax(logits, dim=-1), -1,
                        tokens[:, 1:].long()[..., None])[..., 0]
    return torch.mean(nll) + arch.aux_weight * torch.sum(torch.stack(auxs))


def grads(params: Params, arch: Arch, tokens: torch.Tensor,
          out: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The loss of ``tokens`` and its gradient, written flat into ``out``."""
    p = tree_map(lambda a: a.detach().requires_grad_(True), params)
    value = loss(p, arch, tokens, compute_dtype)
    g = torch.autograd.grad(value, leaves(p))
    torch.cat([t.reshape(-1).float() for t in g], out=out)
    return value.detach()
