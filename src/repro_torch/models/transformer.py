"""Model assembly: decoder stacks of the attention families.

The port of the reference's ``repro/models/transformer.py`` for the blocks
the attention-only families run: GQA self-attention (``ATTN``, and
``SWA`` with a sliding window) with a SwiGLU MLP (dense: smollm, qwen3,
yi, mistral-large; vlm: qwen2-vl with M-RoPE and a stub patch prefix), and
whisper's decoder with a GELU MLP and cross-attention over a
bidirectional encoder of stub frame embeddings.

The reference scans its layers over stacked params; here the stacked
leaves ``(n_layers, ...)`` are unbound once per forward and the layers run
in a loop.  ``remat`` (``jax.checkpoint``) becomes
``torch.utils.checkpoint`` per block, with the same values.  ``MOE``,
``MAMBA2`` and ``RWKV6`` blocks and zamba2's shared attention
(``shared_attn_every``) raise ``NotImplementedError``: ``models/moe.py``,
``ssm.py`` and ``rwkv.py`` are the next slice of the port.  So do the
decode caches, which the serve slice brings.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import rng
from repro_torch.configs.base import ATTN, SWA, ArchConfig
from repro_torch.models.layers import (
    AttnSpec, _dense_init, attention, gelu_mlp, init_attention, init_gelu_mlp,
    init_rmsnorm, init_swiglu, rms_norm, swiglu,
)

Params = Dict[str, Any]

#: the block kinds this slice of the port runs
PORTED_KINDS = (ATTN, SWA)


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet: the MoE, Mamba2 and RWKV6 blocks and "
        "zamba2's hybrid stack (models/moe.py, ssm.py, rwkv.py) are the "
        "next slice of the port")


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


def attn_spec(cfg: ArchConfig, sliding: bool = False,
              decode_window: Optional[int] = None,
              causal: bool = True) -> AttnSpec:
    window = cfg.sliding_window if sliding else None
    if decode_window is not None:
        window = decode_window
    return AttnSpec(d_model=cfg.d_model, n_heads=cfg.n_heads,
                    n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
                    qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
                    sliding_window=window, causal=causal,
                    mrope_sections=cfg.mrope_sections, norm_eps=cfg.norm_eps)


def block_kind(cfg: ArchConfig) -> str:
    kinds = set(cfg.blocks())
    assert len(kinds) == 1, f"heterogeneous stack unsupported: {kinds}"
    return next(iter(kinds))


def ported_kind(cfg: ArchConfig) -> str:
    """:func:`block_kind`, raising for the blocks of the next slice."""
    kind = block_kind(cfg)
    if kind not in PORTED_KINDS:
        raise _not_ported(f"{cfg.name}'s {kind!r} blocks")
    if cfg.shared_attn_every:
        raise _not_ported(f"{cfg.name}'s shared attention block")
    return kind


def _encoder_spec(cfg: ArchConfig) -> AttnSpec:
    e = cfg.encoder
    return AttnSpec(d_model=e.d_model, n_heads=e.n_heads,
                    n_kv_heads=e.n_heads, head_dim=e.d_model // e.n_heads,
                    causal=False)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_layer(key, cfg: ArchConfig, kind: str) -> Params:
    """One layer's params; a stack of keys ``(n, 2)`` gives the n layers'
    params stacked, as ``jax.vmap`` of the reference's init does."""
    if kind not in PORTED_KINDS:
        raise _not_ported(f"the {kind!r} block")
    ks = rng.split(key, 6).unbind(-2)
    d, lead, dev = cfg.d_model, tuple(key.shape[:-1]), key.device
    p = {"ln1": init_rmsnorm(d, lead, dev), "ln2": init_rmsnorm(d, lead, dev),
         "attn": init_attention(ks[0], attn_spec(cfg))}
    if cfg.family == "audio":
        p["mlp"] = init_gelu_mlp(ks[1], d, cfg.d_ff)
        p["ln_x"] = init_rmsnorm(d, lead, dev)
        p["xattn"] = init_attention(ks[2], attn_spec(cfg, causal=False))
    else:
        p["mlp"] = init_swiglu(ks[1], d, cfg.d_ff)
    return p


def init_params(cfg: ArchConfig, key) -> Params:
    """The model's params from ``key`` (a :mod:`repro_torch.rng` key), on
    the key's device: the reference's draws bit for bit (the stacked
    layers as its ``vmap`` draws them)."""
    kind = ported_kind(cfg)
    k_embed, k_blocks, k_head, _k_shared, k_enc = rng.split(key, 5).unbind(-2)
    layer_keys = rng.split(k_blocks, cfg.n_layers)
    dev = key.device
    params: Params = {
        "embed": rng.normal(k_embed, (cfg.vocab, cfg.d_model))
        * float(np.float32(0.02)),
        "blocks": init_layer(layer_keys, cfg, kind),
        "final_norm": init_rmsnorm(cfg.d_model, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _dense_init(k_head, cfg.d_model, cfg.vocab)
    if cfg.encoder is not None:
        e = cfg.encoder
        ek = rng.split(k_enc, e.n_layers + 1)[:-1]
        a, b = rng.split(ek, 2).unbind(-2)
        lead = (e.n_layers,)
        params["encoder"] = {
            "blocks": {"ln1": init_rmsnorm(e.d_model, lead, dev),
                       "ln2": init_rmsnorm(e.d_model, lead, dev),
                       "attn": init_attention(a, _encoder_spec(cfg)),
                       "mlp": init_gelu_mlp(b, e.d_model, e.d_ff)},
            "final_norm": init_rmsnorm(e.d_model, device=dev),
        }
    return params


# ---------------------------------------------------------------------------
# block apply
# ---------------------------------------------------------------------------


def apply_block(p: Params, cfg: ArchConfig, kind: str, x: torch.Tensor,
                positions, cache=None, cache_index=None, enc_out=None,
                decode_window: Optional[int] = None):
    """One decoder block. Returns (x, new_cache, aux_loss)."""
    if kind not in PORTED_KINDS:
        raise _not_ported(f"the {kind!r} block")
    if cache is not None:
        raise NotImplementedError(
            "decode caches are the serve path's; they are ported with "
            "train/serve.py")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    spec = attn_spec(cfg, sliding=(kind == SWA
                                   or cfg.sliding_window is not None),
                     decode_window=decode_window)
    h, _ = attention(p["attn"], spec, rms_norm(x, p["ln1"], cfg.norm_eps),
                     positions)
    x = x + h
    if enc_out is not None:   # whisper decoder cross-attention
        hx, _ = attention(p["xattn"], attn_spec(cfg, causal=False),
                          rms_norm(x, p["ln_x"], cfg.norm_eps),
                          positions, kv_source=enc_out)
        x = x + hx
    h2_in = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.family == "audio":
        h2 = gelu_mlp(p["mlp"], h2_in)
    else:
        h2 = swiglu(p["mlp"], h2_in)
    return x + h2, cache, aux


# ---------------------------------------------------------------------------
# whole-model forward
# ---------------------------------------------------------------------------


def layer_params(blocks: Params, n_layers: int) -> List[Params]:
    """The stacked ``(n_layers, ...)`` leaves as one params dict per layer
    (``unbind``: one op per leaf, and one gradient stack per leaf)."""
    out = [dict() for _ in range(n_layers)]

    def fill(node, dsts):
        for k, v in node.items():
            if isinstance(v, dict):
                subs = [dst.setdefault(k, {}) for dst in dsts]
                fill(v, subs)
            else:
                for dst, leaf in zip(dsts, v.unbind(0)):
                    dst[k] = leaf

    fill(blocks, out)
    return out


def encode_audio(params: Params, cfg: ArchConfig, frames: torch.Tensor):
    """Whisper encoder over stub frame embeddings (B, n_frames, d_enc)."""
    espec = _encoder_spec(cfg)
    B, L, _ = frames.shape
    pos = torch.arange(L, dtype=torch.int32,
                       device=frames.device)[None].expand(B, L)
    x = frames
    for lp in layer_params(params["encoder"]["blocks"], cfg.encoder.n_layers):
        h, _ = attention(lp["attn"], espec, rms_norm(x, lp["ln1"]), pos)
        x = x + h
        x = x + gelu_mlp(lp["mlp"], rms_norm(x, lp["ln2"]))
    return rms_norm(x, params["encoder"]["final_norm"])


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            extra_embeds: Optional[torch.Tensor] = None,
            enc_out: Optional[torch.Tensor] = None,
            cache: Optional[Params] = None,
            cache_index=None,
            compute_dtype=torch.bfloat16,
            remat: bool = False,
            decode_window: Optional[int] = None,
            return_hidden: bool = False):
    """Full forward. Returns (logits|hidden, new_cache, aux_loss).

    tokens: (B, L) int32. extra_embeds: modality prefix (B, P, D) — the stub
    frontend output for vlm; for audio, enc_out is the encoder output fed to
    cross-attention.  ``cache`` (decode) raises until the serve slice.
    """
    kind = ported_kind(cfg)
    if cache is not None:
        raise NotImplementedError(
            "decode caches are the serve path's; they are ported with "
            "train/serve.py")
    B = tokens.shape[0]
    x = params["embed"].to(compute_dtype)[tokens.long()]
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(compute_dtype), x], dim=1)
    L = x.shape[1]
    if positions is None:
        pos1 = torch.arange(L, dtype=torch.int32,
                            device=x.device)[None].expand(B, L)
        if cache_index is not None:
            pos1 = pos1 + int(cache_index)
        if cfg.mrope_sections is not None:
            positions = pos1[..., None].expand(B, L, 3)
        else:
            positions = pos1

    def block(lp, x):
        return apply_block(lp, cfg, kind, x, positions, enc_out=enc_out,
                           decode_window=decode_window)[0]

    for lp in layer_params(params["blocks"], cfg.n_layers):
        if remat:
            x = checkpoint(block, lp, x, use_reentrant=False)
        else:
            x = block(lp, x)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    out = (rms_norm(x, params["final_norm"], cfg.norm_eps)
           if return_hidden else _head(params, cfg, x))
    return out, None, aux_total


def _head(params: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ w.to(x.dtype)).float()


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, decode_window: Optional[int] = None):
    raise NotImplementedError(
        "decode caches are the serve path's; they are ported with "
        "train/serve.py")
