"""Model assembly: the decoder stacks of every zoo family.

The port of the reference's ``repro/models/transformer.py``.  Stacks are
homogeneous per architecture:

* GQA self-attention (``ATTN``, and ``SWA`` with a sliding window) with a
  SwiGLU MLP (dense: smollm, qwen3, yi, mistral-large; vlm: qwen2-vl with
  M-RoPE and a stub patch prefix), and whisper's decoder with a GELU MLP
  and cross-attention over a bidirectional encoder of stub frame
  embeddings;
* GQA self-attention with the MoE MLP (``MOE``: granite-moe,
  :mod:`repro_torch.models.moe`);
* the Mamba2 mixer (``MAMBA2``, :mod:`repro_torch.models.ssm`), and
  zamba2's hybrid layout: ``n_layers // every`` super-blocks of ``every``
  Mamba2 layers and one application of the weight-shared attention block,
  then the remaining Mamba2 layers;
* RWKV-6 time-mix and channel-mix (``RWKV6``, :mod:`repro_torch.models.rwkv`).

The reference scans its layers over stacked params; here the stacked
leaves ``(n_layers, ...)`` are unbound once per forward and the layers run
in a loop.  ``remat`` (``jax.checkpoint``) becomes
``torch.utils.checkpoint`` per block, with the same values; in the hybrid
stack only the Mamba2 layers are rematerialised, as in the reference.
The decode caches (:func:`init_cache`, ``cache=`` of :func:`forward`)
raise: they are the serve slice's.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import rng
from repro_torch.configs.base import ATTN, MAMBA2, MOE, RWKV6, SWA, ArchConfig
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (
    AttnSpec, _dense_init, attention, gelu_mlp, init_attention, init_gelu_mlp,
    init_rmsnorm, init_swiglu, rms_norm, swiglu,
)

Params = Dict[str, Any]


def _no_cache():
    return NotImplementedError(
        "decode caches are the serve path's; they are ported with "
        "train/serve.py")


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
    ks = rng.split(key, 6).unbind(-2)
    d, lead, dev = cfg.d_model, tuple(key.shape[:-1]), key.device
    if kind in (ATTN, SWA):
        p = {"ln1": init_rmsnorm(d, lead, dev),
             "ln2": init_rmsnorm(d, lead, dev),
             "attn": init_attention(ks[0], attn_spec(cfg))}
        if cfg.family == "audio":
            p["mlp"] = init_gelu_mlp(ks[1], d, cfg.d_ff)
            p["ln_x"] = init_rmsnorm(d, lead, dev)
            p["xattn"] = init_attention(ks[2], attn_spec(cfg, causal=False))
        else:
            p["mlp"] = init_swiglu(ks[1], d, cfg.d_ff)
        return p
    if kind == MOE:
        return {"ln1": init_rmsnorm(d, lead, dev),
                "ln2": init_rmsnorm(d, lead, dev),
                "attn": init_attention(ks[0], attn_spec(cfg)),
                "moe": moe_lib.init_moe(ks[1], d, cfg.moe)}
    if kind == MAMBA2:
        return {"ln1": init_rmsnorm(d, lead, dev),
                "mamba": ssm_lib.init_mamba2(ks[0], d, cfg.ssm)}
    if kind == RWKV6:
        return {"ln1": init_rmsnorm(d, lead, dev),
                "ln2": init_rmsnorm(d, lead, dev),
                "time": rwkv_lib.init_rwkv6_time(ks[0], d, cfg.rwkv),
                "channel": rwkv_lib.init_rwkv6_channel(ks[1], d, cfg.d_ff)}
    raise ValueError(kind)


def init_params(cfg: ArchConfig, key) -> Params:
    """The model's params from ``key`` (a :mod:`repro_torch.rng` key), on
    the key's device: the reference's draws bit for bit (the stacked
    layers as its ``vmap`` draws them)."""
    kind = block_kind(cfg)
    k_embed, k_blocks, k_head, k_shared, k_enc = rng.split(key, 5).unbind(-2)
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
    if cfg.shared_attn_every:
        ks1, ks2 = rng.split(k_shared, 2).unbind(-2)
        params["shared_attn"] = {
            "ln1": init_rmsnorm(cfg.d_model, device=dev),
            "ln2": init_rmsnorm(cfg.d_model, device=dev),
            "attn": init_attention(ks1, attn_spec(cfg)),
            "mlp": init_swiglu(ks2, cfg.d_model, cfg.d_ff)}
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
    if cache is not None:
        raise _no_cache()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in (ATTN, SWA, MOE):
        spec = attn_spec(cfg, sliding=(kind == SWA
                                       or cfg.sliding_window is not None),
                         decode_window=decode_window)
        h, _ = attention(p["attn"], spec,
                         rms_norm(x, p["ln1"], cfg.norm_eps), positions)
        x = x + h
        if enc_out is not None:   # whisper decoder cross-attention
            hx, _ = attention(p["xattn"], attn_spec(cfg, causal=False),
                              rms_norm(x, p["ln_x"], cfg.norm_eps),
                              positions, kv_source=enc_out)
            x = x + hx
        h2_in = rms_norm(x, p["ln2"], cfg.norm_eps)
        if kind == MOE:
            h2, aux = moe_lib.moe_mlp(p["moe"], h2_in, cfg.moe)
        elif cfg.family == "audio":
            h2 = gelu_mlp(p["mlp"], h2_in)
        else:
            h2 = swiglu(p["mlp"], h2_in)
        return x + h2, None, aux
    if kind == MAMBA2:
        h, _ = ssm_lib.mamba2_forward(
            p["mamba"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg.d_model,
            cfg.ssm)
        return x + h, None, aux
    if kind == RWKV6:
        h, _ = rwkv_lib.rwkv6_time_mix(
            p["time"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg.rwkv)
        x = x + h
        h2, _ = rwkv_lib.rwkv6_channel_mix(
            p["channel"], rms_norm(x, p["ln2"], cfg.norm_eps))
        return x + h2, None, aux
    raise ValueError(kind)


def _apply_shared_attn(p: Params, cfg: ArchConfig, x, positions,
                       decode_window: Optional[int] = None):
    """Zamba2's weight-shared attention block (no cache: train/prefill)."""
    spec = attn_spec(cfg, decode_window=decode_window)
    h, _ = attention(p["attn"], spec, rms_norm(x, p["ln1"], cfg.norm_eps),
                     positions)
    x = x + h
    return x + swiglu(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))


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
    kind = block_kind(cfg)
    if cache is not None:
        raise _no_cache()
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
        x, _, aux = apply_block(lp, cfg, kind, x, positions,
                                enc_out=enc_out, decode_window=decode_window)
        return x, aux

    def run_block(lp, x):
        if remat:
            return checkpoint(block, lp, x, use_reentrant=False)
        return block(lp, x)

    # zamba2: [every x mamba, shared attention] * n_shared + tail mamba
    every = cfg.shared_attn_every
    auxs = []
    for i, lp in enumerate(layer_params(params["blocks"], cfg.n_layers)):
        x, aux = run_block(lp, x)
        auxs.append(aux)
        if every and (i + 1) % every == 0:
            x = _apply_shared_attn(params["shared_attn"], cfg, x, positions,
                                   decode_window)
    # the reference's jnp.sum over the layers (the hybrid stack's segment
    # sums are of Mamba2's zero aux, so the same value)
    aux_total = torch.sum(torch.stack(auxs))
    out = (rms_norm(x, params["final_norm"], cfg.norm_eps)
           if return_hidden else _head(params, cfg, x))
    return out, None, aux_total


def _head(params: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ w.to(x.dtype)).float()


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, decode_window: Optional[int] = None):
    """The per-layer decode states (KV caches; zamba2's Mamba2 and shared
    attention states; RWKV-6's shift and WKV states) are the serve slice's:
    the blocks' state shapes are here (``ssm.init_mamba2_state``,
    ``rwkv.init_rwkv6_state``), their stacking is ported with
    ``train/serve.py``."""
    raise _no_cache()
