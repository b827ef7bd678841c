"""Public model API: init / train forward (loss) / serve decode step.

The port of the reference's ``repro/models/model.py``.  ``Batch`` covers
every modality the zoo's families take:

  tokens    (B, L)  int32        — always present (labels = tokens shifted)
  positions (B, L[,3]) int32     — optional (M-RoPE needs 3-D)
  extra     (B, P, D) float      — stub frontend embeddings (vlm)
  frames    (B, F, D_enc) float  — stub audio frames (whisper encoder input)
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.convert import tree_leaves
from repro_torch.models import transformer

Params = Dict[str, Any]


def init_params(cfg: ArchConfig, key) -> Params:
    return transformer.init_params(cfg, key)


def loss_fn(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            compute_dtype=torch.bfloat16, remat: bool = True,
            aux_weight: float = 0.01,
            loss_chunk: int = 0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy (+ MoE aux). Returns (loss, metrics).

    loss_chunk > 0 computes the vocab head + CE over token chunks so the
    (tokens, vocab) logits tensor is never materialised at once.
    """
    tokens = batch["tokens"]
    enc_out = None
    if cfg.encoder is not None:
        enc_out = transformer.encode_audio(
            params, cfg, batch["frames"].to(compute_dtype))
    hidden, _, aux = transformer.forward(
        params, cfg, tokens,
        positions=batch.get("positions"),
        extra_embeds=batch.get("extra"),
        enc_out=enc_out,
        compute_dtype=compute_dtype, remat=remat, return_hidden=True)
    # predict token t+1 from prefix; modality prefixes are unsupervised
    P = hidden.shape[1] - tokens.shape[1]
    h = hidden[:, P:, :][:, :-1, :]
    tgt = tokens[:, 1:].long()
    w_head = (params["embed"].T if cfg.tie_embeddings
              else params["lm_head"])

    def chunk_nll(hc, tc):
        lg = (hc @ w_head.to(hc.dtype)).float()
        logp = torch.log_softmax(lg, dim=-1)
        return -torch.gather(logp, -1, tc[..., None])[..., 0]

    B, Lm1, D = h.shape
    n_tok = B * Lm1
    if loss_chunk and n_tok > loss_chunk:
        ck = loss_chunk
        while n_tok % ck:
            ck -= 1
        hf = h.reshape(n_tok // ck, ck, D)
        tf = tgt.reshape(n_tok // ck, ck)
        nll_sum = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(n_tok // ck):
            nll_sum = nll_sum + torch.sum(chunk_nll(hf[i], tf[i]))
        loss = nll_sum / n_tok
    else:
        loss = torch.mean(chunk_nll(h, tgt))
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux": aux,
                   "ppl": torch.exp(torch.clamp(loss, 0, 20.0))}


def init_decode_cache(cfg: ArchConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16,
                      decode_window: Optional[int] = None,
                      device=None) -> Params:
    return transformer.init_cache(cfg, batch, max_len, dtype, decode_window,
                                  device=device)


@torch.no_grad()
def decode_step(params: Params, cfg: ArchConfig, token: torch.Tensor,
                cache: Params, pos: int, *,
                enc_out: Optional[torch.Tensor] = None,
                compute_dtype=torch.bfloat16,
                decode_window: Optional[int] = None):
    """One-token decode. token: (B, 1) int32; pos: the current position (a
    python int).

    Returns (logits (B, 1, V) float32, new_cache).  ``cache_index`` is pos
    for full caches, pos % window for ring-buffer (sliding-window) caches.
    ``cache`` is consumed: its KV caches are written in place.
    """
    pos = int(pos)
    cache_index = pos % decode_window if decode_window is not None else pos
    B = token.shape[0]
    pos1 = torch.full((B, 1), pos, dtype=torch.int32, device=token.device)
    positions = (pos1[..., None].expand(B, 1, 3)
                 if cfg.mrope_sections is not None else pos1)
    logits, new_cache, _ = transformer.forward(
        params, cfg, token, positions=positions, enc_out=enc_out,
        cache=cache, cache_index=cache_index, compute_dtype=compute_dtype,
        remat=False, decode_window=decode_window)
    return logits, new_cache


def param_count(params: Params) -> int:
    return int(sum(x.numel() for x in tree_leaves(params)))
