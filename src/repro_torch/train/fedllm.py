"""Streamed OTA-DSGD over a zoo model's parameter tree.

The port of the reference's ``repro/train/fedllm.py``.  The paper's federated
round aggregates one d = 7850 vector; here the same registered ``Scheme``
contract runs over the gradient of any model in the zoo
(:mod:`repro_torch.models`: the attention, MoE, Mamba2, RWKV6 and hybrid
families), streamed through the bandwidth-limited MAC in fixed-size
chunks:

* the param tree is flattened in ``ravel_pytree``'s leaf order
  (:func:`repro_torch.train.trainer.ravel_meta`), so every device and the
  PS agree on which entry lands in which chunk;
* each chunk is one paper round of the registered scheme: the per-device
  error-feedback accumulators persist *per chunk* across global rounds
  (the EF state is ``(n_chunks, m, chunk_len)``);
* per-chunk RNG is ``fold_in(fold_in(round_key, SALT_STREAM), chunk)``:
  derived from the round key, never from carried state, which keeps
  checkpoint/resume bitwise.

The reference double-buffers the stream in a ``lax.scan`` (the PS decodes
chunk ``i - 1`` while the devices encode chunk ``i``) so XLA can overlap
the two.  In eager torch :func:`stream_round` runs the same ops per chunk
as :func:`stream_round_ref`, in the pipelined order, on one stream;
overlapping the decode on a second CUDA stream is later speed work.  With
``use_kernel`` every chunk launches ``ef_sparsify``, ``ota_project`` and
``amp_fused`` once each.

:class:`CompiledFedLLM` implements the ``carry0`` / ``run_segment``
segment contract, so :func:`repro_torch.experiments.engine.run_checkpointed`
checkpoints and resumes it bitwise, and resumes a checkpoint the JAX
package wrote (the reference's leaf names and order).

:func:`serve_while_train` alternates one-round segments with serving the
round's decoded global params (:mod:`repro_torch.train.serve`).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import rng, tracing
from repro_torch.configs.base import ArchConfig, OTAConfig, TrainConfig
from repro_torch.convert import tree_leaves, tree_map
from repro_torch.core.schemes import (
    MACContext, Scheme, encode_round, get_scheme, metric_mean,
    round_simulated,
)
from repro_torch.device import clock, resolve_device
from repro_torch.experiments.engine import (
    _restore_carry, _stack_outs, round_keys, round_masked,
)
from repro_torch.models import model as model_lib
from repro_torch.optim.optim import make_optimizer
from repro_torch.train.trainer import (
    _pad_multiple, abstract_params, ravel_meta,
)

# RNG salts (extending the reference's 0-7 layout): chunk index inside a
# streamed round, and per-device synthetic-batch draws.
SALT_STREAM = 8
SALT_DATA = 9


def _chunk_key(key: torch.Tensor, i: int) -> torch.Tensor:
    """Per-chunk round key: chunk i is an independent paper round."""
    return rng.fold_in(rng.fold_in(key, SALT_STREAM), i)


def _chunk_metrics(metrics: Dict[str, torch.Tensor], draw) -> Dict[str, Any]:
    """The per-chunk metric dict ``round_simulated`` would have produced."""
    met = {k: metric_mean(v) for k, v in metrics.items()}
    met["active_frac"] = draw.active.float().mean(dim=-1)
    if draw.gain is not None:
        met["chan_gain"] = draw.gain.mean(dim=-1)
    if draw.noise_scale is not None:
        met["noise_scale"] = draw.noise_scale
    return met


def _chunk(gchunks: torch.Tensor, i: int) -> torch.Tensor:
    """Chunk i's ``(m, chunk_len)`` gradients as a fresh contiguous tensor
    (``gchunks`` may be a strided view of the ``(m, d_pad)`` gradients)."""
    return gchunks[i].contiguous()


class _Stream:
    """The stacked outputs of a streamed round, written chunk by chunk."""

    def __init__(self, scheme: Scheme, gchunks, deltas):
        n = gchunks.shape[0]
        self.ghats = torch.empty((n, scheme.d), dtype=torch.float32,
                                 device=deltas.device)
        self.deltas = torch.empty_like(deltas)
        self.mets: List[Dict[str, torch.Tensor]] = []

    def done(self):
        mets = {k: torch.stack([m[k] for m in self.mets])
                for k in self.mets[0]}
        return self.ghats, self.deltas, mets


def stream_round(scheme: Scheme, gchunks: torch.Tensor,
                 deltas: torch.Tensor, t: int, key: torch.Tensor,
                 ctx: MACContext):
    """One federated round streamed chunk by chunk, in the reference's
    pipelined order.

    ``gchunks``/``deltas``: (n_chunks, m, chunk_len).  The prologue encodes
    chunk 0; each step decodes the in-flight chunk ``i - 1`` and encodes
    chunk ``i``; the epilogue decodes the last chunk.  Bitwise equal to
    :func:`stream_round_ref` (the straight per-chunk ``round_simulated``
    loop): every chunk sees the same ops with the same ``_chunk_key``.

    Returns ``(ghats, new_deltas, mets)`` stacked over chunks.
    """
    out = _Stream(scheme, gchunks, deltas)

    def encode(i):
        tracing.at_chunk(i)
        tracing.count("chunks")
        y, nd, met, draw = encode_round(scheme, _chunk(gchunks, i),
                                        deltas[i], t, _chunk_key(key, i),
                                        ctx)
        out.deltas[i] = nd
        out.mets.append(_chunk_metrics(met, draw))
        return y

    def decode(i, y):
        tracing.at_chunk(i)
        with tracing.span("stream.decode"):
            out.ghats[i] = scheme.decode(y, t, ctx)

    y_prev = encode(0)
    for i in range(1, gchunks.shape[0]):
        decode(i - 1, y_prev)     # PS: chunk i-1
        y_prev = encode(i)        # devices: chunk i
    decode(gchunks.shape[0] - 1, y_prev)
    tracing.at_chunk(None)
    return out.done()


def stream_round_ref(scheme: Scheme, gchunks: torch.Tensor,
                     deltas: torch.Tensor, t: int, key: torch.Tensor,
                     ctx: MACContext):
    """Non-pipelined reference: chunk i is literally ``round_simulated``
    under ``_chunk_key(key, i)``.  The parity pin for :func:`stream_round`."""
    out = _Stream(scheme, gchunks, deltas)
    for i in range(gchunks.shape[0]):
        ghat, nd, met = round_simulated(scheme, _chunk(gchunks, i),
                                        deltas[i], t, _chunk_key(key, i),
                                        ctx)
        out.ghats[i], out.deltas[i] = ghat, nd
        out.mets.append(met)
    return out.done()


def stream_round_masked(scheme: Scheme, gchunks: torch.Tensor,
                        deltas: torch.Tensor, t: int, key: torch.Tensor,
                        mask: torch.Tensor, ctx: MACContext):
    """Masked-cohort variant: chunk i runs ``round_masked`` (participation
    masks, fault traces, guardrail metrics) with the same per-chunk keys.
    At the all-ones mask it is bitwise :func:`stream_round`."""
    out = _Stream(scheme, gchunks, deltas)
    for i in range(gchunks.shape[0]):
        tracing.at_chunk(i)
        tracing.count("chunks")
        ghat, nd, met = round_masked(scheme, _chunk(gchunks, i), deltas[i],
                                     t, _chunk_key(key, i), mask, ctx)
        out.ghats[i], out.deltas[i] = ghat, nd
        out.mets.append(met)
    tracing.at_chunk(None)
    return out.done()


@dataclasses.dataclass
class CompiledFedLLM:
    """Streamed federated rounds over a zoo model, segment-contract shaped.

    M simulated edge devices each draw a deterministic synthetic batch
    (``fold_in(round_key, SALT_DATA)`` split per device — nothing consumed
    from carried state), compute a local gradient, and stream the
    flattened tree through the OTA channel ``chunk_len`` entries at a
    time.  The PS unravels the concatenated decoded chunks and applies the
    optimizer.  ``device=None`` is the card.
    """
    arch: ArchConfig
    train_cfg: TrainConfig
    ota: OTAConfig
    m: int = 4
    batch: int = 2
    seq_len: int = 16
    chunk_size: int = 1 << 14
    seed: int = 0
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.d, self.unravel = ravel_meta(abstract_params(self.arch))
        unit = (self.ota.block_size if self.ota.projection == "blocked"
                else 1)
        self.chunk_len = _pad_multiple(max(min(self.chunk_size, self.d), 2),
                                       unit)
        self.n_chunks = -(-self.d // self.chunk_len)
        self.d_pad = self.n_chunks * self.chunk_len
        self.scheme = get_scheme(self.ota, self.chunk_len, self.m,
                                 device=self.device)
        self.ctx = MACContext(m=self.m, fading=self.ota.fading,
                              csi=self.scheme.csi,
                              use_kernel=self.ota.use_kernel)
        self.opt = make_optimizer(self.train_cfg)
        self.compute_dtype = getattr(torch, self.train_cfg.compute_dtype)

    # ------------------------------------------------------------- carry
    def carry0(self) -> Tuple:
        params = model_lib.init_params(
            self.arch, rng.PRNGKey(self.seed, device=self.device))
        deltas = torch.zeros((self.n_chunks, self.m, self.chunk_len),
                             dtype=torch.float32, device=self.device)
        return (params, self.opt.init(params), deltas)

    _carry0 = carry0  # the reference's legacy spelling of the contract

    # ------------------------------------------------------------- round
    def _device_batch(self, key: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One device's synthetic batch; the stub embeddings as the
        reference's ``jit`` draws ``0.02 * normal`` (the constant moved
        onto the draw: :func:`repro_torch.rng.normal_scaled`)."""
        cfg = self.arch
        b = {"tokens": rng.randint(key, (self.batch, self.seq_len), 0,
                                   cfg.vocab)}
        if cfg.mrope_sections is not None:
            p = cfg.n_vision_tokens
            b["extra"] = rng.normal_scaled(
                key, (self.batch, p, cfg.d_model), 0.02)
            b["positions"] = torch.arange(
                p + self.seq_len, dtype=torch.int32,
                device=key.device)[None, :, None].expand(
                    self.batch, p + self.seq_len, 3)
        if cfg.encoder is not None:
            b["frames"] = rng.normal_scaled(
                key, (self.batch, cfg.encoder.n_frames, cfg.encoder.d_model),
                0.02)
        return b

    def _grads(self, params, key: torch.Tensor):
        """(m, d_pad) per-device flat gradients + mean local loss.

        One device after another, as the reference's ``lax.map``: one
        device's activations live at a time, and each gradient is written
        into its row of the preallocated ``(m, d_pad)`` block.
        """
        with tracing.span("grads"):
            gflat = torch.zeros((self.m, self.d_pad), dtype=torch.float32,
                                device=self.device)
            dev_keys = rng.split(rng.fold_in(key, SALT_DATA), self.m)
            losses = []
            for i in range(self.m):
                with tracing.span("grads.batch"):
                    batch = self._device_batch(dev_keys[i])
                p = tree_map(lambda a: a.detach().requires_grad_(True),
                             params)
                with tracing.span("grads.forward"):
                    loss, _ = model_lib.loss_fn(
                        p, self.arch, batch, compute_dtype=self.compute_dtype,
                        remat=self.train_cfg.remat)
                with tracing.span("grads.backward"):
                    grads = torch.autograd.grad(loss, tree_leaves(p))
                with tracing.span("grads.flatten"):
                    torch.cat([g.reshape(-1).float() for g in grads],
                              out=gflat[i, :self.d])
                losses.append(loss.detach())
            return gflat, torch.stack(losses).mean()

    def _round(self, sch: Scheme, carry, t: int, key, mask):
        with tracing.span("round", t=t):
            params, opt_state, deltas = carry
            gflat, loss = self._grads(params, key)
            gchunks = gflat.view(self.m, self.n_chunks,
                                 self.chunk_len).transpose(0, 1)
            with tracing.span("stream"):
                if mask is None:
                    ghats, new_deltas, mets = stream_round(
                        sch, gchunks, deltas, t, key, self.ctx)
                else:
                    ghats, new_deltas, mets = stream_round_masked(
                        sch, gchunks, deltas, t, key, mask, self.ctx)
            del gflat, gchunks
            ghat = ghats.reshape(self.d_pad)[: self.d]
            with tracing.span("adam"):
                params, opt_state = self.opt.apply(
                    params, self.unravel(ghat), opt_state)
            out = {"loss": loss,
                   "metrics": {k: torch.mean(v) for k, v in mets.items()}}
            return (params, opt_state, new_deltas), out

    # ------------------------------------------------------------ entry
    def run_segment(self, overrides: Dict[str, Any], keys: torch.Tensor,
                    mask, carry, t0):
        """Rounds ``t0 .. t0 + len(keys)`` from an explicit carry; returns
        ``(carry, outs)`` — the checkpoint/resume building block (the
        contract of ``CompiledExperiment.run_segment``)."""
        sch = (self.scheme.with_overrides(**overrides) if overrides
               else self.scheme)
        outs = []
        for i in range(keys.shape[0]):
            carry, out = self._round(sch, carry, int(t0) + i, keys[i], mask)
            outs.append(out)
        return carry, _stack_outs(outs)

    def run(self, keys: torch.Tensor,
            overrides: Optional[Dict[str, Any]] = None):
        """One full run from the initial carry."""
        carry, outs = self.run_segment(overrides or {}, keys, None,
                                       self.carry0(), 0)
        outs["params"] = carry[0]
        return outs


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, 1) int32 argmax of the last position's logits (the first index
    among equal values, as ``jnp.argmax``)."""
    return torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)


def serve_while_train(arch: ArchConfig, rounds: int = 2, *,
                      ota: Optional[OTAConfig] = None,
                      train_cfg: Optional[TrainConfig] = None,
                      m: int = 4, batch: int = 2, seq_len: int = 16,
                      chunk_size: int = 1 << 14,
                      serve_batch: int = 2, prompt_len: int = 4,
                      decode_steps: int = 4, seed: int = 0,
                      mesh=None, checkpoint_dir: Optional[str] = None,
                      checkpoint_every: int = 0, resume: bool = False,
                      verify_publish: bool = True,
                      device=None) -> Dict[str, Any]:
    """The serve-while-train loop, on ``device`` (the card by default).

    Alternates one-round training segments with serving: after round
    ``t`` a device-side copy of the decoded global params is
    :meth:`~repro_torch.train.serve.ServeStep.publish`-ed and
    ``prefill_fn`` + ``decode_fn`` answer a greedy batch (a zero prompt of
    ``prompt_len``, then ``decode_steps`` tokens) before round ``t + 1``
    starts.  With ``checkpoint_dir`` the carry is saved every
    ``checkpoint_every`` rounds through :mod:`repro_torch.train.checkpoint`
    (the reference's file, ``fedllm_ckpt.npz``) and ``resume=True``
    continues bitwise (per-round keys are absolute, the carry explicit).

    Returns ``{"losses", "metrics", "served_tokens", "publish_bitwise",
    "params", "seconds"}``: ``publish_bitwise`` stays True iff every
    round's served params were bitwise the round's decoded globals
    (``verify_publish``); ``seconds`` holds each round's ``train``,
    ``publish``, ``prefill`` and ``decode`` times on the host's clock, each
    read after the device's queue drained.
    """
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.train.serve import make_serve_step

    ota = ota or OTAConfig(projection="blocked", s_frac=0.25, k_frac=0.5,
                           block_size=1024)
    train_cfg = train_cfg or TrainConfig()
    mesh = mesh or make_local_mesh()
    fed = CompiledFedLLM(arch, train_cfg, ota, m=m, batch=batch,
                         seq_len=seq_len, chunk_size=chunk_size, seed=seed,
                         device=device)
    dev = fed.device
    serve = make_serve_step(arch, mesh, serve_batch,
                            prompt_len + decode_steps, device=dev)
    keys = round_keys(rounds, seed, device=dev)

    carry, t0 = fed.carry0(), 0
    ckpt = (os.path.join(checkpoint_dir, "fedllm_ckpt.npz")
            if checkpoint_dir else None)
    if resume and ckpt and os.path.exists(ckpt):
        loaded, t0 = load_checkpoint(ckpt, dev)
        carry = _restore_carry(carry, loaded)

    prompt = torch.zeros((serve_batch, prompt_len), dtype=torch.int32,
                         device=dev)
    losses, mets, served, seconds, publish_ok = [], [], [], [], True
    for t in range(t0, rounds):
        c0 = clock(dev)
        carry, outs = fed.run_segment({}, keys[t:t + 1], None, carry, t)
        losses.append(float(outs["loss"][0]))
        mets.append({k: float(v[0]) for k, v in outs["metrics"].items()})

        # publish round t's decoded globals (a device-side copy, so the
        # trainer's live carry is not handed away), then serve from them
        c1 = clock(dev)
        view = serve.publish(tree_map(torch.clone, carry[0]))
        c2 = clock(dev)
        if verify_publish:
            publish_ok = publish_ok and all(
                torch.equal(a, b) for a, b in zip(tree_leaves(view),
                                                  tree_leaves(carry[0])))
        c3 = clock(dev)
        logits, cache = serve.prefill_fn(view, serve.init_cache(), prompt)
        tok = _greedy(logits)
        c4 = clock(dev)
        toks = []
        for i in range(decode_steps):
            toks.append(tok[:, 0].cpu().numpy())
            logits, cache = serve.decode_fn(view, cache, tok, prompt_len + i)
            tok = _greedy(logits)
        c5 = clock(dev)
        served.append(np.stack(toks, axis=1))
        seconds.append({"train": c1 - c0, "publish": c2 - c1,
                        "prefill": c4 - c3, "decode": c5 - c4})
        del view, cache, logits

        if ckpt and checkpoint_every and (t + 1) % checkpoint_every == 0:
            save_checkpoint(ckpt, carry, step=t + 1)

    return {"losses": np.asarray(losses), "metrics": mets,
            "served_tokens": served, "publish_bitwise": publish_ok,
            "params": carry[0], "seconds": seconds}
