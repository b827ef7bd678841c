"""The experiment engine: a whole federated run with no host round trip.

The port of the reference's ``repro/experiments/engine.py``.  The reference
compiles the run into one jitted ``lax.scan``; here a run is one Python loop
over rounds whose every step stays on the device: each round performs
device gradients -> scheme encode -> MAC -> PS decode -> Adam with the
paper's per-round key stream and then evaluates test accuracy and loss on
the device, as the scan does.  All per-round outputs stay device tensors,
stacked at the end of a segment, and reach the host in one transfer when
the run returns (:func:`_subsample`); nothing inside the loop calls
``.item()``, ``float()`` or ``.cpu()``.  Capturing the loop in a CUDA graph
is later work.

The round body is built from the pieces of the looped driver
(``device_grads``, ``round_simulated``, ``Optimizer.apply``), so
:func:`run_compiled` equals :func:`repro_torch.train.paper_repro.run_federated`
entry for entry.  :func:`round_masked` silences padded devices with a
participation mask, and :func:`run_checkpointed` splits a run into segments
with an npz snapshot (``train/checkpoint.py``, the reference's layout) after
each, so that an interrupted run resumes bitwise.

Ported: the AWGN MAC with the ``ideal`` and ``a_dsgd`` schemes (dense and
blocked projection) and the identity local work.  Guardrails, schedule
overrides (the sweeps), the ``mac`` / ``fault`` / ``sched`` hooks of
:func:`round_masked` and any local work but one plain SGD step raise
``NotImplementedError``; none of them quietly takes another path.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import rng
from repro_torch.configs.base import OTAConfig
from repro_torch.convert import ravel, unravel
from repro_torch.core import channel
from repro_torch.core.schemes import (
    MACContext, Scheme, apply_channel_gain, get_scheme, round_sigma2,
    round_simulated,
)
from repro_torch.device import resolve_device
from repro_torch.optim.optim import Optimizer
from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.train.paper_repro import (
    accuracy, ce_loss, device_grads, init_linear,
)

#: base of the per-round key stream; round t of seed 0 uses PRNGKey(1000 + t),
#: matching run_federated exactly (seed k shifts the stream by k * steps so
#: seed replicas draw disjoint keys)
KEY_STREAM_BASE = 1000


def round_keys(steps: int, seed: int = 0, device=None) -> torch.Tensor:
    """(steps, 2) stacked per-round keys, ``vmap(PRNGKey)`` of the seeds
    ``1000 + seed * steps + t``, on ``device`` (the card by default)."""
    dev = resolve_device(device)
    seeds = (KEY_STREAM_BASE + seed * steps
             + torch.arange(steps, dtype=torch.int64, device=dev))
    return torch.stack([torch.zeros_like(seeds), seeds & rng.MASK32], dim=-1)


def eval_indices(steps: int, eval_every: int) -> np.ndarray:
    """The rounds run_federated evaluates after (t % every == 0 or last)."""
    return np.asarray([t for t in range(steps)
                       if t % eval_every == 0 or t == steps - 1], np.int64)


@dataclass(frozen=True)
class Experiment:
    """Static description of one federated training configuration."""
    cfg: OTAConfig
    steps: int
    lr: float = 1e-3
    eval_every: int = 10
    optimizer: str = "adam"
    local_steps: int = 1
    local_lr: float = 0.1
    momentum_correction: float = 0.0
    seed: int = 0
    use_kernel: bool = False     # the CUDA kernels inside the run
    guard: Optional[Any] = None  # round guardrails: not ported yet


@dataclass
class EngineRun:
    """Result of one run -- mirrors FederatedRun at eval points."""
    accs: List[float]
    losses: List[float]
    metrics: List[Dict[str, float]]
    eval_steps: np.ndarray
    all_accs: np.ndarray         # (steps,) -- every round
    all_losses: np.ndarray
    params: Any = None           # final model parameters (device tensors)


# ---------------------------------------------------------------------------
# masked round (padded device counts)
# ---------------------------------------------------------------------------


def round_masked(scheme: Scheme, grads: torch.Tensor, deltas: torch.Tensor,
                 step: int, key: torch.Tensor, mask: torch.Tensor,
                 ctx: MACContext, *, dev_keys=None, draw=None, mac=None,
                 fault=None, sched=None):
    """:func:`~repro_torch.core.schemes.round_simulated` with a device mask.

    ``mask`` (M_pad,) marks which padded devices exist: masked-out devices
    transmit nothing (their frames, power and mean slots included, are
    zeroed before the MAC sum), keep their error state, and the PS decodes
    against ``m_eff = max(sum(mask), 1)``.  The RNG layout matches
    ``round_simulated`` at ``M = M_pad``, so an all-ones mask reproduces it
    bitwise.  ``dev_keys`` (M_pad, 2) and ``draw`` replace the key split and
    the channel draw, as in the reference; its ``mac``, ``fault`` and
    ``sched`` hooks, robust aggregation and the transmit power cap are not
    ported yet and raise.
    """
    for name, hook in (("mac", mac), ("fault", fault), ("sched", sched)):
        if hook is not None:
            raise NotImplementedError(
                f"round_masked: the {name!r} hook is not ported yet")
    cfg = scheme.cfg
    if cfg.clip_power or cfg.aggregator != "mean":
        raise NotImplementedError(
            "round_masked: robust aggregation and clip_power are not ported "
            "yet")
    m_pad = grads.shape[0]
    mask_b = mask > 0
    # the max guard only engages when every device is masked out
    m_eff = torch.clamp(mask.to(torch.float32).sum(), min=1.0)
    ctx = dataclasses.replace(ctx, m=m_eff)
    if dev_keys is None:
        dev_keys = rng.split(rng.fold_in(key, 1), m_pad)
    if draw is None:
        draw = scheme.channel_draw(rng.fold_in(key, 2), step, m_pad)
    active = draw.active
    frames, new_deltas, metrics = scheme.encode(
        grads, deltas, step, dev_keys, ctx.with_p_factor(draw.p_factor))
    if scheme.analog:
        new_deltas = torch.where(active[:, None], new_deltas,
                                 scheme.silent_state(grads, deltas,
                                                     new_deltas))
        active = active & mask_b
        frames = apply_channel_gain(frames, draw._replace(active=active))
        y = channel.mac_sum(frames, rng.fold_in(key, 0),
                            round_sigma2(scheme, draw))
    else:
        active = active & mask_b
        y = (frames * mask_b[:, None]).sum(dim=0)
    # padded devices do not exist: their error state must not evolve
    new_deltas = torch.where(mask_b[:, None], new_deltas, deltas)
    ghat = scheme.decode(y, step, ctx)
    w = mask.to(torch.float32)
    metrics = {k: (v * w).sum() / m_eff for k, v in metrics.items()}
    metrics["active_frac"] = active.to(torch.float32).sum() / m_eff
    return ghat, new_deltas, metrics


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------


def _stack_outs(outs: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-round output dicts -> one dict of (rounds,) device tensors."""
    return {"acc": torch.stack([o["acc"] for o in outs]),
            "loss": torch.stack([o["loss"] for o in outs]),
            "metrics": {k: torch.stack([o["metrics"][k] for o in outs])
                        for k in outs[0]["metrics"]}}


def _concat_outs(chunks: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Concatenate per-segment outputs along the round axis."""
    return {"acc": torch.cat([c["acc"] for c in chunks]),
            "loss": torch.cat([c["loss"] for c in chunks]),
            "metrics": {k: torch.cat([c["metrics"][k] for c in chunks])
                        for k in chunks[0]["metrics"]}}


class CompiledExperiment:
    """Runner for one static configuration, on one device.

    :meth:`run_segment` is the segment contract the checkpoint driver
    needs: rounds ``t0 .. t0 + len(keys)`` from an explicit carry
    ``(params, opt_state, deltas, momenta)``.  ``overrides`` (the
    reference's per-grid-point schedules of the sweeps) must be empty.
    """

    def __init__(self, x_dev: np.ndarray, y_dev: np.ndarray,
                 x_test: np.ndarray, y_test: np.ndarray, exp: Experiment,
                 device=None):
        cfg = exp.cfg
        if exp.guard is not None:
            raise NotImplementedError("round guardrails are not ported yet")
        if exp.local_steps > 1 or cfg.local != "sgd" or cfg.local_epochs != 1:
            raise NotImplementedError(
                "only the identity local work (one SGD gradient per round) "
                f"is ported; got local={cfg.local!r}, local_epochs="
                f"{cfg.local_epochs}, local_steps={exp.local_steps}")
        self.device = resolve_device(device)
        m, _, dim = x_dev.shape
        self.exp = exp
        self.m = m
        n_classes = int(np.max(y_dev)) + 1
        self.params0 = init_linear(dim, n_classes, self.device)
        self.d = ravel(self.params0).shape[0]
        self.scheme = get_scheme(cfg, self.d, m, device=self.device)
        self.opt = Optimizer(name=exp.optimizer, lr=exp.lr)
        dev = self.device
        self.xd = torch.as_tensor(x_dev, dtype=torch.float32, device=dev)
        self.yd = torch.as_tensor(y_dev, device=dev).long()
        self.xt = torch.as_tensor(x_test, dtype=torch.float32, device=dev)
        self.yt = torch.as_tensor(y_test, device=dev).long()
        self.ctx = MACContext(m=m, use_kernel=exp.use_kernel or cfg.use_kernel)

    # ------------------------------------------------------------- pieces
    def carry0(self):
        zeros = torch.zeros((self.m, self.d), dtype=torch.float32,
                            device=self.device)
        return (self.params0, self.opt.init(self.params0), zeros,
                zeros.clone())

    #: the reference's name for :meth:`carry0`
    _carry0 = carry0

    def _round(self, carry, t: int, key: torch.Tensor, mask):
        params, opt_state, deltas, momenta = carry
        grads, momenta = device_grads(
            params, self.xd, self.yd, momenta,
            momentum_correction=self.exp.momentum_correction)
        if mask is None:
            ghat, deltas, met = round_simulated(self.scheme, grads, deltas,
                                                t, key, self.ctx)
        else:
            ghat, deltas, met = round_masked(self.scheme, grads, deltas, t,
                                             key, mask, self.ctx)
        params, opt_state = self.opt.apply(params, unravel(ghat, params),
                                           opt_state)
        out = {"acc": accuracy(params, self.xt, self.yt),
               "loss": ce_loss(params, self.xt, self.yt),
               "metrics": met}
        return (params, opt_state, deltas, momenta), out

    # ---------------------------------------------------------- entry
    def run_segment(self, overrides: Dict[str, Any], keys: torch.Tensor,
                    mask, carry, t0: int):
        """Rounds ``t0 .. t0 + len(keys)`` from an explicit carry.

        A full run is the composition of its segments (a round is a pure
        function of ``(carry, t, key)``), so splitting a run at any boundary
        and resuming from the saved carry reproduces it bitwise.  Returns
        ``(carry, outs)`` with outs of ``(len(keys),)`` device tensors.
        """
        if overrides:
            raise NotImplementedError(
                "schedule overrides (the sweeps) are not ported yet")
        outs = []
        for i in range(keys.shape[0]):
            carry, out = self._round(carry, int(t0) + i, keys[i], mask)
            outs.append(out)
        return carry, _stack_outs(outs)

    def _scan(self, overrides, keys, mask):
        carry, outs = self.run_segment(overrides, keys, mask, self.carry0(),
                                       0)
        outs["params"] = carry[0]
        return outs

    def run(self, overrides: Dict[str, Any], keys: torch.Tensor):
        """One full run. Returns {"acc": (steps,), "loss": (steps,),
        "metrics": {...: (steps,)}, "params": dict}, all on the device."""
        return self._scan(overrides, keys, None)

    def run_masked(self, overrides: Dict[str, Any], keys: torch.Tensor,
                   mask: torch.Tensor):
        """Padded-M variant: mask (M_pad,) marks live devices."""
        return self._scan(overrides, keys, mask)


def _restore_carry(ref_carry, loaded):
    """Rebuild a checkpointed carry against the engine's own carry.

    The structure (dict keys, tuple lengths), shapes and dtypes must match;
    each leaf moves to the device of its counterpart in ``ref_carry``.
    """
    if isinstance(ref_carry, dict):
        if not isinstance(loaded, dict) or set(loaded) != set(ref_carry):
            raise ValueError(f"checkpoint carry: expected keys "
                             f"{sorted(ref_carry)}, got {loaded!r:.200}")
        return {k: _restore_carry(v, loaded[k]) for k, v in ref_carry.items()}
    if isinstance(ref_carry, (tuple, list)):
        if (not isinstance(loaded, (tuple, list))
                or len(loaded) != len(ref_carry)):
            raise ValueError(f"checkpoint carry: expected {len(ref_carry)} "
                             f"entries, got {loaded!r:.200}")
        return type(ref_carry)(_restore_carry(r, v)
                               for r, v in zip(ref_carry, loaded))
    if loaded.shape != ref_carry.shape or loaded.dtype != ref_carry.dtype:
        raise ValueError(f"checkpoint carry: leaf {tuple(loaded.shape)} "
                         f"{loaded.dtype}, expected {tuple(ref_carry.shape)} "
                         f"{ref_carry.dtype}")
    return loaded.to(ref_carry.device)


def run_checkpointed(ce, overrides, keys, *, checkpoint_dir: str,
                     checkpoint_every: int, mask=None, resume: bool = False,
                     stop_after_step=None):
    """Drive a runner in checkpointed segments.

    ``ce`` satisfies the segment contract: ``carry0()`` (or the reference's
    ``_carry0``) builds the initial carry and ``run_segment(overrides,
    keys, mask, carry, t0)`` runs rounds ``t0 .. t0 + len(keys)``.  Every
    ``checkpoint_every`` rounds the carry and the outputs so far are written
    to ``checkpoint_dir/engine_ckpt.npz`` (atomically, the reference's
    layout); with ``resume=True`` the run continues from that file, which
    may also have been written by the JAX engine.  A resumed run is bitwise
    the uninterrupted one.  ``stop_after_step`` simulates an interruption:
    the driver returns ``None`` after the first segment boundary at or past
    it.  Returns the outs dict (with the final ``params``) when the run
    completes.
    """
    steps = keys.shape[0]
    every = max(int(checkpoint_every), 1)
    path = os.path.join(checkpoint_dir, "engine_ckpt.npz")
    carry = ce.carry0() if hasattr(ce, "carry0") else ce._carry0()
    t0 = 0
    chunks: List[Dict[str, Any]] = []
    if resume and os.path.exists(path):
        loaded, t0 = load_checkpoint(path, device=keys.device)
        carry = _restore_carry(carry, loaded["carry"])
        if t0 > 0:
            chunks = [loaded["outs"]]
    while t0 < steps:
        n = min(every, steps - t0)
        carry, outs = ce.run_segment(overrides, keys[t0:t0 + n], mask, carry,
                                     t0)
        chunks.append(outs)
        t0 += n
        save_checkpoint(path, {"carry": carry, "outs": _concat_outs(chunks)},
                        step=t0)
        if (stop_after_step is not None and t0 >= stop_after_step
                and t0 < steps):
            return None
    outs = _concat_outs(chunks)
    outs["params"] = carry[0]
    return outs


def _subsample(outs, exp: Experiment) -> EngineRun:
    """The eval points of a run's outputs, brought to the host in one
    transfer (every per-round scalar stacked into one table first)."""
    idx = eval_indices(exp.steps, exp.eval_every)
    names = list(outs["metrics"])
    table = torch.stack([outs["acc"], outs["loss"],
                         *(outs["metrics"][k] for k in names)],
                        dim=1).cpu().numpy()
    accs, losses = table[:, 0], table[:, 1]
    return EngineRun(
        accs=[float(accs[i]) for i in idx],
        losses=[float(losses[i]) for i in idx],
        metrics=[{k: float(table[i, 2 + j]) for j, k in enumerate(names)}
                 for i in idx],
        eval_steps=idx, all_accs=accs.copy(), all_losses=losses.copy(),
        params=outs.get("params"))


def run_compiled(x_dev: np.ndarray, y_dev: np.ndarray, x_test: np.ndarray,
                 y_test: np.ndarray, cfg: OTAConfig, steps: int,
                 lr: float = 1e-3, eval_every: int = 10, seed: int = 0,
                 optimizer: str = "adam", local_steps: int = 1,
                 local_lr: float = 0.1, momentum_correction: float = 0.0,
                 use_kernel: bool = False, guard=None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0, resume: bool = False,
                 stop_after_step=None, device=None) -> Optional[EngineRun]:
    """The engine's replacement for ``run_federated``: same model, same
    schedule, one loop with no host round trip.  At ``seed=0`` the
    per-round key stream is ``run_federated``'s (``PRNGKey(1000 + t)``), so
    ``accs`` / ``losses`` / ``metrics`` match ``FederatedRun``'s lists entry
    for entry.  Nonzero ``seed`` shifts the stream to a disjoint key range.

    ``device=None`` runs on the card and raises ``RuntimeError`` without
    one.  ``checkpoint_dir`` + ``checkpoint_every`` switch to
    :func:`run_checkpointed`; with ``resume=True`` an interrupted run
    continues from its snapshot, bitwise the uninterrupted run.  Returns
    ``None`` when ``stop_after_step`` interrupts the run.  ``guard`` is not
    ported yet and raises.
    """
    exp = Experiment(cfg=cfg, steps=steps, lr=lr, eval_every=eval_every,
                     optimizer=optimizer, local_steps=local_steps,
                     local_lr=local_lr,
                     momentum_correction=momentum_correction, seed=seed,
                     use_kernel=use_kernel, guard=guard)
    ce = CompiledExperiment(x_dev, y_dev, x_test, y_test, exp, device=device)
    keys = round_keys(steps, seed, ce.device)
    if checkpoint_dir is not None and checkpoint_every > 0:
        outs = run_checkpointed(ce, {}, keys, checkpoint_dir=checkpoint_dir,
                                checkpoint_every=checkpoint_every,
                                resume=resume,
                                stop_after_step=stop_after_step)
        if outs is None:
            return None
    else:
        outs = ce.run({}, keys)
    return _subsample(outs, exp)
