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

:meth:`CompiledExperiment.run_grid` is the port's counterpart of the
reference's ``jax.jit(jax.vmap(ce.run))``: G grid points, each with its own
schedules, round keys and device mask, run as one batched round per step.
The carry gains a leading point axis (params, Adam moments, ``(G, M, d)``
error states and momenta); the RNG draws, the sparsifier, the projection
and the fused AMP decode run once for all points, and what is shared by
construction stays shared: the round index, the mean-removal switch and
the digital schemes' static ``q_max``.  ``torch.func.vmap`` cannot trace
the kernels' ``ctypes`` launches, so the batch is written out.  Each point
equals its own run (:mod:`repro_torch.experiments.sweep` builds the grids).

Ported: every scheme of :mod:`repro_torch.core.schemes` with the channel
and robustness axes, the schedule overrides ``p_sched`` and ``q_sched``,
the six channel scalars and the seven robustness scalars as overrides
(0-dim for a run, ``(G,)`` for a grid), the subband scheduler with its
carried state, fault injection, robust aggregation and the transmit power
cap in :func:`round_masked`, the round guardrails
(:mod:`repro_torch.robust.guards`) with their state in the carry, the
local-compute axis (:mod:`repro_torch.local`: FedAvg-E, FedProx, FedDyn
with its duals in the carry, and the three knobs as overrides), and the
``mac`` hook of :func:`round_masked` through which the population engine's
hierarchical sites sum (:mod:`repro_torch.population`).
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
from repro_torch.core import channel, scheduling
from repro_torch.core.schemes import (
    CHANNEL_SCALARS, ROBUST_SCALARS, MACContext, Scheme, apply_channel_gain,
    get_scheme, round_sigma2, round_simulated,
)
from repro_torch.device import resolve_device
from repro_torch.local.work import (
    LOCAL_OVERRIDE_ATTRS, LocalWork, get_local, local_device_grads,
)
from repro_torch.optim.optim import Optimizer
from repro_torch.robust import aggregators, faults, guards
from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.train.paper_repro import (
    accuracy, ce_loss, device_grads, flat_grad_fn, init_linear,
)

#: base of the per-round key stream; round t of seed 0 uses PRNGKey(1000 + t),
#: matching run_federated exactly (seed k shifts the stream by k * steps so
#: seed replicas draw disjoint keys)
KEY_STREAM_BASE = 1000

#: the channel-model scalars (fading, CSI error, geometry, scheduling) and
#: the robustness scalars (fault rates, attack magnitude, defences), one
#: float32 each on the scheme
CHANNEL_OVERRIDE_ATTRS = CHANNEL_SCALARS
ROBUST_OVERRIDE_ATTRS = ROBUST_SCALARS
SCALAR_OVERRIDE_ATTRS = CHANNEL_OVERRIDE_ATTRS + ROBUST_OVERRIDE_ATTRS
#: the scheme overrides a run accepts: the per-point schedules of the
#: sweeps and the scheme's scalars (the local-compute knobs,
#: ``LOCAL_OVERRIDE_ATTRS``, land on the run's LocalWork)
OVERRIDE_ATTRS = ("p_sched", "q_sched") + SCALAR_OVERRIDE_ATTRS


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
    guard: Optional[guards.GuardConfig] = None   # round guardrails


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
    bitwise.  ``dev_keys`` (M_pad, 2), ``draw`` and ``fault`` replace the
    key split, the channel draw and the fault draw, as in the reference;
    the channel draw sees the mask, so the blind PS combiner excludes
    devices that do not exist.  ``sched`` (M_pad,) bool is the subband
    scheduler's transmit set: an unscheduled device is silenced like a
    deep-faded one and banks its whole update.  ``mac``, a callable
    ``(frames, mac_key, sigma2) -> y``, replaces the flat analog MAC sum
    (the population engine's hierarchical edge sites).

    Fault injection (:mod:`repro_torch.robust`) runs when the static
    ``scheme.robust_on`` is set, in the reference's order: Byzantine and
    stale gradients change before encode (silent devices bank their *true*
    gradients); on the analog path Byzantine frames are amplified by
    ``byz_scale``, dropouts leave the transmit set, ``cfg.clip_power`` caps
    every frame at ``power_cap * P_t`` and NaN/Inf poisoning hits the frame
    after the cap; on the digital path the frame is poisoned, a dropout
    banks its update, erased and dropped frames leave the combine, and
    ``cfg.aggregator`` other than ``"mean"`` takes the robust combine.  The
    defences gate on their static config fields, with or without faults.

    G points at once: grads/deltas (G, M_pad, d), one key per point (G, 2)
    and one mask per point (G, M_pad); each point decodes against its own
    ``m_eff``.
    """
    cfg = scheme.cfg
    m_pad = grads.shape[-2]
    mask_b = mask > 0
    # the max guard only engages when every device is masked out
    m_eff = torch.clamp(mask.to(torch.float32).sum(-1), min=1.0)
    ctx = dataclasses.replace(ctx, m=m_eff)
    if dev_keys is None:
        dev_keys = rng.split(rng.fold_in(key, 1), m_pad)
    if draw is None:
        draw = scheme.channel_draw(rng.fold_in(key, 2), step, m_pad,
                                   mask=mask_b)
    if sched is not None:
        # the scheduler's transmit set composes like a deep fade
        draw = draw._replace(active=draw.active & sched)
    robust = scheme.robust_on
    true_grads = grads
    if robust:
        if fault is None:
            fault = scheme.fault_draw(rng.fold_in(key, faults.SALT_FAULT),
                                      step, m_pad)
        grads = faults.apply_gradient_faults(
            grads, fault, byz_attack=cfg.byz_attack,
            byz_scale=scheme.byz_scale)
    active = draw.active
    frames, new_deltas, metrics = scheme.encode(
        grads, deltas, step, dev_keys, ctx.with_p_factor(draw.p_factor))
    if scheme.analog:
        if robust:
            # an analog attacker's leverage is transmit power: its frame
            # breaks the power constraint by byz_scale in amplitude
            byz_amp = torch.where(fault.byz, scheme.byz_scale[..., None],
                                  1.0)
            frames = frames * byz_amp[..., None]
            active = active & ~fault.dropout
        if cfg.clip_power:
            # the transmit-side hardware cap bounds every device's power
            p_t = scheme.p_t(step)      # 0-dim, or (G, 1) for G points
            if p_t.dim():
                p_max = (scheme.power_cap[..., None] * p_t)[..., 0]
            else:
                p_max = scheme.power_cap * p_t
            frames = aggregators.clip_frame_power(frames, p_max)
        if robust:
            # after the cap: a power limiter cannot repair a broken DAC
            frames = faults.apply_frame_faults(frames, fault)
        new_deltas = torch.where(active[..., None], new_deltas,
                                 scheme.silent_state(true_grads, deltas,
                                                     new_deltas))
        active = active & mask_b
        frames = apply_channel_gain(frames, draw._replace(active=active))
        mac_key = rng.fold_in(key, 0)
        sigma2 = round_sigma2(scheme, draw)
        y = (channel.mac_sum(frames, mac_key, sigma2) if mac is None
             else mac(frames, mac_key, sigma2))
    else:
        if robust:
            # a dropout knows it failed and banks its whole update; erased
            # and poisoned packets are lost or garbled in the channel and
            # their unaware device's state evolves as if sent
            frames = faults.apply_frame_faults(frames, fault)
            new_deltas = torch.where(
                fault.dropout[..., None],
                scheme.silent_state(true_grads, deltas, new_deltas),
                new_deltas)
            active = active & ~fault.dropout & ~fault.erased
        if sched is not None:
            # an unscheduled digital device knows it was not granted a
            # subband and banks its whole update
            new_deltas = torch.where(
                sched[..., None], new_deltas,
                scheme.silent_state(true_grads, deltas, new_deltas))
        active = active & mask_b
        if cfg.aggregator != "mean":
            y = aggregators.robust_combine(
                frames, active, m_eff, aggregator=cfg.aggregator,
                trim_frac=scheme.trim_frac, norm_cap=scheme.norm_cap)
        else:
            # the literal sum: a sorted sum re-associates
            keep = active if (robust or sched is not None) else mask_b
            y = (frames * keep[..., None]).sum(dim=-2)
    # padded devices do not exist: their error state must not evolve
    new_deltas = torch.where(mask_b[..., None], new_deltas, deltas)
    ghat = scheme.decode(y, step, ctx)
    w = mask.to(torch.float32)
    metrics = {k: (v * w).sum(dim=-1) / m_eff for k, v in metrics.items()}

    def frac(b):
        return b.to(torch.float32).expand(w.shape).sum(dim=-1) / m_eff
    metrics["active_frac"] = frac(active)
    if robust:
        faulty = fault.poison | fault.stale | fault.dropout | fault.erased
        metrics["byz_frac"] = frac(fault.byz & mask_b)
        metrics["fault_frac"] = frac(faulty & mask_b)
    return ghat, new_deltas, metrics


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------


def apply_overrides(scheme: Scheme, localwork: LocalWork,
                    overrides: Dict[str, Any], device):
    """``(scheme, localwork)`` with a run's overrides swapped on: schedules
    and the channel and robustness scalars onto the scheme, the
    local-compute knobs onto the local work, each scalar as a float32
    tensor on ``device``."""
    sch_ov, lw_ov = {}, {}
    for name, value in overrides.items():
        if name in LOCAL_OVERRIDE_ATTRS:
            lw_ov[name] = value
        elif name not in OVERRIDE_ATTRS:
            raise AttributeError(
                f"scheme {scheme.name!r} has no attribute {name!r} to "
                "override")
        elif name in SCALAR_OVERRIDE_ATTRS:
            sch_ov[name] = torch.as_tensor(value, dtype=torch.float32,
                                           device=device)
        else:
            sch_ov[name] = value
    return (scheme.with_overrides(**sch_ov) if sch_ov else scheme,
            localwork.with_overrides(**lw_ov) if lw_ov else localwork)


def _stack_outs(outs: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-round output dicts -> one dict of (rounds,) device tensors, key
    for key (any runner's outs: the engine's, the streamed LLM round's)."""
    return {k: (_stack_outs([o[k] for o in outs]) if isinstance(v, dict)
                else torch.stack([o[k] for o in outs]))
            for k, v in outs[0].items()}


def _concat_outs(chunks: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Concatenate per-segment outputs along the round axis, key for key
    (any runner's outs: the engine's, the streamed LLM round's)."""
    return {k: (_concat_outs([c[k] for c in chunks]) if isinstance(v, dict)
                else torch.cat([c[k] for c in chunks]))
            for k, v in chunks[0].items()}


class CompiledExperiment:
    """Runner for one static configuration, on one device.

    :meth:`run_segment` is the segment contract the checkpoint driver
    needs: rounds ``t0 .. t0 + len(keys)`` from an explicit carry
    ``(params, opt_state, deltas, momenta)``, followed by FedDyn's ``(M,
    d)`` duals when the local algorithm carries them, by prop_fair's
    ``(M,)`` scheduler state when the configuration schedules with it, and
    by a :class:`~repro_torch.robust.guards.GuardState` when ``exp.guard``
    is set (the reference's carry).  ``overrides`` swaps schedules
    (``p_sched`` (T,), ``q_sched`` (T,)) and 0-dim channel and robustness
    scalars onto the scheme through :meth:`Scheme.with_overrides`, and the
    local-compute knobs (``LOCAL_OVERRIDE_ATTRS``) onto the run's
    :class:`~repro_torch.local.work.LocalWork`.  :meth:`run_grid` runs G
    points, each with its own ``(T,)`` schedules, scalars, keys and mask,
    as one batched round per step.

    A robust scheme (``scheme.robust_on``) takes :func:`round_masked` with
    an all-ones mask, as in the reference; a guard adds the columns
    ``guard_lr_scale``, ``guard_skipped`` and ``guard_backoff`` to the
    per-round metrics.
    """

    def __init__(self, x_dev: np.ndarray, y_dev: np.ndarray,
                 x_test: np.ndarray, y_test: np.ndarray, exp: Experiment,
                 device=None):
        cfg = exp.cfg
        self.device = resolve_device(device)
        m, _, dim = x_dev.shape
        self.exp = exp
        self.m = m
        n_classes = int(np.max(y_dev)) + 1
        self.params0 = init_linear(dim, n_classes, self.device)
        self.d = ravel(self.params0).shape[0]
        self.scheme = get_scheme(cfg, self.d, m, device=self.device)
        self.localwork = get_local(cfg, exp.local_lr, device=self.device)
        if not self.localwork.identity and exp.local_steps > 1:
            raise ValueError(
                "local_steps > 1 (the legacy FedAvg path) conflicts with "
                f"the configured local algorithm {cfg.local!r} at "
                f"local_epochs={cfg.local_epochs}; use cfg.local_epochs")
        self._grad_fn = flat_grad_fn(self.params0)
        # "none" resolves to None: no scheduling op runs
        self.scheduler = scheduling.get_scheduler(cfg)
        self.opt = Optimizer(name=exp.optimizer, lr=exp.lr)
        dev = self.device
        self.xd = torch.as_tensor(x_dev, dtype=torch.float32, device=dev)
        self.yd = torch.as_tensor(y_dev, device=dev).long()
        self.xt = torch.as_tensor(x_test, dtype=torch.float32, device=dev)
        self.yt = torch.as_tensor(y_test, device=dev).long()
        self.ctx = MACContext(m=m, use_kernel=exp.use_kernel or cfg.use_kernel)

    # ------------------------------------------------------------- pieces
    @property
    def _sched_state(self) -> bool:
        """Whether a scheduler state vector rides the carry (after the
        duals, before the guard state)."""
        return self.scheduler is not None and self.scheduler.has_state

    def _carry(self, points=None):
        """The initial carry, with a leading point axis on every leaf for
        ``points`` (the optimizer's step count is shared by all points
        unless a guard may skip one point's step)."""
        if points is None:
            params = self.params0
        else:
            params = {k: v.expand(points, *v.shape).clone()
                      for k, v in self.params0.items()}
        lead = () if points is None else (points,)
        zeros = torch.zeros((*lead, self.m, self.d), dtype=torch.float32,
                            device=self.device)
        opt_state = self.opt.init(params)
        if points is not None and self.exp.guard is not None:
            opt_state["count"] = opt_state["count"].expand(points).clone()
        carry = (params, opt_state, zeros, zeros.clone())
        if self.localwork.has_dual:
            carry = carry + (self.localwork.init_dual(self.m, self.d,
                                                      points),)
        if self._sched_state:
            sstate = self.scheduler.init_state(self.m, self.device)
            if points is not None:
                sstate = sstate.expand(points, self.m).clone()
            carry = carry + (sstate,)
        if self.exp.guard is not None:
            carry = carry + (guards.init_guard_state(points, self.device),)
        return carry

    def carry0(self):
        return self._carry()

    #: the reference's name for :meth:`carry0`
    _carry0 = carry0

    def _round(self, sch: Scheme, lw: LocalWork, carry, t: int,
               key: torch.Tensor, mask):
        """One round of one point, or of G points when the carry, ``key``
        (G, 2), ``mask`` (G, M_pad) and the overrides carry a leading point
        axis: the same code either way."""
        exp = self.exp
        params, opt_state, deltas, momenta = carry[:4]
        duals = carry[4] if lw.has_dual else None
        sstate = carry[4 + lw.has_dual] if self._sched_state else None
        gstate = carry[-1] if exp.guard is not None else None
        old_extras = ((deltas, momenta) + ((duals,) if lw.has_dual else ())
                      + ((sstate,) if self._sched_state else ()))
        if lw.identity:
            grads, momenta = device_grads(
                params, self.xd, self.yd, momenta,
                local_steps=exp.local_steps, local_lr=exp.local_lr,
                momentum_correction=exp.momentum_correction)
        else:
            grads, momenta, new_duals = local_device_grads(
                lw, self._grad_fn, params, self.xd, self.yd, momenta,
                duals, momentum_correction=exp.momentum_correction)
            if lw.has_dual:
                # a padded device's dual must not evolve
                duals = (new_duals if mask is None else torch.where(
                    (mask > 0)[..., None], new_duals, duals))
        if self.scheduler is not None:
            # the scheduler ranks on this round's received-power factors, so
            # the channel draw is made here, the one round_masked would make
            # (same salt, same mask), and passed on with the transmit set
            rmask = (mask if mask is not None else torch.ones(
                (*key.shape[:-1], self.m), dtype=torch.float32,
                device=self.device))
            rmask_b = rmask > 0
            draw = sch.channel_draw(rng.fold_in(key, 2), t, self.m,
                                    mask=rmask_b)
            sched, new_sstate = scheduling.schedule(
                self.scheduler, rng.fold_in(key, scheduling.SALT_SCHED), t,
                draw.p_factor, sch.n_subbands, state=sstate, mask=rmask_b)
            if self._sched_state:
                # a padded device's scheduler state must not evolve
                sstate = (new_sstate if mask is None else
                          torch.where(rmask_b, new_sstate, sstate))
            ghat, deltas, met = round_masked(sch, grads, deltas, t, key,
                                             rmask, self.ctx, draw=draw,
                                             sched=sched)
        elif mask is None and not sch.robust_on:
            ghat, deltas, met = round_simulated(sch, grads, deltas, t, key,
                                                self.ctx)
        else:
            # the fault path lives in round_masked; an all-ones mask is
            # bitwise round_simulated
            rmask = (mask if mask is not None else torch.ones(
                (*key.shape[:-1], self.m), dtype=torch.float32,
                device=self.device))
            ghat, deltas, met = round_masked(sch, grads, deltas, t, key,
                                             rmask, self.ctx)
        extras = ((deltas, momenta) + ((duals,) if lw.has_dual else ())
                  + ((sstate,) if self._sched_state else ()))
        if gstate is None:
            params, opt_state = self.opt.apply(
                params, unravel(ghat, params, batch_dims=ghat.dim() - 1),
                opt_state)
            out = {"acc": accuracy(params, self.xt, self.yt),
                   "loss": ce_loss(params, self.xt, self.yt),
                   "metrics": met}
            return (params, opt_state) + extras, out
        # a skipped or reverted round restores the pre-round extras whole
        params, opt_state, extras, gstate, loss, gmet = guards.guarded_step(
            exp.guard, gstate, self.opt, params, opt_state, ghat,
            lambda v: unravel(v, params, batch_dims=v.dim() - 1),
            extras=extras, old_extras=old_extras,
            loss_fn=lambda p: ce_loss(p, self.xt, self.yt))
        out = {"acc": accuracy(params, self.xt, self.yt), "loss": loss,
               "metrics": {**met, **gmet}}
        return (params, opt_state) + extras + (gstate,), out

    # ---------------------------------------------------------- entry
    def run_segment(self, overrides: Dict[str, Any], keys: torch.Tensor,
                    mask, carry, t0: int):
        """Rounds ``t0 .. t0 + len(keys)`` from an explicit carry.

        A full run is the composition of its segments (a round is a pure
        function of ``(carry, t, key)``), so splitting a run at any boundary
        and resuming from the saved carry reproduces it bitwise.  Returns
        ``(carry, outs)`` with outs of ``(len(keys),)`` device tensors.
        ``overrides`` swaps ``(T,)`` schedules and 0-dim scalars onto the
        scheme and the local work, as the reference's ``run_segment`` does.
        """
        sch, lw = apply_overrides(self.scheme, self.localwork, overrides,
                                  self.device)
        outs = []
        for i in range(keys.shape[0]):
            carry, out = self._round(sch, lw, carry, int(t0) + i, keys[i],
                                     mask)
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

    def carry0_grid(self, points: int):
        """:meth:`carry0` for G points: every leaf with a leading point
        axis, except the optimizer's step count, which all points share
        unless a guard may skip one point's step (then one per point, as
        the guard state)."""
        return self._carry(points)

    def run_grid(self, overrides: Dict[str, Any], keys: torch.Tensor,
                 masks: Optional[torch.Tensor] = None):
        """G runs of this configuration as one batched round per step: the
        counterpart of the reference's ``jax.jit(jax.vmap(ce.run))``.

        ``overrides`` holds ``(G, T)`` schedules (``p_sched``, and
        ``q_sched`` for the digital schemes, whose static ``q_max`` the
        caller sets to cover the grid), ``(G,)`` channel and robustness
        scalars and ``(G,)`` local-compute knobs (a ``local_epochs`` grid
        needs ``localwork.max_epochs`` at its maximum), ``keys`` is
        ``(G, T, 2)`` and ``masks`` an optional ``(G, M_pad)``.  Each point
        equals its own :meth:`run` (or :meth:`run_masked`) with its own
        schedules, keys and mask.  Returns ``{"acc": (G, T), "loss": (G,
        T), "metrics": {...: (G, T)}, "params": dict of (G, ...)}``, on
        the device.
        """
        points, steps = keys.shape[:2]
        for name, v in overrides.items():
            if v.shape[0] != points:
                raise ValueError(f"run_grid: override {name!r} has "
                                 f"{v.shape[0]} points, keys {points}")
        sch, lw = apply_overrides(self.scheme, self.localwork, overrides,
                                  self.device)
        carry = self.carry0_grid(points)
        outs = []
        for t in range(steps):
            carry, out = self._round(sch, lw, carry, t, keys[:, t], masks)
            outs.append(out)
        outs = _stack_outs(outs)
        grid = {"acc": outs["acc"].T, "loss": outs["loss"].T,
                "metrics": {k: v.T for k, v in outs["metrics"].items()}}
        grid["params"] = carry[0]
        return grid


def _restore_carry(ref_carry, loaded):
    """Rebuild a checkpointed carry against the engine's own carry.

    The structure (dict keys, tuple lengths), shapes and dtypes must match;
    each leaf moves to the device of its counterpart in ``ref_carry``.  The
    npz layout keeps no class, so a NamedTuple (the guard state) is rebuilt
    from the template's.
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
        items = [_restore_carry(r, v) for r, v in zip(ref_carry, loaded)]
        return (type(ref_carry)(*items) if hasattr(ref_carry, "_fields")
                else type(ref_carry)(items))
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
                 use_kernel: bool = False,
                 guard: Optional[guards.GuardConfig] = None,
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
    ``None`` when ``stop_after_step`` interrupts the run.  ``guard`` (a
    :class:`~repro_torch.robust.guards.GuardConfig`) turns on the round
    guardrails.
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
