"""Sampled-cohort round engine: federated runs over M-large populations.

The port of the reference's ``repro/population/engine.py``.  One round =
draw availability -> sample a K-cohort -> gather the banked error state and
the cohort's data -> run the scheme's encode, MAC and decode on the K rows
(:func:`repro_torch.experiments.engine.round_masked` with the cohort's
device keys and channel draw) -> scatter the updated accumulators back.
The carry is ``(params, opt_state, banks)``, then FedDyn's banked duals,
prop_fair's banked state and the guard's state where configured; a round's
temporaries are O(K * d) plus O(M) scalars (keys, scores, masks), never
O(M * d).

RNG layout: round t of seed 0 uses ``PRNGKey(1000 + t)``, salted per
consumer: 0 MAC AWGN, 1 device encode, 2 channel draw (as the dense
engine), 3 availability, 4 cohort sampling, 5 straggler latency, 6 the
fault trace.  Device m's encode key is row m of ``split(fold_in(key, 1),
M)`` and its channel row comes from the full-M draw
(:meth:`Scheme.cohort_channel_draw`), so a K == M cohort with no churn or
stragglers reproduces ``run_compiled`` bitwise.  Each draw from one key is
far below ``rng``'s 2**32 limit: at M = 100 000 the largest is the
M-row key split and the M-entry Gumbel and availability draws.

The per-round knobs (``avail_rate``, ``straggler_deadline``, ``k_active``,
``site_noise_scale``, ``backhaul_sigma2``) are float32 tensors on
:class:`CompiledPopulation`, swapped by :meth:`CompiledPopulation.
with_overrides`; :meth:`CompiledPopulation.run_grid` runs G points (each
with its own cohort and its own banks) as one batched round per step,
which is how :func:`repro_torch.experiments.sweep.run_population_sweep`
runs its grids.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import rng
from repro_torch.configs.base import OTAConfig
from repro_torch.convert import ravel, unravel
from repro_torch.core import scheduling
from repro_torch.core.schemes import MACContext, Scheme, get_scheme
from repro_torch.data.partition import PopulationPartition
from repro_torch.device import lead, resolve_device, take
from repro_torch.experiments.engine import (
    EngineRun, _stack_outs, _subsample, apply_overrides, round_keys,
    round_masked, run_checkpointed,
)
from repro_torch.local.work import LocalWork, get_local, local_device_grads
from repro_torch.optim.optim import Optimizer
from repro_torch.population import churn, stragglers
from repro_torch.population.hierarchy import site_mac_sum
from repro_torch.population.sampler import sample_cohort
from repro_torch.population.state import (
    BankedState, PopulationConfig, gather_cohort, init_banks,
    init_population, scatter_cohort,
)
from repro_torch.robust import faults, guards
from repro_torch.train.paper_repro import (
    accuracy, ce_loss, device_grads, flat_grad_fn, init_linear,
)

#: round-key salts owned by the population layer (0/1/2 belong to the MAC,
#: encode and channel-draw consumers, as in round_simulated)
SALT_AVAIL, SALT_SAMPLE, SALT_LATENCY = 3, 4, 5

#: CompiledPopulation attributes that ride the batched override path
POP_OVERRIDE_ATTRS = (
    "avail_rate",
    "straggler_deadline",
    "k_active",
    "site_noise_scale",
    "backhaul_sigma2",
)


class PopulationData:
    """Training data addressable by cohort, on one device.

    Two layouts behind one :meth:`cohort_batch` view: dense per-device
    tensors ``(M, B, dim)`` (small M, the parity tests' layout), or a sample
    pool ``(N, dim)`` with a :class:`~repro_torch.data.partition.
    PopulationPartition` whose shard arithmetic gives only the cohort's
    ``(K, B)`` rows each round (large M: nothing (M, B)-sized exists).
    ``device=None`` is the card.
    """

    def __init__(self, m, b, dim, n_classes, *, xd=None, yd=None, x=None,
                 y=None, part: Optional[PopulationPartition] = None):
        self.m, self.b, self.dim, self.n_classes = m, b, dim, n_classes
        self.xd, self.yd = xd, yd
        self.x, self.y, self.part = x, y, part

    @classmethod
    def from_dense(cls, x_dev, y_dev, device=None) -> "PopulationData":
        dev = resolve_device(device)
        m, b, dim = x_dev.shape
        return cls(m, b, dim, int(np.max(np.asarray(y_dev))) + 1,
                   xd=torch.as_tensor(x_dev, dtype=torch.float32, device=dev),
                   yd=torch.as_tensor(y_dev, device=dev).long())

    @classmethod
    def from_pool(cls, x, y, part: PopulationPartition,
                  device=None) -> "PopulationData":
        if len(y) != part.n:
            raise ValueError(
                f"pool has {len(y)} samples, partition expects {part.n}")
        dev = resolve_device(device)
        return cls(part.m, part.b, x.shape[-1], int(np.max(np.asarray(y))) + 1,
                   x=torch.as_tensor(x, dtype=torch.float32, device=dev),
                   y=torch.as_tensor(y, device=dev).long(), part=part)

    @property
    def device(self) -> torch.device:
        return (self.xd if self.xd is not None else self.x).device

    def cohort_batch(self, cohort: torch.Tensor):
        """(K, B, dim), (K, B) batches of the cohort's devices; ``(G, K, B,
        dim)`` for a ``(G, K)`` cohort."""
        if self.xd is not None:
            return self.xd[cohort], self.yd[cohort]
        idx = self.part.sample_indices(cohort)
        return self.x[idx], self.y[idx]


def population_round(scheme: Scheme, banks: BankedState, cohort: torch.Tensor,
                     mask: torch.Tensor, grads: torch.Tensor, step,
                     key: torch.Tensor, ctx: MACContext, m_total: int, *,
                     gains=None, sites=None, n_sites: int = 1,
                     site_noise_scale=1.0, backhaul_sigma2=0.0,
                     site_trim_frac: float = 0.0, draw=None, sched=None):
    """One sampled-cohort aggregation round.

    ``cohort`` (K,) sorted device ids; ``mask`` (K,) 0/1 participation
    (churn, stragglers and ``k_active`` folded in); ``grads`` (K, d).
    ``gains`` / ``sites`` are the cohort's rows of the population's
    large-scale gains and edge sites.  A leading point axis on everything
    (``(G, K)`` cohorts, ``(G, 2)`` keys, banks per point) runs G points.
    Returns ``(ghat, new_banks, metrics)``.

    The round is :func:`round_masked` with the cohort's injections: device
    keys are the cohort's rows of the full-M key split, the channel draw
    the cohort's rows of the full-M realisation times ``gains``, and for
    ``n_sites > 1`` the MAC the two-stage site sum.  At K == M with the
    defaults every injection is the dense driver's, bitwise.  ``draw`` /
    ``sched`` given (the runner's scheduler) replace the channel draw, which
    must then carry ``gains`` already.
    """
    deltas = gather_cohort(banks, cohort)
    dev_keys = take(rng.split(rng.fold_in(key, 1), m_total), cohort,
                    key.dim() - 1)
    if draw is None:
        draw = scheme.cohort_channel_draw(rng.fold_in(key, 2), step, cohort,
                                          m_total, mask=mask > 0)
        if gains is not None:
            draw = draw._replace(p_factor=draw.p_factor * gains)
    fault = None
    if scheme.robust_on:
        # the cohort's rows of the full-population fault trace
        fault = scheme.cohort_fault_draw(
            rng.fold_in(key, faults.SALT_FAULT), step, cohort, m_total)
    mac = None
    if n_sites > 1:
        if sites is None:
            raise ValueError("n_sites > 1 needs the cohort's site ids")

        def mac(frames, mac_key, sigma2):
            return site_mac_sum(frames, sites, n_sites, mac_key, sigma2,
                                site_noise_scale=site_noise_scale,
                                backhaul_sigma2=backhaul_sigma2,
                                site_trim_frac=site_trim_frac)

    ghat, new_deltas, metrics = round_masked(scheme, grads, deltas, step,
                                             key, mask, ctx,
                                             dev_keys=dev_keys, draw=draw,
                                             mac=mac, fault=fault,
                                             sched=sched)
    banks = scatter_cohort(banks, cohort, new_deltas)
    # jnp.sum(mask) / K: a division by a constant, the product with its
    # float32 reciprocal under jit
    k = cohort.shape[-1]
    metrics["cohort_frac"] = mask.sum(-1) * float(np.float32(1.0)
                                                  / np.float32(k))
    return ghat, banks, metrics


@dataclass(frozen=True)
class PopulationExperiment:
    """Static description of one population training configuration."""
    cfg: OTAConfig
    pop: PopulationConfig
    steps: int
    lr: float = 1e-3
    eval_every: int = 10
    optimizer: str = "adam"
    local_steps: int = 1
    local_lr: float = 0.1
    seed: int = 0
    use_kernel: bool = False
    guard: Optional[guards.GuardConfig] = None


class CompiledPopulation:
    """Runner for one population configuration, on one device.

    :meth:`run_segment` is the checkpoint driver's segment contract (as
    :class:`~repro_torch.experiments.engine.CompiledExperiment`'s).
    ``overrides`` splits between the runner's own knobs
    (``POP_OVERRIDE_ATTRS``, via :meth:`with_overrides`), the local work's
    and the scheme's (schedules, channel and robustness scalars).
    """

    def __init__(self, data: PopulationData, x_test, y_test,
                 exp: PopulationExperiment, device=None):
        pop = exp.pop
        if data.m != pop.m_total:
            raise ValueError(
                f"data addresses {data.m} devices, population has "
                f"{pop.m_total}")
        # the device as a tensor on it names it ("cuda" names "cuda:0")
        self.device = torch.empty(0, device=resolve_device(device)).device
        if data.device != self.device:
            raise ValueError(f"data lives on {data.device}, the run on "
                             f"{self.device}")
        self.exp = exp
        self.data = data
        self.params0 = init_linear(data.dim, data.n_classes, self.device)
        self.d = ravel(self.params0).shape[0]
        self.scheme = get_scheme(exp.cfg, self.d, pop.k_cohort,
                                 device=self.device)
        self.localwork = get_local(exp.cfg, exp.local_lr, device=self.device)
        if not self.localwork.identity and exp.local_steps > 1:
            raise ValueError(
                "local_steps > 1 (the legacy FedAvg path) conflicts with "
                f"the configured local algorithm {exp.cfg.local!r} at "
                f"local_epochs={exp.cfg.local_epochs}; use cfg.local_epochs")
        self._grad_fn = flat_grad_fn(self.params0)
        self.opt = Optimizer(name=exp.optimizer, lr=exp.lr)
        self.xt = torch.as_tensor(x_test, dtype=torch.float32,
                                  device=self.device)
        self.yt = torch.as_tensor(y_test, device=self.device).long()
        self.ctx = MACContext(m=pop.k_cohort,
                              use_kernel=exp.use_kernel or exp.cfg.use_kernel)
        self.pstate0 = init_population(
            pop, self.d, exp.steps, dtype=getattr(torch, exp.cfg.state_dtype),
            device=self.device)
        # FedDyn's duals and prop_fair's average rates are per-device state,
        # banked like the error accumulators: a cold slot reads 0, which is
        # each one's fresh-device value, so eviction degrades a device to
        # fresh, never to wrong.  The duals stay float32 whatever the
        # state dtype.
        cap = pop.capacity if pop.capacity else pop.m_total
        self._bank_shape = (cap, min(pop.bank_size, cap))
        self.scheduler = scheduling.get_scheduler(exp.cfg)
        self.dual_banks0 = (self._side_banks(self.d)
                            if self.localwork.has_dual else None)
        self.sched_banks0 = (self._side_banks(1) if self._sched_state
                             else None)
        # per-round knobs, batched by with_overrides
        for name, v in (("avail_rate", pop.avail_rate),
                        ("straggler_deadline", pop.straggler_deadline),
                        ("k_active", pop.k_cohort),
                        ("site_noise_scale", pop.site_noise_scale),
                        ("backhaul_sigma2", pop.backhaul_sigma2)):
            setattr(self, name, torch.tensor(np.float32(v),
                                             device=self.device))

    def _side_banks(self, d: int, points=None) -> BankedState:
        return init_banks(*self._bank_shape, d, torch.float32, self.device,
                          points)

    def with_overrides(self, **attrs) -> "CompiledPopulation":
        """Shallow copy with the per-round knobs replaced (the sweep hook),
        each as a float32 tensor on the run's device."""
        new = copy.copy(self)
        for name, value in attrs.items():
            if name not in POP_OVERRIDE_ATTRS:
                raise AttributeError(
                    f"unknown population override {name!r}; traced knobs: "
                    f"{POP_OVERRIDE_ATTRS}")
            setattr(new, name, torch.as_tensor(value, dtype=torch.float32,
                                               device=self.device))
        return new

    # ------------------------------------------------------------- pieces
    @property
    def _sched_state(self) -> bool:
        return self.scheduler is not None and self.scheduler.has_state

    def _carry(self, points=None):
        """The initial carry; every leaf with a leading axis of ``points``
        for a grid (each point keeps its own banks)."""
        if points is None:
            params = self.params0
            banks = self.pstate0.banks
        else:
            params = {k: v.expand(points, *v.shape).clone()
                      for k, v in self.params0.items()}
            banks = BankedState(*(v.expand(points, *v.shape).clone()
                                  for v in self.pstate0.banks))
        opt_state = self.opt.init(params)
        if points is not None and self.exp.guard is not None:
            opt_state["count"] = opt_state["count"].expand(points).clone()
        carry = (params, opt_state, banks)
        if self.localwork.has_dual:
            carry = carry + (self._side_banks(self.d, points),)
        if self._sched_state:
            carry = carry + (self._side_banks(1, points),)
        if self.exp.guard is not None:
            carry = carry + (guards.init_guard_state(points, self.device),)
        return carry

    def carry0(self):
        return self._carry()

    #: the reference's name for :meth:`carry0`
    _carry0 = carry0

    def _grads(self, params, xk, yk):
        exp = self.exp
        return device_grads(params, xk, yk, None,
                            local_steps=exp.local_steps,
                            local_lr=exp.local_lr)[0]

    def _round(self, sch: Scheme, lw: LocalWork, carry, t: int,
               key: torch.Tensor):
        """One round of one point, or of G points when the carry and ``key``
        (G, 2) carry a leading point axis."""
        params, opt_state, banks = carry[:3]
        dual_banks = carry[3] if lw.has_dual else None
        sched_banks = carry[3 + lw.has_dual] if self._sched_state else None
        gstate = carry[-1] if self.exp.guard is not None else None
        old_extras = ((banks,) + ((dual_banks,) if lw.has_dual else ())
                      + ((sched_banks,) if self._sched_state else ()))
        pop, ps = self.exp.pop, self.pstate0
        avail = churn.availability(ps.arrival, ps.departure, t,
                                   rng.fold_in(key, SALT_AVAIL),
                                   self.avail_rate)
        cohort, member, rank = sample_cohort(
            rng.fold_in(key, SALT_SAMPLE), avail, pop.k_cohort)
        lat = stragglers.latencies(rng.fold_in(key, SALT_LATENCY),
                                   take(ps.speed, cohort))
        mask = (member
                & (rank.to(torch.float32) < lead(self.k_active, rank))
                & stragglers.deadline_mask(lat, self.straggler_deadline))
        xk, yk = self.data.cohort_batch(cohort)
        if lw.identity:
            grads = self._grads(params, xk, yk)
        else:
            duals = (gather_cohort(dual_banks, cohort) if lw.has_dual
                     else None)
            grads, _, new_duals = local_device_grads(
                lw, self._grad_fn, params, xk, yk, None, duals)
            if lw.has_dual:
                # a masked-out cohort member did not run this round: its
                # dual keeps its value (the scatter rewrites it, claiming
                # the slot)
                new_duals = torch.where(mask[..., None], new_duals, duals)
                dual_banks = scatter_cohort(dual_banks, cohort, new_duals)
        draw = sched = None
        gains = take(ps.gains, cohort)
        if self.scheduler is not None:
            # the cohort's draw is made here so the scheduler ranks this
            # round's effective gains (the key population_round would use)
            draw = sch.cohort_channel_draw(rng.fold_in(key, 2), t, cohort,
                                           pop.m_total, mask=mask)
            draw = draw._replace(p_factor=draw.p_factor * gains)
            sstate = (gather_cohort(sched_banks, cohort)[..., 0]
                      if self._sched_state else None)
            sched, new_sstate = scheduling.schedule(
                self.scheduler, rng.fold_in(key, scheduling.SALT_SCHED), t,
                draw.p_factor, sch.n_subbands, state=sstate, mask=mask)
            if self._sched_state:
                # masked cohort rows keep their banked average; live but
                # unscheduled rows decay (that decay is proportional
                # fairness)
                new_sstate = torch.where(mask, new_sstate, sstate)
                sched_banks = scatter_cohort(sched_banks, cohort,
                                             new_sstate[..., None])
        ghat, banks, met = population_round(
            sch, banks, cohort, mask.to(torch.float32), grads, t, key,
            self.ctx, pop.m_total, gains=gains, sites=take(ps.site, cohort),
            n_sites=pop.n_sites, site_noise_scale=self.site_noise_scale,
            backhaul_sigma2=self.backhaul_sigma2,
            site_trim_frac=pop.site_trim_frac, draw=draw, sched=sched)
        extras = ((banks,) + ((dual_banks,) if lw.has_dual else ())
                  + ((sched_banks,) if self._sched_state else ()))
        if gstate is not None:
            params, opt_state, extras, gstate, loss, gmet = (
                guards.guarded_step(
                    self.exp.guard, gstate, self.opt, params, opt_state,
                    ghat, lambda v: unravel(v, params,
                                            batch_dims=v.dim() - 1),
                    extras=extras, old_extras=old_extras,
                    loss_fn=lambda p: ce_loss(p, self.xt, self.yt)))
            out = {"acc": accuracy(params, self.xt, self.yt),
                   "loss": loss, "metrics": {**met, **gmet}}
            return (params, opt_state) + tuple(extras) + (gstate,), out
        params, opt_state = self.opt.apply(
            params, unravel(ghat, params, batch_dims=ghat.dim() - 1),
            opt_state)
        out = {"acc": accuracy(params, self.xt, self.yt),
               "loss": ce_loss(params, self.xt, self.yt), "metrics": met}
        return (params, opt_state) + extras, out

    def _split(self, overrides: Dict[str, Any]):
        """``(runner, scheme, localwork)`` with the overrides swapped on."""
        pop_ov = {k: v for k, v in overrides.items()
                  if k in POP_OVERRIDE_ATTRS}
        rest = {k: v for k, v in overrides.items()
                if k not in POP_OVERRIDE_ATTRS}
        runner = self.with_overrides(**pop_ov) if pop_ov else self
        sch, lw = apply_overrides(self.scheme, self.localwork, rest,
                                  self.device)
        return runner, sch, lw

    # ---------------------------------------------------------- entry
    def run_segment(self, overrides: Dict[str, Any], keys: torch.Tensor,
                    mask, carry, t0: int):
        """Rounds ``t0 .. t0 + len(keys)`` from an explicit carry (the
        segment contract :func:`repro_torch.experiments.engine.
        run_checkpointed` drives).  ``mask`` must be ``None``: a population
        draws its own participation each round.  Returns ``(carry,
        outs)``."""
        if mask is not None:
            raise ValueError("population runs draw their own masks")
        runner, sch, lw = self._split(overrides)
        outs = []
        for i in range(keys.shape[0]):
            carry, out = runner._round(sch, lw, carry, int(t0) + i, keys[i])
            outs.append(out)
        return carry, _stack_outs(outs)

    def run(self, overrides: Dict[str, Any], keys: torch.Tensor):
        """One full run. Returns {"acc": (steps,), "loss": (steps,),
        "metrics": {...: (steps,)}, "params": dict}, on the device."""
        carry, outs = self.run_segment(overrides, keys, None, self.carry0(),
                                       0)
        outs["params"] = carry[0]
        return outs

    def run_grid(self, overrides: Dict[str, Any], keys: torch.Tensor):
        """G runs of this configuration as one batched round per step: the
        counterpart of the reference's ``jax.jit(jax.vmap(cp.run))``.
        ``overrides`` holds ``(G, T)`` schedules and ``(G,)`` scalars,
        ``keys`` is ``(G, T, 2)``; each point draws its own cohorts, keeps
        its own banks and equals its own :meth:`run`.  Returns ``{"acc":
        (G, T), "loss": (G, T), "metrics": {...: (G, T)}, "params": dict
        of (G, ...)}``."""
        points, steps = keys.shape[:2]
        for name, v in overrides.items():
            if v.shape[0] != points:
                raise ValueError(f"run_grid: override {name!r} has "
                                 f"{v.shape[0]} points, keys {points}")
        runner, sch, lw = self._split(overrides)
        carry = self._carry(points)
        outs = []
        for t in range(steps):
            carry, out = runner._round(sch, lw, carry, t, keys[:, t])
            outs.append(out)
        outs = _stack_outs(outs)
        grid = {"acc": outs["acc"].T, "loss": outs["loss"].T,
                "metrics": {k: v.T for k, v in outs["metrics"].items()}}
        grid["params"] = carry[0]
        return grid


def run_population(data: PopulationData, x_test, y_test, cfg: OTAConfig,
                   pop: PopulationConfig, steps: int, lr: float = 1e-3,
                   eval_every: int = 10, seed: int = 0,
                   optimizer: str = "adam", local_steps: int = 1,
                   local_lr: float = 0.1, use_kernel: bool = False,
                   guard: Optional[guards.GuardConfig] = None,
                   checkpoint_dir: Optional[str] = None,
                   checkpoint_every: int = 0, resume: bool = False,
                   stop_after_step=None,
                   device=None) -> Optional[EngineRun]:
    """``run_compiled`` for populations: one loop over sampled cohorts.  At
    K == M_total with the churn and straggler defaults the run is bitwise
    ``run_compiled`` on the same device tensors.

    ``guard`` and the ``checkpoint_*`` knobs are ``run_compiled``'s: the
    round guardrails, and the segmented checkpoint/resume driver (returns
    ``None`` when ``stop_after_step`` interrupts the run).  ``device=None``
    is the card; ``data`` must live on the same device.
    """
    exp = PopulationExperiment(cfg=cfg, pop=pop, steps=steps, lr=lr,
                               eval_every=eval_every, optimizer=optimizer,
                               local_steps=local_steps, local_lr=local_lr,
                               seed=seed, use_kernel=use_kernel, guard=guard)
    cp = CompiledPopulation(data, x_test, y_test, exp, device=device)
    keys = round_keys(steps, seed, cp.device)
    if checkpoint_dir is not None and checkpoint_every > 0:
        outs = run_checkpointed(cp, {}, keys, checkpoint_dir=checkpoint_dir,
                                checkpoint_every=checkpoint_every,
                                resume=resume,
                                stop_after_step=stop_after_step)
        if outs is None:
            return None
    else:
        outs = cp.run({}, keys)
    return _subsample(outs, exp)
