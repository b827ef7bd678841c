"""Sweep grids over the engine: batch what is data, group what is structure.

The port of the reference's ``repro/experiments/sweep.py``.  A sweep axis
is either *schedule-shaped* -- its value enters the round as an array of
per-step scalars, so a whole grid of values runs as one batched round per
step (:meth:`CompiledExperiment.run_grid`) -- or *shape-defining* -- it
changes array shapes or the scheme's class (projector size, scheme), so
each value needs its own runner.

Batched axes (``VMAP_AXES``, the reference's name):

``p_avg``          average power P-bar  -> the (T,) power schedule array
``power_schedule`` schedule shape       -> the same (T,) array
``seed``           round-key stream     -> the (T, 2) key array
``m_active``       device count         -> a participation mask over the
                                           M_pad padded devices
                                           (:func:`engine.round_masked`)

plus the channel-model scalars (``SCALAR_VMAP_AXES``): ``csi_err_var``,
``fading_threshold``, ``fading_rho``, ``cell_radius``, ``path_loss_exp``
and ``n_subbands``, each a ``(G,)`` stack of per-point values swapped onto
the scheme (a multiply or compare inside the channel draw or the subband
cutoff).  ``fading_process``, ``fading_window``, ``ps_antennas``,
``geometry``, ``scheduler`` and ``pf_horizon`` select structure and stay
static axes.  The robustness scalars (``ROBUST_VMAP_AXES``: the fault
rates, the attack magnitude, the trim fraction and the caps) batch the same
way; sweeping any of them sets the base config's ``robust=True``, the
static gate of the fault path, as the reference does.  ``aggregator``,
``byz_attack``, ``fault_kind`` and ``clip_power`` select structure and are
static axes.

Everything else (``scheme``, ``s_frac``, ``k_frac``, ``projection``,
``amp_iters``, ``sigma2``, ...) is an ``OTAConfig`` field swept statically:
the grid is grouped by static combination, one runner per group, and the
batched sub-grid runs inside it.  For the digital schemes the per-step bit
budget ``q_t`` is host-precomputed per grid point and batched beside the
power schedule; the static ``q_max`` bound is shared across the grid (the
q-th value of a top-k does not depend on how many values it computes).

The local-compute knobs (``LOCAL_VMAP_AXES``: ``local_epochs``,
``prox_mu``, ``dyn_alpha``) batch the same way, as ``(G,)`` overrides of
the run's :class:`~repro_torch.local.work.LocalWork`; a ``local_epochs``
axis raises the static epoch bound ``max_epochs`` to the grid's maximum
(the ``q_max`` pattern: a point's epochs past its count leave its carry
untouched).  ``local`` selects the algorithm and is a static axis, one
group per algorithm.

:func:`run_population_sweep` runs the same grids over the sampled-cohort
population engine (:mod:`repro_torch.population`), with the population's
own scalars (``POP_VMAP_AXES``) batched too.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from repro_torch.configs.base import OTAConfig
from repro_torch.core import power
from repro_torch.device import resolve_device
from repro_torch.experiments.engine import (
    CHANNEL_OVERRIDE_ATTRS, ROBUST_OVERRIDE_ATTRS, CompiledExperiment,
    Experiment, eval_indices, round_keys,
)
from repro_torch.local.work import LOCAL_OVERRIDE_ATTRS

#: axes realised as per-point arrays of one batched round
VMAP_AXES = ("p_avg", "power_schedule", "seed", "m_active")

#: the channel-model scalars (fading, CSI error, geometry, scheduling), each
#: a (G,) scheme override of the same name in one batched round
SCALAR_VMAP_AXES = CHANNEL_OVERRIDE_ATTRS

#: the robustness scalars, each a (G,) scheme override of the same name in
#: one batched round; sweeping one sets ``robust=True``
ROBUST_VMAP_AXES = ROBUST_OVERRIDE_ATTRS

#: the local-compute knobs, each a (G,) override of the run's LocalWork
LOCAL_VMAP_AXES = LOCAL_OVERRIDE_ATTRS

#: the population engine's scalars, each a (G,) override of its runner
#: (``CompiledPopulation.with_overrides``)
POP_VMAP_AXES = ("avail_rate", "straggler_deadline", "k_active",
                 "site_noise_scale", "backhaul_sigma2")

#: every axis batched as a (G,) stack of scalars
_SCALAR_AXES = SCALAR_VMAP_AXES + ROBUST_VMAP_AXES + LOCAL_VMAP_AXES


@dataclass
class SweepResult:
    """One record per grid point, ``accs``/``final_acc`` at eval steps --
    the reading the reference's ``benchmarks.common.run_series`` takes
    from a looped run."""
    records: List[Dict[str, Any]]
    eval_steps: np.ndarray
    steps: int
    wall_s: float

    def record(self, **axis_values) -> Dict[str, Any]:
        """The unique record matching the given axis values."""
        hits = [r for r in self.records
                if all(r[k] == v for k, v in axis_values.items())]
        if len(hits) != 1:
            raise KeyError(f"{axis_values} matched {len(hits)} records")
        return hits[0]


def _validate_axes(axes: Dict[str, Sequence], batched: Sequence[str],
                   static_types: Sequence[type]) -> None:
    """Every axis is batched or a field of one of ``static_types``, and
    none is empty."""
    fields = {f.name for t in static_types for f in dataclasses.fields(t)}
    for name, values in axes.items():
        if name not in batched and name not in fields:
            raise KeyError(
                f"unknown sweep axis {name!r}: vmapped axes are "
                f"{tuple(batched)}, static axes are "
                f"{'/'.join(t.__name__ for t in static_types)} fields")
        if not len(values):
            raise ValueError(f"sweep axis {name!r} is empty")


def _cover_epochs(runner, axes: Dict[str, Sequence]) -> None:
    """A ``local_epochs`` axis: the sweep's own runner gets the static
    epoch bound of the grid's maximum (the ``q_max`` pattern; a point's
    epochs past its count leave its carry untouched)."""
    if "local_epochs" in axes:
        runner.localwork.max_epochs = max(int(max(axes["local_epochs"])), 1)


def _sweep(axes: Dict[str, Sequence], batched: Sequence[str], run_group,
           steps: int, eval_every: int) -> SweepResult:
    """The grid loop both sweeps share: one ``run_group(static_d, grid)``
    (a runner's ``run_grid`` outputs) per combination of the static axes,
    over the cartesian product ``grid`` of the batched ones."""
    static_names = [k for k in axes if k not in batched]
    vmap_names = [k for k in axes if k in batched]
    records: List[Dict[str, Any]] = []
    t0 = time.time()
    for static_vals in itertools.product(*[axes[k] for k in static_names]):
        static_d = dict(zip(static_names, static_vals))
        grid = ([dict(zip(vmap_names, vals)) for vals in itertools.product(
            *[axes[k] for k in vmap_names])] if vmap_names else [{}])
        records.extend(_records(run_group(static_d, grid), grid, static_d,
                                steps, eval_every))
    wall = time.time() - t0
    us = wall / max(len(records) * steps, 1) * 1e6
    for rec in records:
        rec["us_per_call"] = us
    return SweepResult(records=records, eval_steps=eval_indices(
        steps, eval_every), steps=steps, wall_s=wall)


def _scalar_overrides(grid: List[Dict[str, Any]], names, dev):
    """``(G,)`` float32 stacks of the batched scalar axes in ``grid``."""
    return {name: torch.tensor(np.asarray([p[name] for p in grid],
                                          np.float32), device=dev)
            for name in names if name in grid[0]}


def _grid_overrides(runner, grid: List[Dict[str, Any]], steps: int,
                    seed: int, count, scalar_axes):
    """``(overrides, keys)`` of a group's batched points: each point's
    power schedule, and for a digital scheme its q_t schedule built with
    ``count(point)`` devices (host-precomputed; the scheme's static
    ``q_max`` raised to cover the grid), its round keys, and ``(G,)``
    stacks of the ``scalar_axes`` in ``grid``."""
    cfg, dev = runner.exp.cfg, runner.device
    digital = hasattr(runner.scheme, "q_sched")
    p_rows, q_rows, key_rows = [], [], []
    for point in grid:
        p_np = power.schedule_array(
            cfg.total_steps, point.get("p_avg", cfg.p_avg),
            point.get("power_schedule", cfg.power_schedule))
        p_rows.append(np.asarray(p_np, np.float32))
        if digital:
            # the scheme's own budget/cap rule, with this point's effective
            # device count
            q_rows.append(runner.scheme.build_q_schedule(count(point), p_np))
        key_rows.append(round_keys(steps, point.get("seed", seed), dev))
    overrides = {"p_sched": torch.from_numpy(np.stack(p_rows)).to(dev),
                 **_scalar_overrides(grid, scalar_axes, dev)}
    if digital:
        q_grid = np.stack(q_rows)
        runner.scheme.q_max = int(max(int(q_grid.max()), 1))
        overrides["q_sched"] = torch.from_numpy(
            q_grid.astype(np.int32)).to(dev)
    return overrides, torch.stack(key_rows)


def grid_inputs(ce: CompiledExperiment, grid: List[Dict[str, Any]],
                steps: int, seed: int = 0, masked: bool = False):
    """The per-point inputs of :meth:`CompiledExperiment.run_grid` for the
    batched points ``grid`` (dicts of ``VMAP_AXES``, ``SCALAR_VMAP_AXES``,
    ``ROBUST_VMAP_AXES`` and ``LOCAL_VMAP_AXES`` values) of one static
    group: ``(overrides, keys, masks)``, on the runner's device.  A digital
    point's q_t schedule counts its ``m_active`` devices; ``masks`` is
    ``None`` unless ``masked``.  A ``local_epochs`` grid needs the runner's
    ``localwork.max_epochs`` at the grid's maximum, which the caller sets
    (:func:`run_sweep` does on its own runners).
    """
    m_pad = ce.m
    overrides, keys = _grid_overrides(
        ce, grid, steps, seed, lambda p: p.get("m_active", m_pad),
        _SCALAR_AXES)
    masks = None
    if masked:
        masks = torch.from_numpy(np.stack([
            (np.arange(m_pad) < p.get("m_active", m_pad)).astype(np.float32)
            for p in grid])).to(ce.device)
    return overrides, keys, masks


def _records(outs, grid, static_d, steps: int, eval_every: int):
    """One record per point of a group's ``run_grid`` outputs, at the eval
    steps; every per-round scalar of the group reaches the host in one
    transfer."""
    names = list(outs["metrics"])
    table = torch.stack([outs["acc"], outs["loss"],
                         *(outs["metrics"][k] for k in names)],
                        dim=-1).cpu().numpy()
    idx = eval_indices(steps, eval_every)
    records = []
    for g, point in enumerate(grid):
        rec: Dict[str, Any] = {**static_d, **point}
        rec["accs"] = [float(table[g, i, 0]) for i in idx]
        rec["losses"] = [float(table[g, i, 1]) for i in idx]
        rec["metrics"] = [
            {k: float(table[g, i, 2 + j]) for j, k in enumerate(names)}
            for i in idx]
        rec["final_acc"] = rec["accs"][-1]
        records.append(rec)
    return records


def run_sweep(dev_data, test_data, base: OTAConfig,
              axes: Dict[str, Sequence], *, steps: int, lr: float = 1e-3,
              eval_every: int = 10, optimizer: str = "adam", seed: int = 0,
              local_lr: float = 0.1, use_kernel: bool = False,
              device=None) -> SweepResult:
    """Run the cartesian grid of ``axes`` over ``base``.

    dev_data = (x_dev (M, B, dim), y_dev), test_data = (x_test, y_test).
    For an ``m_active`` axis the device tensors are the M_pad padding; every
    value must be <= M_pad.  ``device=None`` runs on the card.  Each static
    group runs its batched points through one
    :meth:`CompiledExperiment.run_grid`.
    """
    (xd, yd), (xt, yt) = dev_data, test_data
    dev = resolve_device(device)
    axes = {k: list(v) for k, v in axes.items()}
    batched = VMAP_AXES + _SCALAR_AXES
    _validate_axes(axes, batched, (OTAConfig,))
    if any(k in ROBUST_VMAP_AXES for k in axes):
        # the swept rates are data, but the fault path is a static gate:
        # turn it on for the whole grid
        base = dataclasses.replace(base, robust=True)
    m_pad = xd.shape[0]
    masked = "m_active" in axes
    if masked and max(axes["m_active"]) > m_pad:
        raise ValueError(f"m_active values must be <= M_pad = {m_pad}")

    def run_group(static_d, grid):
        exp = Experiment(cfg=dataclasses.replace(base, **static_d),
                         steps=steps, lr=lr, eval_every=eval_every,
                         optimizer=optimizer, seed=seed, local_lr=local_lr,
                         use_kernel=use_kernel)
        ce = CompiledExperiment(xd, yd, xt, yt, exp, device=dev)
        _cover_epochs(ce, axes)
        overrides, keys, masks = grid_inputs(ce, grid, steps, seed,
                                             masked=masked)
        # --- one batched run for the whole sub-grid ----------------------
        return ce.run_grid(overrides, keys, masks)

    return _sweep(axes, batched, run_group, steps, eval_every)


def run_population_sweep(data, test_data, base: OTAConfig, base_pop,
                         axes: Dict[str, Sequence], *, steps: int,
                         lr: float = 1e-3, eval_every: int = 10,
                         optimizer: str = "adam", seed: int = 0,
                         local_lr: float = 0.1, use_kernel: bool = False,
                         device=None) -> SweepResult:
    """:func:`run_sweep` over the sampled-cohort population engine.

    ``data`` is a :class:`repro_torch.population.PopulationData` on the
    run's device, ``base_pop`` a :class:`repro_torch.population.
    PopulationConfig`.  Batched axes are ``p_avg``, ``power_schedule`` and
    ``seed``, the channel, robustness and local-compute scalars and the
    population's own (``POP_VMAP_AXES``); each point draws its own cohorts
    and keeps its own banks (:meth:`CompiledPopulation.run_grid`).  Static
    axes are any ``OTAConfig`` or ``PopulationConfig`` field, one runner
    per combination.  ``m_active`` is the dense engine's axis; its
    sampled-cohort analogue is ``k_active``, whose values must not exceed
    the static ``k_cohort``.
    """
    from repro_torch.population.engine import (
        CompiledPopulation, PopulationExperiment,
    )
    from repro_torch.population.state import PopulationConfig

    (xt, yt) = test_data
    dev = resolve_device(device)
    axes = {k: list(v) for k, v in axes.items()}
    if "m_active" in axes:
        raise KeyError("m_active is a dense-engine axis; the population "
                       "engine sweeps the cohort via k_active")
    batched = ("p_avg", "power_schedule", "seed") + POP_VMAP_AXES \
        + _SCALAR_AXES
    _validate_axes(axes, batched, (OTAConfig, PopulationConfig))
    if any(k in ROBUST_VMAP_AXES for k in axes):
        base = dataclasses.replace(base, robust=True)
    if "k_active" in axes and max(axes["k_active"]) > base_pop.k_cohort:
        raise ValueError(
            f"k_active values must be <= k_cohort = {base_pop.k_cohort}")
    cfg_fields = {f.name for f in dataclasses.fields(OTAConfig)}

    def run_group(static_d, grid):
        cfg = dataclasses.replace(
            base, **{k: v for k, v in static_d.items() if k in cfg_fields})
        pop = dataclasses.replace(
            base_pop,
            **{k: v for k, v in static_d.items() if k not in cfg_fields})
        exp = PopulationExperiment(cfg=cfg, pop=pop, steps=steps, lr=lr,
                                   eval_every=eval_every,
                                   optimizer=optimizer, seed=seed,
                                   local_lr=local_lr,
                                   use_kernel=use_kernel)
        cp = CompiledPopulation(data, xt, yt, exp, device=dev)
        _cover_epochs(cp, axes)
        overrides, keys = population_grid_inputs(cp, grid, steps, seed)
        return cp.run_grid(overrides, keys)

    return _sweep(axes, batched, run_group, steps, eval_every)


def population_grid_inputs(cp, grid: List[Dict[str, Any]], steps: int,
                           seed: int = 0):
    """The per-point inputs of :meth:`CompiledPopulation.run_grid` for the
    batched points ``grid`` of one static group: ``(overrides, keys)``.
    A digital scheme's q_t schedule tracks the point's effective cohort
    (``k_active``, the analogue of ``m_active``'s rule)."""
    k = cp.exp.pop.k_cohort
    return _grid_overrides(cp, grid, steps, seed,
                           lambda p: int(p.get("k_active", k)),
                           _SCALAR_AXES + POP_VMAP_AXES)
