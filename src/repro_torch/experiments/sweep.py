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

The reference's local-compute knobs (``LOCAL_VMAP_AXES``) and the
population engine's :func:`run_population_sweep` need parts that are not
ported yet: they are named here and raise ``NotImplementedError``.
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
    CHANNEL_OVERRIDE_ATTRS, LOCAL_OVERRIDE_ATTRS, ROBUST_OVERRIDE_ATTRS,
    SCALAR_OVERRIDE_ATTRS, UNPORTED_OVERRIDE_ATTRS, CompiledExperiment,
    Experiment, eval_indices, round_keys,
)

#: axes realised as per-point arrays of one batched round
VMAP_AXES = ("p_avg", "power_schedule", "seed", "m_active")

#: the channel-model scalars (fading, CSI error, geometry, scheduling), each
#: a (G,) scheme override of the same name in one batched round
SCALAR_VMAP_AXES = CHANNEL_OVERRIDE_ATTRS

#: the robustness scalars, each a (G,) scheme override of the same name in
#: one batched round; sweeping one sets ``robust=True``
ROBUST_VMAP_AXES = ROBUST_OVERRIDE_ATTRS

#: the reference's batched local-compute knobs: not ported yet
LOCAL_VMAP_AXES = LOCAL_OVERRIDE_ATTRS

#: the population engine's batched knobs: not ported yet
POP_VMAP_AXES = ("avail_rate", "straggler_deadline", "k_active",
                 "site_noise_scale", "backhaul_sigma2")


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


def _validate_axes(axes: Dict[str, Sequence], base: OTAConfig) -> None:
    cfg_fields = {f.name for f in dataclasses.fields(OTAConfig)}
    vmapped = (VMAP_AXES + SCALAR_VMAP_AXES + ROBUST_VMAP_AXES
               + UNPORTED_OVERRIDE_ATTRS)
    for name, values in axes.items():
        if name not in vmapped and name not in cfg_fields:
            raise KeyError(
                f"unknown sweep axis {name!r}: vmapped axes are "
                f"{vmapped}, static axes are OTAConfig fields")
        if not len(list(values)):
            raise ValueError(f"sweep axis {name!r} is empty")
    for name in axes:
        if name in UNPORTED_OVERRIDE_ATTRS:
            raise NotImplementedError(
                f"sweep axis {name!r} is not ported yet (its local-compute "
                "axis is not)")


def grid_inputs(ce: CompiledExperiment, grid: List[Dict[str, Any]],
                steps: int, seed: int = 0, masked: bool = False):
    """The per-point inputs of :meth:`CompiledExperiment.run_grid` for the
    batched points ``grid`` (dicts of ``VMAP_AXES``, ``SCALAR_VMAP_AXES``
    and ``ROBUST_VMAP_AXES`` values) of one static group: ``(overrides,
    keys, masks)``, on the runner's device.

    Each point's power schedule, and for a digital scheme its q_t schedule
    built with the point's effective device count, are host-precomputed; the
    scheme's static ``q_max`` is raised to cover the grid.  ``masks`` is
    ``None`` unless ``masked``.
    """
    cfg, dev, m_pad = ce.exp.cfg, ce.device, ce.m
    digital = hasattr(ce.scheme, "q_sched")
    p_rows, q_rows, key_rows, mask_rows = [], [], [], []
    for point in grid:
        p_avg = point.get("p_avg", cfg.p_avg)
        sched = point.get("power_schedule", cfg.power_schedule)
        m_eff = point.get("m_active", m_pad)
        p_np = power.schedule_array(cfg.total_steps, p_avg, sched)
        p_rows.append(np.asarray(p_np, np.float32))
        if digital:
            # the scheme's own budget/cap rule, with this point's effective
            # device count
            q_rows.append(ce.scheme.build_q_schedule(m_eff, p_np))
        key_rows.append(round_keys(steps, point.get("seed", seed), dev))
        if masked:
            mask_rows.append((np.arange(m_pad) < m_eff).astype(np.float32))
    overrides = {"p_sched": torch.from_numpy(np.stack(p_rows)).to(dev)}
    for name in SCALAR_OVERRIDE_ATTRS:
        if name in grid[0]:
            overrides[name] = torch.tensor(
                np.asarray([point[name] for point in grid], np.float32),
                device=dev)
    if digital:
        q_grid = np.stack(q_rows)
        ce.scheme.q_max = int(max(int(q_grid.max()), 1))
        overrides["q_sched"] = torch.from_numpy(
            q_grid.astype(np.int32)).to(dev)
    masks = (torch.from_numpy(np.stack(mask_rows)).to(dev) if masked
             else None)
    return overrides, torch.stack(key_rows), masks


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
    _validate_axes(axes, base)
    if any(k in ROBUST_VMAP_AXES for k in axes):
        # the swept rates are data, but the fault path is a static gate:
        # turn it on for the whole grid
        base = dataclasses.replace(base, robust=True)
    m_pad = xd.shape[0]
    masked = "m_active" in axes
    if masked and max(axes["m_active"]) > m_pad:
        raise ValueError(f"m_active values must be <= M_pad = {m_pad}")

    batched = VMAP_AXES + SCALAR_VMAP_AXES + ROBUST_VMAP_AXES
    static_names = [k for k in axes if k not in batched]
    vmap_names = [k for k in axes if k in batched]
    records: List[Dict[str, Any]] = []
    t0 = time.time()

    for static_vals in itertools.product(*[axes[k] for k in static_names]):
        static_d = dict(zip(static_names, static_vals))
        cfg = dataclasses.replace(base, **static_d)
        exp = Experiment(cfg=cfg, steps=steps, lr=lr, eval_every=eval_every,
                         optimizer=optimizer, seed=seed, local_lr=local_lr,
                         use_kernel=use_kernel)
        ce = CompiledExperiment(xd, yd, xt, yt, exp, device=dev)

        grid = ([dict(zip(vmap_names, vals)) for vals in itertools.product(
            *[axes[k] for k in vmap_names])] if vmap_names else [{}])
        overrides, keys, masks = grid_inputs(ce, grid, steps, seed,
                                             masked=masked)
        # --- one batched run for the whole sub-grid ----------------------
        outs = ce.run_grid(overrides, keys, masks)
        names = list(outs["metrics"])
        # every per-round scalar of the group in one transfer to the host
        table = torch.stack([outs["acc"], outs["loss"],
                             *(outs["metrics"][k] for k in names)],
                            dim=-1).cpu().numpy()

        idx = eval_indices(steps, eval_every)
        for g, point in enumerate(grid):
            rec: Dict[str, Any] = {**static_d, **point}
            rec["accs"] = [float(table[g, i, 0]) for i in idx]
            rec["losses"] = [float(table[g, i, 1]) for i in idx]
            rec["metrics"] = [
                {k: float(table[g, i, 2 + j]) for j, k in enumerate(names)}
                for i in idx]
            rec["final_acc"] = rec["accs"][-1]
            records.append(rec)

    wall = time.time() - t0
    us = wall / max(len(records) * steps, 1) * 1e6
    for rec in records:
        rec["us_per_call"] = us
    return SweepResult(records=records, eval_steps=eval_indices(
        steps, eval_every), steps=steps, wall_s=wall)


def run_population_sweep(data, test_data, base: OTAConfig, base_pop,
                         axes: Dict[str, Sequence], **kwargs) -> SweepResult:
    """:func:`run_sweep` over the sampled-cohort population engine, which
    is not ported yet (its sampler, banked state and cohort rounds)."""
    raise NotImplementedError(
        "run_population_sweep: the population engine is not ported yet")
