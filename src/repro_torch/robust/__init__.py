"""Fault injection, robust aggregation and round guardrails.

The port of the reference's ``repro/robust``: deterministic fault traces
(:mod:`repro_torch.robust.faults`), influence-bounded combines
(:mod:`repro_torch.robust.aggregators`) and in-run safety rails
(:mod:`repro_torch.robust.guards`).  The wiring lives in
:func:`repro_torch.experiments.engine.round_masked` and the engine's
:class:`~repro_torch.experiments.engine.CompiledExperiment`.
"""
from repro_torch.robust.aggregators import (
    clip_frame_power, median, norm_capped_sum, robust_combine, trimmed_mean,
)
from repro_torch.robust.faults import (
    SALT_FAULT, FaultDraw, apply_frame_faults, apply_gradient_faults,
    byzantine_set, fault_base_key, fault_draw, take_rows,
)
from repro_torch.robust.guards import (
    GuardConfig, GuardState, guarded_step, init_guard_state,
)

__all__ = [
    "SALT_FAULT",
    "FaultDraw",
    "GuardConfig",
    "GuardState",
    "apply_frame_faults",
    "apply_gradient_faults",
    "byzantine_set",
    "clip_frame_power",
    "fault_base_key",
    "fault_draw",
    "guarded_step",
    "init_guard_state",
    "median",
    "norm_capped_sum",
    "robust_combine",
    "take_rows",
    "trimmed_mean",
]
