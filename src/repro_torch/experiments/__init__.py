"""repro_torch.experiments: the experiment engine behind the paper figures.

One federated run -- device gradients, scheme encode, MAC superposition, PS
decode, Adam update -- as one loop with no host round trip, with
checkpointed resume (:mod:`repro_torch.experiments.engine`); sweep grids
run their schedule-shaped axes as one batched round per step
(:mod:`repro_torch.experiments.sweep`).
"""
from repro_torch.experiments.engine import (  # noqa: F401
    CompiledExperiment, EngineRun, Experiment, eval_indices, round_keys,
    round_masked, run_checkpointed, run_compiled,
)
from repro_torch.experiments.sweep import (  # noqa: F401
    LOCAL_VMAP_AXES, POP_VMAP_AXES, ROBUST_VMAP_AXES, SCALAR_VMAP_AXES,
    VMAP_AXES, SweepResult, run_population_sweep, run_sweep,
)
