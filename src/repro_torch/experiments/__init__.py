"""repro_torch.experiments: the experiment engine behind the paper figures.

One federated run -- device gradients, scheme encode, MAC superposition, PS
decode, Adam update -- as one loop with no host round trip, with
checkpointed resume (:mod:`repro_torch.experiments.engine`).  The
reference's sweep grids (``repro/experiments/sweep.py``) are not ported yet.
"""
from repro_torch.experiments.engine import (  # noqa: F401
    CompiledExperiment, EngineRun, Experiment, eval_indices, round_keys,
    round_masked, run_checkpointed, run_compiled,
)
