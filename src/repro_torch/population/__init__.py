"""Massive-cohort population engine: sampled rounds over 10^4-10^6 devices.

The port of the reference's ``repro.population``: banked per-device state
with gather / scatter cohort views (:mod:`.state`), deterministic
Gumbel-top-k cohort sampling (:mod:`.sampler`), churn and straggler models
(:mod:`.churn`, :mod:`.stragglers`), hierarchical edge-site aggregation
(:mod:`.hierarchy`) and the sampled-cohort round engine (:mod:`.engine`).
Sweep grids over population axes run through
:func:`repro_torch.experiments.run_population_sweep`.
"""

from repro_torch.population.engine import (
    POP_OVERRIDE_ATTRS, CompiledPopulation, PopulationData,
    PopulationExperiment, population_round, run_population,
)
from repro_torch.population.hierarchy import site_assignment, site_mac_sum
from repro_torch.population.sampler import sample_cohort
from repro_torch.population.state import (
    BankedState, PopulationConfig, PopulationState, gather_cohort,
    init_banks, init_population, scatter_cohort,
)

__all__ = [
    "BankedState",
    "CompiledPopulation",
    "POP_OVERRIDE_ATTRS",
    "PopulationConfig",
    "PopulationData",
    "PopulationExperiment",
    "PopulationState",
    "gather_cohort",
    "init_banks",
    "init_population",
    "population_round",
    "run_population",
    "sample_cohort",
    "scatter_cohort",
    "site_assignment",
    "site_mac_sum",
]
