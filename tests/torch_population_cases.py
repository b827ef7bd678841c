"""Shared data, configurations and helpers of the population engine's port
tests (``tests/test_torch_population_engine.py`` and
``tests/test_torch_population_grid.py``): the dense data of
tests/test_population.py (M = 4, dim 48) and a pool of 1200 samples (dim
16, 4 classes) over M = 40 devices for K < M, each run against the JAX
engine at the port's bar for runs (accuracies and the cohort columns
equal, losses within 1e-5) or against the port's own run bitwise."""
import numpy as np
import pytest
import torch

import repro.population as jpop
from repro.configs.base import OTAConfig as JaxOTAConfig
from repro.data.partition import population_partition as jax_partition
from repro_torch import population as tpop
from repro_torch.configs.base import OTAConfig
from repro_torch.data import federated_split, make_classification
from repro_torch.data.partition import population_partition

STEPS, EVERY, M, B = 6, 2, 4, 64
CPU = dict(device="cpu")
BASE = dict(s_frac=0.5, k_frac=0.25, p_avg=500.0, total_steps=STEPS,
            projection="dense", amp_iters=6, mean_removal_steps=2)
#: K < M populations over the pool: M = 40, K = 8
POPS = {
    "sampled": dict(),
    "churn_stragglers_sites": dict(avail_rate=0.6, speed_sigma=0.5,
                                   straggler_deadline=2.0, n_sites=3,
                                   arrival_spread=0.3, mean_lifetime=8.0,
                                   shadowing_sigma_db=4.0, capacity=16,
                                   bank_size=8),
    "site_trim": dict(n_sites=4, site_trim_frac=0.25, site_noise_scale=2.0,
                      backhaul_sigma2=0.5, avail_rate=0.9),
}


@pytest.fixture(scope="module")
def data():
    (xtr, ytr), (xte, yte) = make_classification(
        n_train=800, n_test=300, dim=48, noise=2.0, seed=3)
    xd, yd = federated_split(xtr, ytr, m=M, b=B, iid=True, seed=0)
    return xd, yd, xte, yte


@pytest.fixture(scope="module")
def pool():
    (xtr, ytr), (xte, yte) = make_classification(
        n_train=1200, n_test=300, dim=16, n_classes=4, noise=2.0, seed=0)
    return xtr, ytr, xte, yte


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bitwise(a, b):
    assert a.accs == b.accs and a.losses == b.losses
    np.testing.assert_array_equal(a.all_losses.view(np.int32),
                                  b.all_losses.view(np.int32))
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k


def _dense(data, cfg_kw, pop_kw=None, **run_kw):
    xd, yd, xte, yte = data
    pop = tpop.PopulationConfig(m_total=M, k_cohort=M, bank_size=3,
                                **(pop_kw or {}))
    return tpop.run_population(tpop.PopulationData.from_dense(xd, yd, **CPU),
                               xte, yte, OTAConfig(**cfg_kw), pop,
                               steps=STEPS, lr=1e-3, eval_every=EVERY, **CPU,
                               **run_kw)


def _pooled(pool, cfg_kw, pop_kw, **run_kw):
    xtr, ytr, xte, yte = pool
    part = population_partition(ytr, m=40, b=16, kind="iid", seed=0)
    pop = tpop.PopulationConfig(m_total=40, k_cohort=8, **pop_kw)
    return tpop.run_population(
        tpop.PopulationData.from_pool(xtr, ytr, part, **CPU), xte, yte,
        OTAConfig(**cfg_kw), pop, steps=STEPS, lr=1e-3, eval_every=EVERY,
        **CPU, **run_kw)


def _jax_pooled(pool, cfg_kw, pop_kw, **run_kw):
    xtr, ytr, xte, yte = pool
    part = jax_partition(ytr, m=40, b=16, kind="iid", seed=0)
    pop = jpop.PopulationConfig(m_total=40, k_cohort=8, **pop_kw)
    return jpop.run_population(jpop.PopulationData.from_pool(xtr, ytr, part),
                               xte, yte, JaxOTAConfig(**cfg_kw), pop,
                               steps=STEPS, lr=1e-3, eval_every=EVERY,
                               **run_kw)


def _close(got, want):
    np.testing.assert_allclose(got.all_losses, want.all_losses, rtol=0,
                               atol=1e-5)
    assert got.all_accs.tolist() == want.all_accs.tolist()
    for mg, mw in zip(got.metrics, want.metrics):
        assert set(mg) == set(mw)
        for k in ("cohort_frac", "active_frac", "byz_frac", "fault_frac",
                  "guard_skipped"):
            if k in mw:
                assert mg[k] == mw[k], k
