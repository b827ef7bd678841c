"""The sampled-cohort population engine through the port's runs,
repro_torch against repro: population_round and run_population (K == M
against run_compiled, K < M with churn, stragglers, edge sites and site
trimming, FedDyn's banked duals, prop_fair's banked state, the guard).
Resumes and run_population_sweep are in
``tests/test_torch_population_grid.py``; the shared data and helpers in
``tests/torch_population_cases.py``.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.population as jpop
from repro.configs.base import OTAConfig as JaxOTAConfig
from repro.core.schemes import MACContext as JaxMACContext
from repro.core.schemes import get_scheme as jax_get_scheme
from repro.robust import GuardConfig as JaxGuardConfig
from repro_torch import population as tpop
from repro_torch import rng
from repro_torch.configs.base import OTAConfig
from repro_torch.core.schemes import MACContext, get_scheme
from repro_torch.data.partition import population_partition
from repro_torch.experiments import engine
from repro_torch.robust import GuardConfig

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tests.torch_population_cases import (  # noqa: E402,F401
    BASE, CPU, EVERY, M, POPS, STEPS, _bitwise, _close, _dense,
    _jax_pooled, _pooled, data, one_torch_thread, pool,
)


@pytest.mark.parametrize("cfg", [
    dict(scheme="a_dsgd"), dict(scheme="d_dsgd"),
    dict(scheme="a_dsgd", local="feddyn", local_epochs=2, dyn_alpha=0.3),
    dict(scheme="a_dsgd", projection="blocked", block_size=64,
         use_kernel=True),
    dict(scheme="a_dsgd", robust=True, byzantine_frac=0.3, byz_scale=4.0,
         fault_rate=0.25, fault_kind="stale"),
])
def test_full_cohort_is_run_compiled_bitwise(data, cfg):
    """K == M with the churn and straggler defaults: run_population is
    run_compiled entry for entry (the reference's pin), FedDyn's banked
    duals the dense carry's, the cohort's fault rows the dense trace."""
    kw = {**BASE, **cfg}
    pop = _dense(data, kw)
    dense = engine.run_compiled(*data, OTAConfig(**kw), steps=STEPS,
                                lr=1e-3, eval_every=EVERY, **CPU)
    _bitwise(pop, dense)
    for mp, md in zip(pop.metrics, dense.metrics):
        assert mp["cohort_frac"] == 1.0
        for k, v in md.items():
            assert mp[k] == v, k


def test_population_round_matches_reference():
    """One K == M banked round against the reference's population_round:
    ghat within A-DSGD's bar, the banks' error states and owners."""
    rs = np.random.RandomState(0)
    m, d = 6, 200
    grads = rs.randn(m, d).astype(np.float32)
    kw = dict(BASE, scheme="a_dsgd")
    js = jax_get_scheme(JaxOTAConfig(**kw), d, m)
    ts = get_scheme(OTAConfig(**kw), d, m, **CPU)
    mask = np.asarray([1, 1, 0, 1, 1, 0], np.float32)
    want = jax.jit(lambda g: jpop.population_round(
        js, jpop.init_banks(m, 4, d), jnp.arange(m, dtype=jnp.int32),
        jnp.asarray(mask), g, 0, jax.random.PRNGKey(11),
        JaxMACContext(m=m), m))(grads)
    got = tpop.population_round(
        ts, tpop.init_banks(m, 4, d, **CPU), torch.arange(m),
        torch.from_numpy(mask), torch.from_numpy(grads), 0, rng.PRNGKey(11),
        MACContext(m=m), m)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[1].deltas.numpy(),
                               np.asarray(want[1].deltas), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(got[1].owner.numpy(),
                                  np.asarray(want[1].owner))
    assert float(got[2]["cohort_frac"]) == float(want[2]["cohort_frac"])
    # the masked-out rows bank nothing new: their slots stay cold
    view = tpop.gather_cohort(got[1], torch.arange(m))
    assert torch.all(view[[2, 5]] == 0)


@pytest.mark.parametrize("scheme", ["a_dsgd", "d_dsgd"])
@pytest.mark.parametrize("name", list(POPS))
def test_sampled_run_matches_jax_engine(pool, scheme, name):
    kw = dict(BASE, scheme=scheme)
    _close(_pooled(pool, kw, POPS[name]), _jax_pooled(pool, kw, POPS[name]))


def test_feddyn_banked_duals_with_eviction_match_jax_engine(pool):
    """capacity < M: FedDyn's duals evict direct-mapped (a cold read is
    dual = 0, the fresh device); the run against the reference's."""
    kw = dict(BASE, scheme="a_dsgd", local="feddyn", local_epochs=2,
              dyn_alpha=0.2)
    pop_kw = dict(capacity=16, bank_size=8)
    _close(_pooled(pool, kw, pop_kw), _jax_pooled(pool, kw, pop_kw))
    xtr, ytr, xte, yte = pool
    part = population_partition(ytr, m=40, b=16, kind="iid", seed=0)
    exp = tpop.PopulationExperiment(
        cfg=OTAConfig(**kw), pop=tpop.PopulationConfig(
            m_total=40, k_cohort=8, **pop_kw), steps=STEPS)
    cp = tpop.CompiledPopulation(
        tpop.PopulationData.from_pool(xtr, ytr, part, **CPU), xte, yte, exp,
        **CPU)
    assert cp.dual_banks0.deltas.shape == (2, 8, cp.d)
    carry, _ = cp.run_segment({}, engine.round_keys(STEPS, 0, "cpu"), None,
                              cp.carry0(), 0)
    assert torch.any(carry[3].owner >= 0)
    assert torch.isfinite(carry[3].deltas).all()


def test_prop_fair_and_guard_match_jax_engine(pool):
    """prop_fair's banked average rates and a guarded run."""
    kw = dict(BASE, scheme="a_dsgd", fading="rayleigh",
              scheduler="prop_fair", n_subbands=3)
    _close(_pooled(pool, kw, dict(avail_rate=0.8)),
           _jax_pooled(pool, kw, dict(avail_rate=0.8)))
    kw = dict(BASE, scheme="a_dsgd", fault_rate=0.3, fault_kind="nan")
    got = _pooled(pool, kw, {}, guard=GuardConfig())
    want = _jax_pooled(pool, kw, {}, guard=JaxGuardConfig())
    _close(got, want)
    assert sum(m["guard_skipped"] for m in got.metrics) > 0


def test_hierarchy_uses_the_mac_hook_and_differs_from_flat(data):
    kw = dict(BASE, scheme="a_dsgd")
    flat = _dense(data, kw)
    sites = _dense(data, kw, dict(n_sites=2))
    assert flat.losses != sites.losses
    assert np.isfinite(sites.all_losses).all()
    deadline = _dense(data, kw, dict(speed_sigma=0.5,
                                     straggler_deadline=0.3))
    assert min(m["cohort_frac"] for m in deadline.metrics) < 1.0


def test_overrides_and_errors(data):
    xd, yd, xte, yte = data
    exp = tpop.PopulationExperiment(cfg=OTAConfig(**BASE),
                                    pop=tpop.PopulationConfig(m_total=M,
                                                              k_cohort=M),
                                    steps=STEPS)
    pdata = tpop.PopulationData.from_dense(xd, yd, **CPU)
    cp = tpop.CompiledPopulation(pdata, xte, yte, exp, **CPU)
    with pytest.raises(AttributeError, match="unknown population override"):
        cp.with_overrides(bank_size=4.0)
    assert cp.with_overrides(avail_rate=[0.5, 1.0]).avail_rate.shape == (2,)
    with pytest.raises(ValueError, match="own masks"):
        cp.run_segment({}, engine.round_keys(1, 0, "cpu"), torch.ones(M),
                       cp.carry0(), 0)
    bad = dataclasses.replace(exp, pop=tpop.PopulationConfig(m_total=M + 1,
                                                             k_cohort=M))
    with pytest.raises(ValueError, match="devices"):
        tpop.CompiledPopulation(pdata, xte, yte, bad, **CPU)
    with pytest.raises(ValueError, match="local_steps"):
        tpop.CompiledPopulation(pdata, xte, yte, dataclasses.replace(
            exp, cfg=OTAConfig(**BASE, local="fedavg"), local_steps=2),
            **CPU)
    assert tpop.POP_OVERRIDE_ATTRS == jpop.POP_OVERRIDE_ATTRS
