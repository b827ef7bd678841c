"""The population engine's resumes and grids, repro_torch against repro:
a FedDyn population run resumed bitwise (and from a checkpoint the JAX
engine writes), and run_population_sweep, each record against its own
run bitwise and the reference's grid within the port's bar (shared data
and helpers in ``tests/torch_population_cases.py``).
"""
import dataclasses
import os
import sys

import numpy as np

import repro.population as jpop
from repro.configs.base import OTAConfig as JaxOTAConfig
from repro.data.partition import population_partition as jax_partition
from repro.experiments import run_population_sweep as jax_pop_sweep
from repro_torch import population as tpop
from repro_torch.configs.base import OTAConfig
from repro_torch.data.partition import population_partition
from repro_torch.experiments import engine, run_population_sweep
from repro_torch.train.checkpoint import load_checkpoint

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tests.torch_population_cases import (  # noqa: E402,F401
    BASE, CPU, EVERY, M, STEPS, _bitwise, _close, _jax_pooled, _pooled,
    data, one_torch_thread, pool,
)


def test_resume_is_bitwise(pool, tmp_path):
    kw = dict(BASE, scheme="a_dsgd", local="feddyn", local_epochs=2,
              dyn_alpha=0.2, robust=True, byzantine_frac=0.25, byz_scale=3.0)
    pop_kw = dict(avail_rate=0.9, capacity=16, bank_size=8)
    full = _pooled(pool, kw, pop_kw)
    ck = dict(checkpoint_dir=str(tmp_path), checkpoint_every=2)
    assert _pooled(pool, kw, pop_kw, stop_after_step=3, **ck) is None
    _bitwise(_pooled(pool, kw, pop_kw, resume=True, **ck), full)


def test_jax_checkpoint_resumes_in_the_port(pool, tmp_path):
    """The JAX engine stops at round 3; the port loads its carry (banks,
    owners and FedDyn's banked duals) bitwise and finishes within the bar
    of JAX's uninterrupted run."""
    kw = dict(BASE, scheme="a_dsgd", local="feddyn", local_epochs=2,
              dyn_alpha=0.2)
    pop_kw = dict(avail_rate=0.9, capacity=16, bank_size=8)
    ck = dict(checkpoint_dir=str(tmp_path), checkpoint_every=3)
    assert _jax_pooled(pool, kw, pop_kw, stop_after_step=3, **ck) is None
    path = str(tmp_path / "engine_ckpt.npz")
    saved = np.load(path)
    loaded, t0 = load_checkpoint(path, "cpu")
    assert t0 == 3
    for i, name in ((2, "deltas"), (3, "deltas"), (2, "owner")):
        j = 0 if name == "deltas" else 1
        np.testing.assert_array_equal(loaded["carry"][i][j].numpy(),
                                      saved[f"state/carry/#{i}/#{j}"])
    got = _pooled(pool, kw, pop_kw, resume=True, **ck)
    _close(got, _jax_pooled(pool, kw, pop_kw))


def test_population_grid_equals_its_points_and_the_reference(pool):
    """run_population_sweep over avail_rate x k_active and a static
    n_sites: every record is its own run_population bitwise, and the
    reference's grid within the bar."""
    xtr, ytr, xte, yte = pool
    kw = dict(BASE, scheme="a_dsgd")
    part = population_partition(ytr, m=40, b=16, kind="iid", seed=0)
    pdata = tpop.PopulationData.from_pool(xtr, ytr, part, **CPU)
    pop = tpop.PopulationConfig(m_total=40, k_cohort=8)
    axes = {"avail_rate": [0.5, 1.0], "k_active": [4, 8],
            "n_sites": [1, 2]}
    res = run_population_sweep(pdata, (xte, yte), OTAConfig(**kw), pop,
                               axes, steps=STEPS, eval_every=EVERY, **CPU)
    jpart = jax_partition(ytr, m=40, b=16, kind="iid", seed=0)
    ref = jax_pop_sweep(jpop.PopulationData.from_pool(xtr, ytr, jpart),
                        (xte, yte), JaxOTAConfig(**kw),
                        jpop.PopulationConfig(m_total=40, k_cohort=8), axes,
                        steps=STEPS, eval_every=EVERY)
    assert len(res.records) == 8
    for rec in res.records:
        exp = tpop.PopulationExperiment(
            cfg=OTAConfig(**kw), pop=dataclasses.replace(
                pop, n_sites=rec["n_sites"]), steps=STEPS,
            eval_every=EVERY)
        cp = tpop.CompiledPopulation(pdata, xte, yte, exp, **CPU)
        own = cp.run({"avail_rate": rec["avail_rate"],
                      "k_active": rec["k_active"]},
                     engine.round_keys(STEPS, 0, "cpu"))
        losses = own["loss"].numpy()[engine.eval_indices(STEPS, EVERY)]
        assert rec["losses"] == losses.tolist()
        want = ref.record(avail_rate=rec["avail_rate"],
                          k_active=rec["k_active"], n_sites=rec["n_sites"])
        assert rec["accs"] == want["accs"]
        np.testing.assert_allclose(rec["losses"], want["losses"], rtol=0,
                                   atol=1e-5)
    # the default point is the plain run_population
    plain = _pooled(pool, kw, {})
    rec = res.record(avail_rate=1.0, k_active=8, n_sites=1)
    assert rec["accs"] == plain.accs and rec["losses"] == plain.losses


def test_population_grid_of_local_and_digital_axes(data):
    """dyn_alpha and a digital scheme's q_t schedule ride the population
    grid: each record its own run_population (K == M dense data)."""
    xd, yd, xte, yte = data
    pdata = tpop.PopulationData.from_dense(xd, yd, **CPU)
    pop = tpop.PopulationConfig(m_total=M, k_cohort=M)
    base = dict(BASE, scheme="d_dsgd", local="feddyn", local_epochs=2)
    res = run_population_sweep(pdata, (xte, yte), OTAConfig(**base), pop,
                               {"dyn_alpha": [0.0, 0.3],
                                "p_avg": [200.0, 500.0]},
                               steps=STEPS, eval_every=EVERY, **CPU)
    for rec in res.records:
        own = tpop.run_population(
            pdata, xte, yte, OTAConfig(**dict(base,
                                              dyn_alpha=rec["dyn_alpha"],
                                              p_avg=rec["p_avg"])), pop,
            steps=STEPS, lr=1e-3, eval_every=EVERY, **CPU)
        assert rec["accs"] == own.accs and rec["losses"] == own.losses
