"""The robustness axis through the port's runs, repro_torch against repro:
run_compiled with faults, defences and each guard rail, checkpointed
resume with the guard state, the robust sweep grid, and run_federated,
which ignores the robust fields as the reference's looped driver does.

Data as tests/test_experiments.py: M = 4 devices of B = 64 samples, dim 48
(d = 490), 6 rounds, evaluated every 2.  Against the JAX engine,
accuracies and the guard's columns are equal, losses within 1e-5 (the
loss sums in another order than XLA's, ROADMAP queue 3).  The port's own
runs (a resume, a grid point) are bitwise.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.base import OTAConfig as JaxOTAConfig
from repro.experiments import engine as jeng
from repro.experiments import run_sweep as jax_run_sweep
from repro.robust import GuardConfig as JaxGuardConfig
from repro.train import paper_repro as jpr
from repro_torch.configs.base import OTAConfig
from repro_torch.data import federated_split, make_classification
from repro_torch.experiments import engine, run_sweep, sweep
from repro_torch.robust import GuardConfig
from repro_torch.train import paper_repro as tpr

STEPS, EVERY, M, B = 6, 2, 4, 64
CPU = dict(device="cpu")

BASE = dict(s_frac=0.5, k_frac=0.25, p_avg=500.0, total_steps=STEPS,
            projection="dense", amp_iters=6, mean_removal_steps=2)

#: name -> (config fields, guard fields or None)
RUNS = {
    # Fig. 11's analog cell: a sign-flip attacker at 20x, the power cap on
    "analog_capped": (dict(scheme="a_dsgd", byzantine_frac=0.5,
                           byz_scale=20.0, clip_power=True,
                           power_cap=1.5), None),
    # Fig. 11's digital cell: the norm cap against 30 % attackers
    "digital_norm_cap": (dict(scheme="d_dsgd", byzantine_frac=0.3,
                              byz_scale=20.0, aggregator="norm_cap",
                              norm_cap=1.5), None),
    "digital_trimmed": (dict(scheme="d_dsgd", byzantine_frac=0.3,
                             aggregator="trimmed_mean", trim_frac=0.25,
                             fault_rate=0.3, fault_kind="stale",
                             erasure_prob=0.2), None),
    # NaN frames under the skip rail
    "nan_skip": (dict(scheme="a_dsgd", fault_rate=0.3, fault_kind="nan"),
                 dict()),
    "inf_skip_clip": (dict(scheme="a_dsgd", fault_rate=0.3,
                           fault_kind="inf"), dict(update_clip=0.05)),
    # an attack that makes the loss climb: the divergence rail backs off
    "diverge": (dict(scheme="d_dsgd", byzantine_frac=0.5, byz_scale=50.0),
                dict(divergence_factor=1.0, cooldown=2)),
    "dropout_blocked": (dict(scheme="a_dsgd", fault_rate=0.3,
                             fault_kind="dropout", projection="blocked",
                             block_size=64, use_kernel=True), None),
}


@pytest.fixture(scope="module")
def data():
    (xtr, ytr), (xte, yte) = make_classification(
        n_train=800, n_test=300, dim=48, noise=2.0, seed=3)
    xd, yd = federated_split(xtr, ytr, m=M, b=B, iid=True, seed=0)
    return xd, yd, xte, yte


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one intra-op thread (thousands of small ops, which a
    parallel run's busy cores slow with a pool of threads to wake)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name):
    over, guard = RUNS[name]
    kw = {**BASE, **over}
    return (JaxOTAConfig(**kw), OTAConfig(**kw),
            None if guard is None else JaxGuardConfig(**guard),
            None if guard is None else GuardConfig(**guard))


def _port(data, name, **kw):
    _, cfg, _, guard = _cfgs(name)
    return engine.run_compiled(*data, cfg, steps=STEPS, lr=1e-3,
                               eval_every=EVERY, guard=guard, **CPU, **kw)


def _jax(data, name, **kw):
    cfg, _, guard, _ = _cfgs(name)
    return jeng.run_compiled(*data, cfg, steps=STEPS, lr=1e-3,
                             eval_every=EVERY, guard=guard, **kw)


def _bitwise(a, b):
    assert a.accs == b.accs and a.losses == b.losses
    assert a.metrics == b.metrics
    np.testing.assert_array_equal(a.all_losses.view(np.int32),
                                  b.all_losses.view(np.int32))
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k


@pytest.mark.parametrize("name", list(RUNS))
def test_run_compiled_matches_jax_engine(data, name):
    """Accuracies equal, losses within 1e-5 where finite and NaN where the
    reference's are, the fault and guard columns equal."""
    got, want = _port(data, name), _jax(data, name)
    np.testing.assert_array_equal(np.isnan(got.all_losses),
                                  np.isnan(want.all_losses))
    ok = np.isfinite(want.all_losses)
    np.testing.assert_allclose(got.all_losses[ok], want.all_losses[ok],
                               rtol=0, atol=1e-5)
    assert got.all_accs.tolist() == want.all_accs.tolist()
    for mg, mw in zip(got.metrics, want.metrics):
        assert set(mg) == set(mw)
        for k in ("byz_frac", "fault_frac", "active_frac", "guard_skipped",
                  "guard_backoff", "guard_lr_scale"):
            if k in mw:
                assert mg[k] == mw[k], k
    if name == "nan_skip":
        assert sum(m["guard_skipped"] for m in got.metrics) > 0
    if name == "diverge":
        assert sum(m["guard_backoff"] for m in got.metrics) > 0


def test_unguarded_nan_faults_reach_the_weights(data):
    """Without a guard a poisoned round's NaN decode reaches Adam, and the
    test loss goes NaN in the same round as the reference's."""
    kw = {**BASE, "scheme": "a_dsgd", "fault_rate": 0.3, "fault_kind": "nan"}
    got = engine.run_compiled(*data, OTAConfig(**kw), steps=STEPS, lr=1e-3,
                              eval_every=EVERY, **CPU)
    want = jeng.run_compiled(*data, JaxOTAConfig(**kw), steps=STEPS,
                             lr=1e-3, eval_every=EVERY)
    assert np.isnan(want.all_losses).any()
    np.testing.assert_array_equal(np.isnan(got.all_losses),
                                  np.isnan(want.all_losses))
    assert got.all_accs.tolist() == want.all_accs.tolist()


@pytest.mark.parametrize("scheme", ["a_dsgd", "d_dsgd"])
def test_robust_zero_rates_is_bitwise_the_plain_run(data, scheme):
    """``robust=True`` with zero rates (and at ``byzantine_frac`` 0 the power
    cap, under which honest frames pass with scale 1.0) takes
    ``round_masked`` and equals the plain run's accuracies, losses and
    params bitwise."""
    cfg = OTAConfig(**BASE, scheme=scheme)
    plain = engine.run_compiled(*data, cfg, steps=STEPS, eval_every=EVERY,
                                **CPU)
    robust = engine.run_compiled(
        *data, dataclasses.replace(cfg, robust=True,
                                   clip_power=scheme == "a_dsgd"),
        steps=STEPS, eval_every=EVERY, **CPU)
    assert robust.accs == plain.accs and robust.losses == plain.losses
    for k in plain.params:
        assert torch.equal(robust.params[k], plain.params[k])
    assert all(m["byz_frac"] == 0.0 for m in robust.metrics)


@pytest.mark.parametrize("name", ["nan_skip", "diverge"])
def test_guarded_resume_is_bitwise(data, tmp_path, name):
    """Stopped at round 2 and resumed: bitwise the uninterrupted run, the
    guard's state carried through the file."""
    full = _port(data, name)
    kw = dict(checkpoint_dir=str(tmp_path), checkpoint_every=2)
    assert _port(data, name, stop_after_step=2, **kw) is None
    _bitwise(_port(data, name, resume=True, **kw), full)


def test_jax_guarded_checkpoint_resumes_in_the_port(data, tmp_path):
    """The JAX engine's guarded run stops at round 3; the port finishes it
    from that file: the guard's columns are the reference's and the losses
    within 1e-5 of its uninterrupted run."""
    kw = dict(checkpoint_dir=str(tmp_path), checkpoint_every=3)
    assert _jax(data, "nan_skip", stop_after_step=3, **kw) is None
    got = _port(data, "nan_skip", resume=True, **kw)
    want = _jax(data, "nan_skip")
    np.testing.assert_allclose(got.all_losses, want.all_losses, rtol=0,
                               atol=1e-5)
    assert [m["guard_skipped"] for m in got.metrics] == \
        [m["guard_skipped"] for m in want.metrics]


def test_run_grid_with_a_guard_equals_each_point(data):
    """A guarded grid over the fault rate carries one guard state and one
    step count per point: each point is its own guarded run, bitwise."""
    _, cfg, _, guard = _cfgs("nan_skip")
    ce = engine.CompiledExperiment(*data, engine.Experiment(
        cfg=cfg, steps=STEPS, eval_every=EVERY, guard=guard), device="cpu")
    grid = [{"fault_rate": r} for r in (0.0, 0.3, 0.6)]
    ov, keys, _ = sweep.grid_inputs(ce, grid, STEPS)
    outs = ce.run_grid(ov, keys)
    for g, point in enumerate(grid):
        one = engine.run_compiled(*data, dataclasses.replace(cfg, **point),
                                  steps=STEPS, eval_every=1, guard=guard,
                                  **CPU)
        assert outs["loss"][g].numpy().tolist() == one.all_losses.tolist()
        assert outs["metrics"]["guard_skipped"][g].tolist() == \
            [m["guard_skipped"] for m in one.metrics]


@pytest.fixture(scope="module")
def robust_grids(data):
    """The port's and the reference's sweep over byzantine_frac x
    clip_power (two static groups of G = 2)."""
    axes = {"byzantine_frac": [0.0, 0.5], "clip_power": [False, True]}
    kw = {**BASE, "scheme": "a_dsgd", "byz_scale": 20.0}
    xd, yd, xt, yt = data
    n = torch.get_num_threads()
    torch.set_num_threads(1)        # as the tests' own runs (the fixture
    try:                            # is built before theirs)
        got = run_sweep((xd, yd), (xt, yt), OTAConfig(**kw), axes,
                        steps=STEPS, eval_every=EVERY, **CPU)
    finally:
        torch.set_num_threads(n)
    want = jax_run_sweep((xd, yd), (xt, yt), JaxOTAConfig(**kw), axes,
                         steps=STEPS, eval_every=EVERY)
    return kw, got, want


def test_robust_sweep_equals_each_points_run(data, robust_grids):
    """Every record is its point's own robust run_compiled, bitwise."""
    kw, got, _ = robust_grids
    assert len(got.records) == 4
    for rec in got.records:
        one = engine.run_compiled(*data, OTAConfig(
            **kw, robust=True, byzantine_frac=rec["byzantine_frac"],
            clip_power=rec["clip_power"]), steps=STEPS, eval_every=EVERY,
            **CPU)
        assert rec["accs"] == one.accs and rec["losses"] == one.losses
        assert rec["metrics"] == one.metrics


def test_robust_sweep_matches_reference_grid(robust_grids):
    """Against the reference's vmapped grid: accuracies equal, losses within
    1e-5, the fault columns equal."""
    _, got, want = robust_grids
    for rw in want.records:
        rg = got.record(byzantine_frac=rw["byzantine_frac"],
                        clip_power=rw["clip_power"])
        assert rg["accs"] == rw["accs"]
        np.testing.assert_allclose(rg["losses"], rw["losses"], rtol=0,
                                   atol=1e-5)
        for mg, mw in zip(rg["metrics"], rw["metrics"]):
            assert set(mg) == set(mw)
            assert mg["byz_frac"] == mw["byz_frac"]


def test_run_federated_ignores_the_robust_fields(data):
    """The looped driver runs a robust config through round_simulated with
    no fault injection, in the port as in the reference: equal to the plain
    config's run, and to the reference's within 1e-5."""
    kw = {**BASE, **RUNS["analog_capped"][0], "fault_rate": 0.3}
    got = tpr.run_federated(*data, OTAConfig(**kw), steps=STEPS,
                            eval_every=EVERY, **CPU)
    plain = tpr.run_federated(*data, OTAConfig(**BASE, scheme="a_dsgd"),
                              steps=STEPS, eval_every=EVERY, **CPU)
    assert got.accs == plain.accs and got.losses == plain.losses
    want = jpr.run_federated(*data, JaxOTAConfig(**kw), steps=STEPS,
                             eval_every=EVERY)
    assert got.accs == want.accs
    np.testing.assert_allclose(got.losses, want.losses, rtol=0, atol=1e-5)
    assert "byz_frac" not in got.metrics[0]
