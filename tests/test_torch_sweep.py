"""The sweep grid and the point axis under it, repro_torch against itself and
against repro.

The port's ``run_sweep`` runs each static group's points as one batched
round per step (``CompiledExperiment.run_grid``); each record must equal
the port's own per-point run entry for entry (the reference's pin,
``tests/test_experiments.py:93-107``), and the grid must match the
reference's ``run_sweep``.  Data as tests/test_experiments.py: M = 4 devices
of B = 64 samples, dim 48, 6 rounds, evaluated every 2.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.base import OTAConfig as JaxOTAConfig
from repro.experiments import run_sweep as jax_run_sweep
from repro_torch import rng
from repro_torch.configs.base import OTAConfig
from repro_torch.core import amp, channel
from repro_torch.core.projection import BlockedProjector
from repro_torch.core.schemes import (
    PAPER_SCHEMES, MACContext, get_scheme, round_simulated,
)
from repro_torch.data import federated_split, make_classification
from repro_torch.experiments import engine, sweep
from repro_torch.experiments import (
    LOCAL_VMAP_AXES, ROBUST_VMAP_AXES, SCALAR_VMAP_AXES, eval_indices,
    run_population_sweep, run_sweep,
)
from repro_torch.kernels import ops
from repro_torch.optim.optim import Optimizer
from repro_torch.train import paper_repro as tpr

STEPS, EVERY, M, B = 6, 2, 4, 64
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def data():
    (xtr, ytr), (xte, yte) = make_classification(
        n_train=800, n_test=300, dim=48, noise=2.0, seed=3)
    xd, yd = federated_split(xtr, ytr, m=M, b=B, iid=True, seed=0)
    return (xd, yd), (xte, yte)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one intra-op thread (thousands of small ops, which a
    parallel run's busy cores slow with a pool of threads to wake)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _adsgd(**kw):
    base = dict(scheme="a_dsgd", s_frac=0.5, k_frac=0.25, p_avg=500.0,
                total_steps=STEPS, projection="dense", amp_iters=6,
                mean_removal_steps=2)
    base.update(kw)
    return OTAConfig(**base)


BASES = {
    "a_dsgd_dense": _adsgd(),
    "a_dsgd_blocked_kernel": _adsgd(projection="blocked", block_size=64,
                                    use_kernel=True),
    "ideal": OTAConfig(scheme="ideal", total_steps=STEPS),
    "d_dsgd": OTAConfig(scheme="d_dsgd", s_frac=0.5, total_steps=STEPS),
    "signsgd": OTAConfig(scheme="signsgd", s_frac=0.5, total_steps=STEPS),
    "qsgd": OTAConfig(scheme="qsgd", s_frac=0.5, total_steps=STEPS),
}


def _loop(data, cfg, **kw):
    (xd, yd), (xte, yte) = data
    return tpr.run_federated(xd, yd, xte, yte, cfg, steps=STEPS, lr=1e-3,
                             eval_every=EVERY, **CPU, **kw)


def _sweep(data, cfg, axes, **kw):
    return run_sweep(*data, cfg, axes, steps=STEPS, eval_every=EVERY, **CPU,
                     **kw)


def _same(rec, run):
    assert rec["accs"] == run.accs
    assert rec["losses"] == run.losses
    assert rec["metrics"] == run.metrics


# ---------------------------------------------------------------------------
# each record == its own per-point run (the reference's pins, mirrored)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(BASES))
def test_sweep_vmapped_p_grid_matches_looped_runs(data, name):
    """The batched P-bar axis reproduces per-point looped runs entry for
    entry: analog (power schedule), ideal, and digital (q schedule under
    the shared static q_max)."""
    base = BASES[name]
    res = _sweep(data, base, {"p_avg": [50.0, 500.0]})
    for p in (50.0, 500.0):
        _same(res.record(p_avg=p),
              _loop(data, dataclasses.replace(base, p_avg=p)))


@pytest.mark.parametrize("name", ["d_dsgd", "a_dsgd_dense"])
def test_sweep_power_schedule_axis(data, name):
    """power_schedule rides the same (T,) schedule array."""
    base = dataclasses.replace(BASES[name], p_avg=200.0)
    res = _sweep(data, base, {"power_schedule": ["constant", "hl_steps"]})
    for sched in ("constant", "hl_steps"):
        _same(res.record(power_schedule=sched),
              _loop(data, dataclasses.replace(base, power_schedule=sched)))


def test_m_active_full_mask_matches_unmasked(data):
    (xd, yd), (xte, yte) = data
    cfg = _adsgd()
    res = _sweep(data, cfg, {"m_active": [3, M]})
    full = _loop(data, cfg)
    _same(res.record(m_active=M), full)
    assert res.record(m_active=3)["accs"] != full.accs
    # the 3-device point is the masked run of its own
    ce = engine.CompiledExperiment(xd, yd, xte, yte, engine.Experiment(
        cfg=cfg, steps=STEPS, eval_every=EVERY), **CPU)
    outs = ce.run_masked({}, engine.round_keys(STEPS, 0, "cpu"),
                         torch.tensor([1.0, 1.0, 1.0, 0.0]))
    masked = engine._subsample(outs, ce.exp)
    assert res.record(m_active=3)["accs"] == masked.accs
    assert res.record(m_active=3)["losses"] == masked.losses


def test_m_active_ideal_mask_equals_true_subset(data):
    """The ideal link has no encode RNG, so masking M_pad -> 2 devices is a
    genuine 2-device run, entry for entry."""
    (xd, yd), (xte, yte) = data
    cfg = OTAConfig(scheme="ideal", total_steps=STEPS)
    res = _sweep(data, cfg, {"m_active": [2, 4]})
    two = tpr.run_federated(xd[:2], yd[:2], xte, yte, cfg, steps=STEPS,
                            lr=1e-3, eval_every=EVERY, **CPU)
    assert res.record(m_active=2)["accs"] == two.accs
    assert res.record(m_active=2)["losses"] == two.losses


@pytest.mark.parametrize("name", ["d_dsgd", "qsgd"])
def test_m_active_digital_budget_tracks_the_point(data, name):
    """A digital point's q_t schedule is built with its effective device
    count, and the point equals its masked run with that schedule."""
    (xd, yd), (xte, yte) = data
    cfg = BASES[name]
    res = _sweep(data, cfg, {"m_active": [2, 4]})
    _same(res.record(m_active=4), _loop(data, cfg))
    ce = engine.CompiledExperiment(xd, yd, xte, yte, engine.Experiment(
        cfg=cfg, steps=STEPS, eval_every=EVERY), **CPU)
    q2 = ce.scheme.build_q_schedule(2, ce.scheme._p_np)
    assert not np.array_equal(q2, ce.scheme.q_sched.numpy())
    ce.scheme.q_max = int(max(q2.max(), ce.scheme.q_sched.max(), 1))
    outs = ce.run_masked({"q_sched": torch.from_numpy(q2)},
                         engine.round_keys(STEPS, 0, "cpu"),
                         torch.tensor([1.0, 1.0, 0.0, 0.0]))
    masked = engine._subsample(outs, ce.exp)
    assert res.record(m_active=2)["accs"] == masked.accs
    assert res.record(m_active=2)["metrics"] == masked.metrics


def test_seed_axis_changes_channel_noise(data):
    (xd, yd), (xte, yte) = data
    res = _sweep(data, _adsgd(), {"seed": [0, 1]})
    r0, r1 = res.record(seed=0), res.record(seed=1)
    assert r0["accs"] != r1["accs"]           # different AWGN draws
    _same(r0, _loop(data, _adsgd()))          # seed 0: the reference stream
    one = engine.run_compiled(xd, yd, xte, yte, _adsgd(), steps=STEPS,
                              eval_every=EVERY, seed=1, **CPU)
    assert r1["accs"] == one.accs and r1["losses"] == one.losses


def test_sweep_result_schema(data):
    res = _sweep(data, _adsgd(), {"scheme": ["a_dsgd", "d_dsgd"],
                                  "p_avg": [500.0]})
    assert len(res.records) == 2
    n_evals = len(eval_indices(STEPS, EVERY))
    for rec in res.records:
        assert rec["scheme"] in ("a_dsgd", "d_dsgd")
        assert len(rec["accs"]) == n_evals
        assert rec["final_acc"] == rec["accs"][-1]
        assert rec["us_per_call"] > 0
        assert len(rec["metrics"]) == n_evals
    assert set(res.record(scheme="d_dsgd")["metrics"][0]) == {
        "q_t", "p_t", "active_frac"}
    with pytest.raises(KeyError):
        res.record(scheme="qsgd")


def test_sweep_unknown_axis_raises(data):
    with pytest.raises(KeyError, match="unknown sweep axis"):
        run_sweep(*data, _adsgd(), {"warp_factor": [9]}, steps=2, **CPU)
    with pytest.raises(ValueError, match="empty"):
        run_sweep(*data, _adsgd(), {"p_avg": []}, steps=2, **CPU)
    with pytest.raises(ValueError, match="M_pad"):
        run_sweep(*data, _adsgd(), {"m_active": [M + 1]}, steps=2, **CPU)


@pytest.mark.parametrize("axis", ROBUST_VMAP_AXES + LOCAL_VMAP_AXES)
def test_unported_vmapped_axes_raise(data, axis):
    """The robustness and local-compute axes are ported (the channel
    scalars too: tests/test_torch_channel.py): a one-point sweep over one
    equals its own run_compiled (a robust axis turns on the fault path;
    tests/test_torch_robust_engine.py and tests/test_torch_local_engine.py
    hold the grids).  (The name dates from when these axes raised.)"""
    (xd, yd), (xt, yt) = data
    if axis in LOCAL_VMAP_AXES:
        value = 2 if axis == "local_epochs" else 0.1
        base = _adsgd(local="feddyn")
        res = run_sweep(*data, base, {axis: [value]}, steps=2, **CPU)
        own = engine.run_compiled(xd, yd, xt, yt,
                                  dataclasses.replace(base, **{axis: value}),
                                  steps=2, eval_every=10, **CPU)
        rec, = res.records
        assert rec["accs"] == own.accs and rec["losses"] == own.losses
        return
    res = run_sweep(*data, _adsgd(), {axis: [0.1]}, steps=2, **CPU)
    own = engine.run_compiled(xd, yd, xt, yt,
                              _adsgd(robust=True, **{axis: 0.1}),
                              steps=2, eval_every=10, **CPU)
    rec, = res.records
    assert rec["accs"] == own.accs and rec["losses"] == own.losses
    assert "byz_frac" in rec["metrics"][0]


def test_population_sweep_raises(data):
    """run_population_sweep is ported (tests/test_torch_population_engine.py
    holds its grids); the dense engine's m_active axis and a k_active past
    the cohort still raise, as in the reference.  (The name dates from when
    the whole sweep raised.)"""
    from repro_torch.population import PopulationConfig, PopulationData
    (xd, yd), _ = data
    pdata = PopulationData.from_dense(xd, yd, device="cpu")
    pop = PopulationConfig(m_total=M, k_cohort=M)
    with pytest.raises(KeyError, match="k_active"):
        run_population_sweep(pdata, data[1], _adsgd(), pop,
                             {"m_active": [2]}, steps=2, **CPU)
    with pytest.raises(ValueError, match="k_cohort"):
        run_population_sweep(pdata, data[1], _adsgd(), pop,
                             {"k_active": [M + 1]}, steps=2, **CPU)
    res = run_population_sweep(pdata, data[1], _adsgd(), pop,
                               {"k_active": [M]}, steps=2, **CPU)
    assert len(res.records) == 1


# ---------------------------------------------------------------------------
# against the reference's run_sweep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("projection", ["dense", "blocked"])
def test_sweep_matches_reference_sweep(data, projection):
    """{scheme: PAPER_SCHEMES} x {p_avg: [50, 500]}: accuracies equal,
    losses within 1e-5, metrics within rtol 1e-5 of the reference's
    vmapped grid."""
    kw = dict(s_frac=0.5, k_frac=0.25, total_steps=STEPS, amp_iters=6,
              mean_removal_steps=2, projection=projection, block_size=64)
    axes = {"scheme": list(PAPER_SCHEMES), "p_avg": [50.0, 500.0]}
    want = jax_run_sweep(*data, JaxOTAConfig(**kw), axes, steps=STEPS,
                         eval_every=EVERY)
    got = _sweep(data, OTAConfig(**kw), axes)
    assert len(got.records) == len(want.records) == 10
    for rw in want.records:
        rg = got.record(scheme=rw["scheme"], p_avg=rw["p_avg"])
        assert rg["accs"] == rw["accs"], (rw["scheme"], rw["p_avg"])
        np.testing.assert_allclose(rg["losses"], rw["losses"], rtol=0,
                                   atol=1e-5)
        for mg, mw in zip(rg["metrics"], rw["metrics"]):
            assert set(mg) == set(mw)
            for k in mw:
                np.testing.assert_allclose(mg[k], mw[k], rtol=1e-5)


# ---------------------------------------------------------------------------
# the engine's overrides and grid entry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["a_dsgd_dense", "d_dsgd"])
def test_run_segment_overrides_swap_the_schedules(data, name):
    """A (T,) p_sched (and q_sched) override on a P-bar = 500 runner is the
    P-bar = 50 run, as the reference's run_segment swaps them."""
    (xd, yd), (xte, yte) = data
    base = BASES[name]
    ce = engine.CompiledExperiment(xd, yd, xte, yte, engine.Experiment(
        cfg=base, steps=STEPS, eval_every=EVERY), **CPU)
    other = get_scheme(dataclasses.replace(base, p_avg=50.0), ce.d, M,
                       device="cpu")
    ov = {"p_sched": other.p_sched}
    if hasattr(other, "q_sched"):
        ov["q_sched"] = other.q_sched
        ce.scheme.q_max = max(ce.scheme.q_max, other.q_max)
    outs = ce.run(ov, engine.round_keys(STEPS, 0, "cpu"))
    got = engine._subsample(outs, ce.exp)
    want = _loop(data, dataclasses.replace(base, p_avg=50.0))
    assert got.accs == want.accs and got.losses == want.losses
    assert got.metrics == want.metrics
    with pytest.raises(AttributeError, match="no attribute"):
        ce.run({"warp": torch.ones(STEPS)}, engine.round_keys(STEPS, 0,
                                                              "cpu"))


def test_run_grid_checks_its_points(data):
    (xd, yd), (xte, yte) = data
    ce = engine.CompiledExperiment(xd, yd, xte, yte, engine.Experiment(
        cfg=_adsgd(), steps=2), **CPU)
    keys = torch.stack([engine.round_keys(2, s, "cpu") for s in (0, 1)])
    with pytest.raises(ValueError, match="points"):
        ce.run_grid({"p_sched": torch.ones(3, STEPS)}, keys)
    outs = ce.run_grid({}, keys)
    assert outs["acc"].shape == (2, 2) and outs["params"]["w"].shape[0] == 2


# ---------------------------------------------------------------------------
# the point axis, layer by layer: each point equals its own call
# ---------------------------------------------------------------------------


def _points(n, shape, seed):
    rs = np.random.default_rng(seed)
    return torch.from_numpy(rs.standard_normal((n, *shape)).astype(
        np.float32))


def test_rng_channel_and_normalize_take_a_point_axis():
    keys = rng.split(rng.PRNGKey(3), 3)
    frames = _points(3, (5, 18), 1)
    y = channel.mac_sum(frames, keys, 1.0)
    norm = channel.ps_normalize(y + 10.0, True)
    for g in range(3):
        one = channel.mac_sum(frames[g], keys[g], 1.0)
        assert torch.equal(y[g], one)
        assert torch.equal(norm[g], channel.ps_normalize(one + 10.0, True))


@pytest.mark.parametrize("rademacher", [True, False])
def test_projection_and_amp_take_a_point_axis(rademacher):
    proj = BlockedProjector(d=200, block_size=64, s_block=32, seed=5,
                            rademacher=rademacher, use_kernel=True)
    v = _points(3, (4, 200), 2)
    yb = proj.project(v)
    for g in range(3):
        assert torch.equal(yb[g], proj.project(v[g]))
    y = yb[:, 0] + 0.01 * _points(3, (proj.out_dim,), 3)
    x = amp.amp_decode(y, proj, iters=6)
    xb = ops.amp_decode_fused(y.reshape(3, proj.n_blocks, 32), seed=5, c=64,
                              iters=6, rademacher=rademacher)
    plain = dataclasses.replace(proj, use_kernel=False)
    x_plain = amp.amp_decode(y, plain, iters=6)
    for g in range(3):
        assert torch.equal(x[g], amp.amp_decode(y[g], proj, iters=6))
        assert torch.equal(xb[g], ops.amp_decode_fused(
            y[g].reshape(proj.n_blocks, 32), seed=5, c=64, iters=6,
            rademacher=rademacher))
        assert torch.equal(x_plain[g], amp.amp_decode(y[g], plain, iters=6))


def test_model_and_adam_take_a_point_axis(data):
    """device_grads, accuracy and ce_loss per point; Adam is elementwise,
    so a (G, ...) update is each point's update bitwise."""
    (xd, yd), (xte, yte) = data
    xd, yd = torch.from_numpy(xd), torch.from_numpy(yd).long()
    xt, yt = torch.from_numpy(xte), torch.from_numpy(yte).long()
    params = {"b": 0.1 * _points(3, (10,), 4),
              "w": 0.1 * _points(3, (48, 10), 5)}
    mom = _points(3, (M, 490), 6)
    grads, mom2 = tpr.device_grads(params, xd, yd, mom,
                                   momentum_correction=0.5)
    acc, loss = tpr.accuracy(params, xt, yt), tpr.ce_loss(params, xt, yt)
    opt = Optimizer(lr=1e-2)
    state = opt.init(params)
    ghat = grads.mean(dim=1)
    new, st = opt.apply(params, tpr.unravel(ghat, params, batch_dims=1),
                        state)
    new, st = opt.apply(new, tpr.unravel(ghat, params, batch_dims=1), st)
    for g in range(3):
        one = {k: v[g] for k, v in params.items()}
        g1, m1 = tpr.device_grads(one, xd, yd, mom[g],
                                  momentum_correction=0.5)
        assert torch.equal(grads[g], g1) and torch.equal(mom2[g], m1)
        assert torch.equal(acc[g], tpr.accuracy(one, xt, yt))
        assert torch.equal(loss[g], tpr.ce_loss(one, xt, yt))
        s1 = opt.init(one)
        n1, s1 = opt.apply(one, tpr.unravel(ghat[g], one), s1)
        n1, s1 = opt.apply(n1, tpr.unravel(ghat[g], one), s1)
        for k in one:
            assert torch.equal(new[k][g], n1[k])
            assert torch.equal(st["m"][k][g], s1["m"][k])
            assert torch.equal(st["v"][k][g], s1["v"][k])


@pytest.mark.parametrize("name", list(BASES))
def test_round_takes_a_point_axis(data, name):
    """round_simulated with (G, M, d) gradients, (G, 2) keys and (G, T)
    schedules: each point's ghat, error state and metrics are its own
    round's, bitwise."""
    (xd, yd), _ = data
    cfg = BASES[name]
    params = tpr.init_linear(48, 10, "cpu")
    grads, _ = tpr.device_grads(params, torch.from_numpy(xd),
                                torch.from_numpy(yd).long(), None)
    g3 = grads[None] + 0.01 * _points(3, tuple(grads.shape), 7)
    d3 = 0.01 * _points(3, tuple(grads.shape), 8)
    keys = rng.split(rng.PRNGKey(1002), 3)
    schemes = [get_scheme(dataclasses.replace(cfg, p_avg=p), grads.shape[1],
                          M, device="cpu") for p in (20.0, 500.0, 5000.0)]
    ov = {"p_sched": torch.stack([s.p_sched for s in schemes])}
    if hasattr(schemes[0], "q_sched"):
        ov["q_sched"] = torch.stack([s.q_sched for s in schemes])
    grid = schemes[1].with_overrides(**ov)
    grid.q_max = max(getattr(s, "q_max", 1) for s in schemes)
    ctx = MACContext(m=M, use_kernel=cfg.use_kernel)
    gh, dl, met = round_simulated(grid, g3, d3, 1, keys, ctx)
    for g, sch in enumerate(schemes):
        gh1, dl1, met1 = round_simulated(sch, g3[g], d3[g], 1, keys[g], ctx)
        assert torch.equal(gh[g], gh1) and torch.equal(dl[g], dl1)
        assert set(met) == set(met1)
        for k in met1:
            assert torch.equal(met[k][g], met1[k]), k


def test_axis_names_mirror_reference():
    """The sweep module's axis names are the reference's."""
    import repro.experiments.sweep as jsweep
    for name in ("VMAP_AXES", "SCALAR_VMAP_AXES", "POP_VMAP_AXES",
                 "ROBUST_VMAP_AXES", "LOCAL_VMAP_AXES"):
        assert getattr(sweep, name) == tuple(getattr(jsweep, name))
