"""The experiment engine and checkpointed resume, repro_torch against repro.

Data as tests/test_experiments.py: M = 4 devices of B = 64 samples, dim 48,
6 rounds, evaluated every 2.  The port's run_compiled must equal the port's
run_federated entry for entry; against the JAX engine, accuracies are
bitwise and losses within 1e-5 (the loss sums in another order than XLA's).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import OTAConfig as JaxOTAConfig
from repro.experiments import engine as jeng
from repro_torch import rng
from repro_torch.configs.base import OTAConfig
from repro_torch.core.schemes import get_scheme, round_simulated
from repro_torch.data import federated_split, make_classification
from repro_torch.experiments import engine
from repro_torch.robust import GuardConfig
from repro_torch.train import paper_repro as tpr
from repro_torch.train.checkpoint import load_checkpoint

STEPS, EVERY, M, B = 6, 2, 4, 64
CPU = dict(device="cpu")

CONFIGS = {
    "ideal": dict(scheme="ideal", s_frac=0.5, p_avg=500.0,
                  total_steps=STEPS),
    "a_dsgd_dense": dict(scheme="a_dsgd", s_frac=0.5, k_frac=0.25,
                         p_avg=500.0, total_steps=STEPS, projection="dense",
                         amp_iters=6, mean_removal_steps=2),
    "a_dsgd_blocked": dict(scheme="a_dsgd", s_frac=0.5, k_frac=0.25,
                           p_avg=500.0, total_steps=STEPS,
                           projection="blocked", block_size=64,
                           use_kernel=True, amp_iters=6,
                           mean_removal_steps=2),
}


@pytest.fixture(scope="module")
def data():
    (xtr, ytr), (xte, yte) = make_classification(
        n_train=800, n_test=300, dim=48, noise=2.0, seed=3)
    xd, yd = federated_split(xtr, ytr, m=M, b=B, iid=True, seed=0)
    return xd, yd, xte, yte


@pytest.fixture(scope="module")
def jax_runs(data):
    """The JAX engine's uninterrupted runs, one per configuration."""
    return {name: jeng.run_compiled(*data, JaxOTAConfig(**kw), steps=STEPS,
                                    lr=1e-3, eval_every=EVERY)
            for name, kw in CONFIGS.items()}


def _run(data, name, **kw):
    return engine.run_compiled(*data, OTAConfig(**CONFIGS[name]),
                               steps=STEPS, lr=1e-3, eval_every=EVERY,
                               **CPU, **kw)


def test_round_keys_and_eval_indices_match_reference():
    for seed in (0, 3):
        np.testing.assert_array_equal(
            engine.round_keys(STEPS, seed, "cpu").numpy(),
            np.asarray(jeng.round_keys(STEPS, seed)).astype(np.int64))
    for steps, every in ((6, 2), (7, 3), (1, 10)):
        np.testing.assert_array_equal(engine.eval_indices(steps, every),
                                      jeng.eval_indices(steps, every))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_run_compiled_matches_run_federated(data, name):
    """The engine == the port's looped driver, entry for entry."""
    ref = tpr.run_federated(*data, OTAConfig(**CONFIGS[name]), steps=STEPS,
                            lr=1e-3, eval_every=EVERY, **CPU)
    eng = _run(data, name)
    assert eng.accs == ref.accs
    assert eng.losses == ref.losses
    assert eng.metrics == ref.metrics
    assert list(eng.eval_steps) == [0, 2, 4, 5]
    for k in ref.params:
        assert torch.equal(eng.params[k], ref.params[k])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_run_compiled_matches_jax_engine(data, jax_runs, name):
    """Accuracies bitwise, losses within 1e-5, metrics within 1e-5."""
    want, got = jax_runs[name], _run(data, name)
    assert got.accs == want.accs
    np.testing.assert_allclose(got.all_losses, want.all_losses, rtol=0,
                               atol=1e-5)
    assert got.all_accs.tolist() == want.all_accs.tolist()
    for mg, mw in zip(got.metrics, want.metrics):
        assert set(mg) == set(mw)
        for k in mw:
            np.testing.assert_allclose(mg[k], mw[k], rtol=1e-5)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_round_masked_all_ones_is_round_simulated(data, name):
    xd, yd, _, _ = data
    cfg = OTAConfig(**CONFIGS[name])
    params = tpr.init_linear(xd.shape[-1], 10, "cpu")
    grads, _ = tpr.device_grads(params, torch.from_numpy(xd),
                                torch.from_numpy(yd).long(), None)
    rs = np.random.default_rng(0)
    deltas = torch.from_numpy(
        0.01 * rs.standard_normal(grads.shape).astype(np.float32))
    scheme = get_scheme(cfg, grads.shape[1], M, device="cpu")
    ctx = engine.MACContext(m=M, use_kernel=cfg.use_kernel)
    key = engine.round_keys(STEPS, 0, "cpu")[1]
    g0, d0, m0 = round_simulated(scheme, grads, deltas, 1, key, ctx)
    g1, d1, m1 = engine.round_masked(scheme, grads, deltas, 1, key,
                                     torch.ones(M), ctx)
    assert torch.equal(g0, g1) and torch.equal(d0, d1)
    # the dev_keys / draw hooks, given what the round would draw itself
    g2, d2, _ = engine.round_masked(
        scheme, grads, deltas, 1, key, torch.ones(M), ctx,
        dev_keys=rng.split(rng.fold_in(key, 1), M),
        draw=scheme.channel_draw(rng.fold_in(key, 2), 1, M))
    assert torch.equal(g0, g2) and torch.equal(d0, d2)
    assert set(m0) == set(m1)
    for k in m0:
        np.testing.assert_allclose(float(m1[k]), float(m0[k]), rtol=1e-6)


def test_ideal_masked_to_two_devices_is_a_two_device_run(data):
    xd, yd, xte, yte = data
    cfg = OTAConfig(**CONFIGS["ideal"])
    exp = engine.Experiment(cfg=cfg, steps=STEPS, eval_every=EVERY)
    ce = engine.CompiledExperiment(xd, yd, xte, yte, exp, device="cpu")
    outs = ce.run_masked({}, engine.round_keys(STEPS, 0, "cpu"),
                         torch.tensor([1.0, 1.0, 0.0, 0.0]))
    masked = engine._subsample(outs, exp)
    two = engine.run_compiled(xd[:2], yd[:2], xte, yte, cfg, steps=STEPS,
                              eval_every=EVERY, **CPU)
    assert masked.accs == two.accs
    assert masked.losses == two.losses


@pytest.mark.parametrize("name", ["a_dsgd_dense", "a_dsgd_blocked"])
def test_interrupted_and_resumed_run_is_bitwise(data, tmp_path, name):
    full = _run(data, name)
    kw = dict(checkpoint_dir=str(tmp_path), checkpoint_every=2)
    assert _run(data, name, stop_after_step=3, **kw) is None
    _, step = load_checkpoint(str(tmp_path / "engine_ckpt.npz"), "cpu")
    assert step == 4
    resumed = _run(data, name, resume=True, **kw)
    assert resumed.accs == full.accs
    assert resumed.losses == full.losses
    assert resumed.metrics == full.metrics
    for k in full.params:
        assert torch.equal(resumed.params[k], full.params[k])


@pytest.mark.parametrize("name", ["a_dsgd_dense", "a_dsgd_blocked"])
def test_jax_checkpoint_resumes_in_the_port(data, jax_runs, tmp_path, name):
    """The JAX engine stops at step 3; the port finishes the run from its
    file, within 1e-5 of JAX's uninterrupted losses."""
    kw = dict(checkpoint_dir=str(tmp_path), checkpoint_every=3)
    assert jeng.run_compiled(*data, JaxOTAConfig(**CONFIGS[name]),
                             steps=STEPS, lr=1e-3, eval_every=EVERY,
                             stop_after_step=3, **kw) is None
    got = _run(data, name, resume=True, **kw)
    want = jax_runs[name]
    np.testing.assert_allclose(got.all_losses, want.all_losses, rtol=0,
                               atol=1e-5)
    assert got.accs == want.accs


def test_checkpoint_round_trips_with_the_reference(tmp_path):
    """bfloat16 bit views, empty containers, tuples and the step, written
    by one package and read by the other."""
    import jax.numpy as jnp
    from repro.train import checkpoint as jck
    from repro_torch.train.checkpoint import save_checkpoint
    bf = np.random.default_rng(0).standard_normal(5).astype(np.float32)
    tree = ({"w": torch.from_numpy(bf).to(torch.bfloat16),
             "n": torch.tensor(3, dtype=torch.int32)}, {}, (),
            torch.from_numpy(bf))
    save_checkpoint(str(tmp_path / "t.npz"), tree, step=7)
    jt, jstep = jck.load_checkpoint(str(tmp_path / "t.npz"))
    assert jstep == 7 and jt[1] == {} and jt[2] == ()
    assert jt[0]["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(jt[0]["w"], np.float32),
                                  tree[0]["w"].float().numpy())
    jck.save_checkpoint(str(tmp_path / "j.npz"), jt, step=9)
    back, step = load_checkpoint(str(tmp_path / "j.npz"), "cpu")
    assert step == 9 and back[1] == {} and back[2] == ()
    assert torch.equal(back[0]["w"], tree[0]["w"])
    assert torch.equal(back[0]["n"], tree[0]["n"])
    assert torch.equal(back[3], tree[3])


def _npz_layout(path):
    with np.load(path) as f:
        return {k: (f[k].dtype.str, f[k].shape) for k in f.files}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_checkpoint_layout_matches_reference(data, tmp_path, name):
    """Same keys, dtypes and shapes as the JAX engine's file for the same
    carry, and each file loads with the other package's loader."""
    from repro.train.checkpoint import load_checkpoint as jax_load
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jeng.run_compiled(*data, JaxOTAConfig(**CONFIGS[name]), steps=STEPS,
                      eval_every=EVERY, checkpoint_dir=str(jdir),
                      checkpoint_every=2, stop_after_step=2)
    _run(data, name, checkpoint_dir=str(tdir), checkpoint_every=2,
         stop_after_step=2)
    jpath, tpath = jdir / "engine_ckpt.npz", tdir / "engine_ckpt.npz"
    assert _npz_layout(tpath) == _npz_layout(jpath)
    jtree, jstep = jax_load(str(tpath))
    ttree, tstep = load_checkpoint(str(jpath), "cpu")
    assert jstep == tstep == 2
    leaves = jax.tree.leaves(jtree)
    assert len(leaves) == len(jax.tree.leaves(
        jax.tree.map(np.asarray, ttree, is_leaf=torch.is_tensor)))


def test_run_compiled_defaults_to_the_card(data):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.run_compiled(*data, OTAConfig(**CONFIGS["ideal"]), steps=1)


@pytest.mark.parametrize("what", ["guard", "local", "overrides", "mac"])
def test_unported_parts_raise(data, what):
    """Every part the reference's engine has now runs here: the guard, the
    local-compute axis, its knobs as overrides and the ``mac`` hook; an
    override the engine does not know still raises.  (The name dates from
    when these parts raised.)"""
    cfg = OTAConfig(**CONFIGS["ideal"])
    if what == "guard":
        # the guardrails are ported (tests/test_torch_robust_engine.py):
        # a guarded run adds the guard's columns
        run = engine.run_compiled(*data, cfg, steps=1, guard=GuardConfig(),
                                  **CPU)
        assert run.metrics[0]["guard_skipped"] == 0.0
    elif what == "local":
        # the local-compute axis is ported (tests/test_torch_local*.py)
        run = engine.run_compiled(*data, dataclasses.replace(
            cfg, local="fedavg"), steps=1, **CPU)
        assert np.isfinite(run.all_losses).all()
    else:
        exp = engine.Experiment(cfg=cfg, steps=1)
        ce = engine.CompiledExperiment(*data, exp, device="cpu")
        keys = engine.round_keys(1, 0, "cpu")
        if what == "overrides":
            # the local-compute knobs land on the run's LocalWork; an
            # unknown name raises
            out = ce.run({"local_epochs": torch.ones(())}, keys)
            assert torch.isfinite(out["loss"]).all()
            with pytest.raises(AttributeError, match="no_such_knob"):
                ce.run({"no_such_knob": torch.ones(())}, keys)
        else:
            # the mac hook (the population engine's edge sites) replaces
            # the flat MAC sum of an analog scheme
            sch = get_scheme(OTAConfig(**CONFIGS["a_dsgd_dense"]), ce.d, M,
                             device="cpu")
            seen = []

            def mac(frames, mac_key, sigma2):
                seen.append(frames.shape)
                return frames.sum(dim=-2)
            engine.round_masked(sch, torch.zeros(M, ce.d),
                                torch.zeros(M, ce.d), 0, keys[0],
                                torch.ones(M), ce.ctx, mac=mac)
            assert seen == [(M, sch.channel_dim())]