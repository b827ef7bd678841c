"""The local-compute axis through the port's runs, repro_torch against repro:
run_compiled and run_federated with FedAvg-E, FedProx and FedDyn, FedDyn's
duals in the carry and their resume, the legacy ``local_steps`` device,
and the local grid of run_sweep.

Data as tests/test_local.py: M = 4 devices of B = 64 samples, dim 48
(d = 490), 6 rounds, evaluated every 2.  Against the JAX engine,
accuracies are equal and losses within 1e-5, the port's bar for runs; the
port's own runs (looped and compiled, a resume, a grid point) are bitwise.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import OTAConfig as JaxOTAConfig
from repro.experiments import engine as jeng
from repro.experiments import run_sweep as jax_run_sweep
from repro.train import paper_repro as jpr
from repro_torch.configs.base import OTAConfig
from repro_torch.data import federated_split, make_classification
from repro_torch.experiments import engine, run_sweep
from repro_torch.train import paper_repro as tpr
from repro_torch.train.checkpoint import load_checkpoint

STEPS, EVERY, M, B = 6, 2, 4, 64
CPU = dict(device="cpu")
BASE = dict(s_frac=0.5, k_frac=0.25, p_avg=500.0, total_steps=STEPS,
            projection="dense", amp_iters=6, mean_removal_steps=2)
#: the algorithms of the acceptance matrix (sgd at E = 2 leaves the
#: one-gradient path)
LOCALS = {"sgd": dict(local="sgd", local_epochs=2),
          "fedavg": dict(local="fedavg", local_epochs=3),
          "fedprox": dict(local="fedprox", local_epochs=3, prox_mu=0.3),
          "feddyn": dict(local="feddyn", local_epochs=3, dyn_alpha=0.2)}


@pytest.fixture(scope="module")
def data():
    (xtr, ytr), (xte, yte) = make_classification(
        n_train=800, n_test=300, dim=48, noise=2.0, seed=3)
    xd, yd = federated_split(xtr, ytr, m=M, b=B, iid=True, seed=0)
    return xd, yd, xte, yte


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(scheme, local, **extra):
    return {**BASE, "scheme": scheme, **LOCALS[local], **extra}


def _port(data, kw, **run_kw):
    return engine.run_compiled(*data, OTAConfig(**kw), steps=STEPS, lr=1e-3,
                               eval_every=EVERY, **CPU, **run_kw)


def _jax(data, kw, **run_kw):
    return jeng.run_compiled(*data, JaxOTAConfig(**kw), steps=STEPS, lr=1e-3,
                             eval_every=EVERY, **run_kw)


def _bitwise(a, b):
    assert a.accs == b.accs and a.losses == b.losses
    assert a.metrics == b.metrics
    np.testing.assert_array_equal(a.all_losses.view(np.int32),
                                  b.all_losses.view(np.int32))
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k


@pytest.mark.parametrize("scheme", ["a_dsgd", "d_dsgd"])
@pytest.mark.parametrize("local", list(LOCALS))
def test_run_compiled_matches_jax_engine(data, scheme, local):
    got, want = _port(data, _kw(scheme, local)), _jax(data, _kw(scheme,
                                                                local))
    np.testing.assert_allclose(got.all_losses, want.all_losses, rtol=0,
                               atol=1e-5)
    assert got.all_accs.tolist() == want.all_accs.tolist()
    for mg, mw in zip(got.metrics, want.metrics):
        assert set(mg) == set(mw)


@pytest.mark.parametrize("scheme", ["a_dsgd", "d_dsgd"])
@pytest.mark.parametrize("local", ["fedprox", "feddyn"])
def test_run_federated_equals_run_compiled(data, scheme, local):
    kw = _kw(scheme, local)
    loop = tpr.run_federated(*data, OTAConfig(**kw), steps=STEPS, lr=1e-3,
                             eval_every=EVERY, **CPU)
    comp = _port(data, kw)
    assert loop.accs == comp.accs and loop.losses == comp.losses
    assert loop.metrics == comp.metrics
    for k in comp.params:
        assert torch.equal(loop.params[k], comp.params[k])


def test_first_round_ghat_matches_reference(data):
    """One FedDyn round through run_compiled: the transmitted estimate
    moves Adam's first step, and the weights after it stay within A-DSGD's
    bar of the reference's."""
    kw = _kw("a_dsgd", "feddyn")
    exp = engine.Experiment(cfg=OTAConfig(**kw), steps=1)
    ce = engine.CompiledExperiment(*data, exp, **CPU)
    carry, _ = ce.run_segment({}, engine.round_keys(1, 0, "cpu"), None,
                              ce.carry0(), 0)
    jexp = jeng.Experiment(cfg=JaxOTAConfig(**kw), steps=1)
    jce = jeng.CompiledExperiment(*data, jexp)
    jcarry, _ = jax.jit(lambda c, k: jce.run_segment({}, k, None, c, 0))(
        jce._carry0(), jeng.round_keys(1))
    for k in ("w", "b"):
        np.testing.assert_allclose(carry[0][k].numpy(),
                                   np.asarray(jcarry[0][k]), rtol=1e-4,
                                   atol=1e-5)
    # the duals ride the carry after the momenta, as in the reference
    assert carry[4].shape == (M, ce.d) and torch.any(carry[4] != 0)
    np.testing.assert_allclose(carry[4].numpy(), np.asarray(jcarry[4]),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(carry[2].numpy(), np.asarray(jcarry[2]),
                               rtol=1e-4, atol=1e-6)


def test_legacy_local_steps_run_matches_jax_engine(data):
    kw = {**BASE, "scheme": "a_dsgd"}
    got = _port(data, kw, local_steps=3, local_lr=0.2)
    want = _jax(data, kw, local_steps=3, local_lr=0.2)
    np.testing.assert_allclose(got.all_losses, want.all_losses, rtol=0,
                               atol=1e-5)
    assert got.all_accs.tolist() == want.all_accs.tolist()
    loop = tpr.run_federated(*data, OTAConfig(**kw), steps=STEPS, lr=1e-3,
                             eval_every=EVERY, local_steps=3, local_lr=0.2,
                             **CPU)
    assert loop.accs == got.accs and loop.losses == got.losses


def test_legacy_local_steps_conflicts_with_local_axis(data):
    kw = _kw("a_dsgd", "fedavg")
    with pytest.raises(ValueError, match="local_steps"):
        _port(data, kw, local_steps=3)
    with pytest.raises(ValueError, match="local_steps"):
        tpr.run_federated(*data, OTAConfig(**kw), steps=STEPS,
                          local_steps=3, **CPU)
    # the reference raises alike
    with pytest.raises(ValueError, match="local_steps"):
        jpr.run_federated(*data, JaxOTAConfig(**kw), steps=STEPS,
                          local_steps=3)


def test_identity_pin_is_the_plain_run(data):
    """local=sgd, E=1 set explicitly is the default run, bitwise."""
    kw = {**BASE, "scheme": "a_dsgd"}
    _bitwise(_port(data, kw), _port(data, dict(kw, local="sgd",
                                               local_epochs=1)))


def test_feddyn_resume_is_bitwise(data, tmp_path):
    kw = _kw("a_dsgd", "feddyn")
    full = _port(data, kw)
    ck = dict(checkpoint_dir=str(tmp_path), checkpoint_every=2)
    assert _port(data, kw, stop_after_step=2, **ck) is None
    saved, step = load_checkpoint(str(tmp_path / "engine_ckpt.npz"), "cpu")
    assert step == 2 and saved["carry"][4].shape == (M, 490)
    _bitwise(_port(data, kw, resume=True, **ck), full)


def test_jax_feddyn_checkpoint_resumes_in_the_port(data, tmp_path):
    """The JAX engine stops at round 3; the port loads its carry (the duals
    included) bitwise and finishes within the bar of JAX's uninterrupted
    run."""
    kw = _kw("a_dsgd", "feddyn")
    ck = dict(checkpoint_dir=str(tmp_path), checkpoint_every=3)
    assert _jax(data, kw, stop_after_step=3, **ck) is None
    saved = np.load(str(tmp_path / "engine_ckpt.npz"))
    exp = engine.Experiment(cfg=OTAConfig(**kw), steps=STEPS)
    ce = engine.CompiledExperiment(*data, exp, **CPU)
    loaded, t0 = load_checkpoint(str(tmp_path / "engine_ckpt.npz"), "cpu")
    carry = engine._restore_carry(ce.carry0(), loaded["carry"])
    assert t0 == 3
    np.testing.assert_array_equal(carry[4].numpy(),
                                  saved["state/carry/#4"])
    got = _port(data, kw, resume=True, **ck)
    want = _jax(data, kw)
    np.testing.assert_allclose(got.all_losses, want.all_losses, rtol=0,
                               atol=1e-5)
    assert got.accs == want.accs


@pytest.mark.parametrize("fault", [dict(fault_rate=0.5, fault_kind="stale"),
                                   dict(byzantine_frac=0.25)])
def test_feddyn_first_round_duals_ignore_faults(data, fault):
    """Faults act after local compute: round 1's duals are the clean
    run's, bitwise."""
    kw = _kw("a_dsgd", "feddyn")
    duals = []
    for extra in ({}, dict(robust=True, **fault)):
        exp = engine.Experiment(cfg=OTAConfig(**kw, **extra), steps=1)
        ce = engine.CompiledExperiment(*data, exp, **CPU)
        carry, _ = ce.run_segment({}, engine.round_keys(1, 0, "cpu"), None,
                                  ce.carry0(), 0)
        duals.append(carry[4])
    assert torch.equal(duals[0], duals[1])


def test_local_grid_equals_its_points_and_the_reference(data):
    """A (local_epochs, prox_mu) grid: every record is its own run_compiled
    bitwise (the port divides delta_out in both), the E = 1 point included,
    and the reference's grid within the bar."""
    xd, yd, xte, yte = data
    base = {**BASE, "scheme": "a_dsgd", "local": "fedprox"}
    axes = {"local_epochs": [1, 3], "prox_mu": [0.0, 0.4]}
    res = run_sweep((xd, yd), (xte, yte), OTAConfig(**base), axes,
                    steps=STEPS, eval_every=EVERY, **CPU)
    ref = jax_run_sweep((xd, yd), (xte, yte), JaxOTAConfig(**base), axes,
                        steps=STEPS, eval_every=EVERY)
    assert len(res.records) == 4
    for rec in res.records:
        own = _port(data, dict(base, local_epochs=int(rec["local_epochs"]),
                               prox_mu=rec["prox_mu"]))
        assert rec["accs"] == own.accs and rec["losses"] == own.losses
        want = ref.record(local_epochs=rec["local_epochs"],
                          prox_mu=rec["prox_mu"])
        assert rec["accs"] == want["accs"]
        np.testing.assert_allclose(rec["losses"], want["losses"], rtol=0,
                                   atol=1e-5)


def test_grid_inputs_leave_the_runner_as_it_was(data):
    """Building a local_epochs grid's inputs does not change the caller's
    runner: its epoch bound is the caller's to set, and run_sweep sets it
    on its own runners only."""
    from repro_torch.experiments import sweep
    exp = engine.Experiment(cfg=OTAConfig(**_kw("a_dsgd", "fedavg",
                                                local_epochs=1)), steps=2)
    ce = engine.CompiledExperiment(*data, exp, **CPU)
    ov, _, _ = sweep.grid_inputs(ce, [{"local_epochs": 1},
                                      {"local_epochs": 3}], 2)
    assert ce.localwork.max_epochs == 1
    assert ov["local_epochs"].tolist() == [1.0, 3.0]


def test_static_local_axis_groups_by_algorithm(data):
    xd, yd, xte, yte = data
    base = OTAConfig(**BASE, scheme="d_dsgd")
    res = run_sweep((xd, yd), (xte, yte), base,
                    {"local": ["fedavg", "feddyn"], "local_epochs": [2],
                     "dyn_alpha": [0.0, 0.2]}, steps=STEPS,
                    eval_every=EVERY, **CPU)
    assert len(res.records) == 4
    for rec in res.records:
        own = _port(data, dict(BASE, scheme="d_dsgd", local=rec["local"],
                               local_epochs=2, dyn_alpha=rec["dyn_alpha"]))
        assert rec["accs"] == own.accs and rec["losses"] == own.losses
    # fedavg ignores dyn_alpha: its two points are one run
    fa = [r for r in res.records if r["local"] == "fedavg"]
    assert fa[0]["losses"] == fa[1]["losses"]


def test_masked_grid_keeps_padded_duals(data):
    """An m_active grid with FedDyn: a padded device's dual never moves,
    and each point equals its own masked run."""
    xd, yd, xte, yte = data
    kw = _kw("a_dsgd", "feddyn")
    exp = engine.Experiment(cfg=OTAConfig(**kw), steps=2)
    ce = engine.CompiledExperiment(*data, exp, **CPU)
    masks = torch.tensor([[1.0, 1.0, 0.0, 0.0], [1.0, 1.0, 1.0, 1.0]])
    keys = torch.stack([engine.round_keys(2, 0, "cpu")] * 2)
    carry = ce.carry0_grid(2)
    for t in range(2):
        carry, _ = ce._round(ce.scheme, ce.localwork, carry, t, keys[:, t],
                             masks)
    assert torch.all(carry[4][0, 2:] == 0) and torch.any(carry[4][0, :2] != 0)
    for g in range(2):
        own = ce.run_masked({}, keys[g], masks[g])
        for k in own["params"]:
            assert torch.equal(carry[0][k][g], own["params"][k])


def test_local_knobs_as_overrides(data):
    """The three knobs ride ``run``'s overrides as 0-dim values; a knob
    the run does not know raises."""
    kw = _kw("a_dsgd", "feddyn")
    exp = engine.Experiment(cfg=OTAConfig(**kw), steps=2)
    ce = engine.CompiledExperiment(*data, exp, **CPU)
    keys = engine.round_keys(2, 0, "cpu")
    got = ce.run({"dyn_alpha": 0.0}, keys)
    plain = engine.CompiledExperiment(*data, dataclasses.replace(
        exp, cfg=OTAConfig(**dict(kw, dyn_alpha=0.0))), **CPU).run({}, keys)
    assert torch.equal(got["loss"], plain["loss"])
    with pytest.raises(AttributeError):
        ce.run({"not_a_knob": 1.0}, keys)
