"""The slice end to end: optimizer, run_federated and state conversion,
repro_torch against repro on the blocked use_kernel=True path."""
import dataclasses

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import OTAConfig as JaxOTAConfig
from repro.core.schemes import get_scheme as jax_get_scheme
from repro.core.schemes import round_simulated as jax_round
from repro.data.synthetic import federated_split as jax_split
from repro.data.synthetic import make_classification as jax_data
from repro.optim.optim import Optimizer as JaxOptimizer
from repro.train import paper_repro as jpr
from repro_torch import convert, rng
from repro_torch.configs.base import OTAConfig as TorchOTAConfig
from repro_torch.core.schemes import get_scheme as torch_get_scheme
from repro_torch.data import federated_split, make_classification
from repro_torch.optim.optim import Optimizer as TorchOptimizer
from repro_torch.train import paper_repro as tpr

TOL = dict(rtol=1e-4, atol=1e-5)
STEPS, N_TEST = 5, 300
SLICE_KW = dict(projection="blocked", block_size=128, s_frac=0.5,
                k_frac=0.25, rademacher=True, use_kernel=True, p_avg=500.0,
                total_steps=STEPS, amp_iters=10, mean_removal_steps=2)


@pytest.fixture(scope="module")
def data():
    (xtr, ytr), (xte, yte) = make_classification(n_train=400, n_test=N_TEST,
                                                 dim=64, seed=1)
    xd, yd = federated_split(xtr, ytr, m=4, b=32, seed=0)
    return xd, yd, xte, yte


def test_data_matches_reference():
    (a, b), (c, d) = make_classification(n_train=300, n_test=50, dim=32,
                                         seed=4)
    (ja, jb), (jc, jd) = jax_data(n_train=300, n_test=50, dim=32, seed=4)
    for x, y in ((a, ja), (b, jb), (c, jc), (d, jd)):
        np.testing.assert_array_equal(x, y)
    for iid in (True, False):
        for x, y in zip(federated_split(a, b, m=5, b=20, iid=iid, seed=2),
                        jax_split(ja, jb, m=5, b=20, iid=iid, seed=2)):
            np.testing.assert_array_equal(x, y)


def test_adam_apply():
    rs = np.random.default_rng(0)
    p = {"w": rs.standard_normal((6, 3)).astype(np.float32),
         "b": rs.standard_normal(3).astype(np.float32)}
    oj, ot = JaxOptimizer(lr=3e-3), TorchOptimizer(lr=3e-3)
    pj, sj = jax.tree.map(jnp.asarray, p), oj.init(p)
    pt = convert.to_torch(p, "cpu")
    st = ot.init(pt)
    for _ in range(3):
        g = {k: rs.standard_normal(v.shape).astype(np.float32)
             for k, v in p.items()}
        pj, sj = oj.apply(pj, jax.tree.map(jnp.asarray, g), sj)
        pt, st = ot.apply(pt, convert.to_torch(g, "cpu"), st)
    for k in p:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                   rtol=1e-6)
        np.testing.assert_allclose(st["m"][k].numpy(),
                                   np.asarray(sj["m"][k]), rtol=1e-6)
        np.testing.assert_allclose(st["v"][k].numpy(),
                                   np.asarray(sj["v"][k]), rtol=1e-6)
    assert int(st["count"]) == int(sj["count"]) == 3


def test_ravel_follows_ravel_pytree():
    rs = np.random.default_rng(1)
    p = {"w": rs.standard_normal((5, 3)).astype(np.float32),
         "b": rs.standard_normal(3).astype(np.float32)}
    flat_j, _ = jax.flatten_util.ravel_pytree(p)
    flat_t = convert.ravel(convert.to_torch(p, "cpu"))
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))
    np.testing.assert_array_equal(flat_t[:3].numpy(), p["b"])
    back = convert.unravel(flat_t, convert.to_torch(p, "cpu"))
    for k in p:
        np.testing.assert_array_equal(back[k].numpy(), p[k])


def _jax_loop(xd, yd, cfg, steps):
    """The reference's ``step_fn`` loop, keeping the state it returns."""
    m, _, dim = xd.shape
    params = jpr.init_linear(dim, 10, None)
    flat0, unravel = jax.flatten_util.ravel_pytree(params)
    scheme = jax_get_scheme(cfg, flat0.shape[0], m)
    opt = JaxOptimizer(lr=1e-3)
    opt_state = opt.init(params)
    deltas = jnp.zeros((m, flat0.shape[0]))
    momenta = jnp.zeros_like(deltas)
    states = []

    @jax.jit
    def step(params, opt_state, deltas, t, key):
        grads, _ = jpr.device_grads(params, unravel, xd, yd, momenta)
        ghat, deltas, _ = jax_round(scheme, grads, deltas, t, key)
        params, opt_state = opt.apply(params, unravel(ghat), opt_state)
        return params, opt_state, deltas

    for t in range(steps):
        params, opt_state, deltas = step(params, opt_state, deltas, t,
                                         jax.random.PRNGKey(1000 + t))
        states.append(jax.device_get((params, opt_state, deltas)))
    return states


@pytest.fixture(scope="module")
def jax_states(data):
    xd, yd, _, _ = data
    return _jax_loop(jnp.asarray(xd), jnp.asarray(yd),
                     JaxOTAConfig(**SLICE_KW), STEPS)


def test_run_federated_matches_reference(data, jax_states):
    xd, yd, xte, yte = data
    rj = jpr.run_federated(xd, yd, xte, yte, JaxOTAConfig(**SLICE_KW),
                           steps=STEPS, eval_every=1)
    rt = tpr.run_federated(xd, yd, xte, yte, TorchOTAConfig(**SLICE_KW),
                           steps=STEPS, eval_every=1, device="cpu")
    # accuracy divides as jnp.mean does, so the floats are equal
    assert rt.accs == rj.accs
    np.testing.assert_allclose(rt.losses, rj.losses, rtol=1e-5, atol=1e-5)
    assert rt.losses[-1] < rt.losses[0]
    for mj, mt in zip(rj.metrics, rt.metrics):
        for k in mj:
            np.testing.assert_allclose(mt[k], mj[k], rtol=1e-5)
    params_j, _, deltas_j = jax_states[-1]
    params_t = convert.to_numpy(rt.params)
    for k in params_j:
        np.testing.assert_allclose(params_t[k], params_j[k], **TOL)
    np.testing.assert_allclose(convert.to_numpy(rt.deltas), deltas_j, **TOL)


def test_step_from_converted_state(data, jax_states):
    """Two reference steps, then one port step from the converted state,
    against the reference's third step."""
    xd, yd, _, _ = data
    params2, opt2, deltas2 = jax_states[1]
    params3, opt3, deltas3 = jax_states[2]
    cfg = TorchOTAConfig(**SLICE_KW)
    params = convert.to_torch(params2, "cpu")
    scheme = torch_get_scheme(cfg, convert.ravel(params).shape[0], 4,
                              device="cpu")
    out = tpr.train_step(
        scheme, TorchOptimizer(lr=1e-3), params, convert.to_torch(opt2, "cpu"),
        convert.to_torch(deltas2, "cpu"), torch.zeros(4, 650), torch.from_numpy(xd),
        torch.from_numpy(yd).long(), 2, rng.PRNGKey(1002))
    p_t, o_t, d_t = (convert.to_numpy(v) for v in out[:3])
    for k in params3:
        np.testing.assert_allclose(p_t[k], params3[k], **TOL)
        np.testing.assert_allclose(o_t["m"][k], opt3["m"][k], **TOL)
        np.testing.assert_allclose(o_t["v"][k], opt3["v"][k], **TOL)
    assert int(o_t["count"]) == int(opt3["count"]) == 3
    np.testing.assert_allclose(d_t, deltas3, **TOL)


def test_device_grads_match_reference(data):
    xd, yd, _, _ = data
    rs = np.random.default_rng(5)
    p = {"w": 0.1 * rs.standard_normal((64, 10)).astype(np.float32),
         "b": 0.1 * rs.standard_normal(10).astype(np.float32)}
    pj = jax.tree.map(jnp.asarray, p)
    _, unravel = jax.flatten_util.ravel_pytree(pj)
    gj, _ = jpr.device_grads(pj, unravel, jnp.asarray(xd), jnp.asarray(yd),
                             jnp.zeros((4, 650)))
    gt, _ = tpr.device_grads(convert.to_torch(p, "cpu"), torch.from_numpy(xd),
                             torch.from_numpy(yd).long(), torch.zeros(4, 650))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-7)


def test_ideal_and_dense_runs_match_reference(data):
    xd, yd, xte, yte = data
    for kw in (dict(scheme="ideal", total_steps=3),
               dict(projection="dense", s_frac=0.5, k_frac=0.25,
                    total_steps=3, amp_iters=10, mean_removal_steps=1)):
        rj = jpr.run_federated(xd, yd, xte, yte, JaxOTAConfig(**kw), steps=3,
                               eval_every=1)
        rt = tpr.run_federated(xd, yd, xte, yte, TorchOTAConfig(**kw),
                               steps=3, eval_every=1, device="cpu")
        np.testing.assert_allclose(rt.losses, rj.losses, rtol=1e-5,
                                   atol=1e-5)
        assert rt.accs == rj.accs


@pytest.mark.parametrize("n", [1, 7, 300, 1000, 10000])
def test_accuracy_and_loss_divide_as_jnp_mean(n):
    """accuracy is bitwise jnp.mean of the hits (count * f32(1/n)); the
    loss's sum runs in another order, so it is held to 1e-6."""
    rs = np.random.default_rng(n)
    p = {"w": rs.standard_normal((16, 10)).astype(np.float32),
         "b": rs.standard_normal(10).astype(np.float32)}
    x = rs.standard_normal((n, 16)).astype(np.float32)
    y = rs.integers(0, 10, n).astype(np.int32)
    pj, pt = jax.tree.map(jnp.asarray, p), convert.to_torch(p, "cpu")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    acc_j = np.asarray(jax.jit(jpr.accuracy)(pj, x, y))
    assert tpr.accuracy(pt, xt, yt).numpy().tobytes() == acc_j.tobytes()
    np.testing.assert_allclose(float(tpr.ce_loss(pt, xt, yt)),
                               float(jax.jit(jpr.ce_loss)(pj, x, y)),
                               rtol=1e-6)


def test_config_is_a_field_copy():
    assert ([f.name for f in dataclasses.fields(TorchOTAConfig)]
            == [f.name for f in dataclasses.fields(JaxOTAConfig)])
    assert (dataclasses.asdict(TorchOTAConfig())
            == dataclasses.asdict(JaxOTAConfig()))
