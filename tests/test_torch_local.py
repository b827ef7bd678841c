"""The local-compute axis, repro_torch against repro, function by function:
the registry, the hooks, ``local_device_grads`` and the legacy
``local_steps`` device.

The hooks (``inner_grad``, the epoch step, ``delta_out``, ``dual_out``)
are held bitwise against ``jax.jit`` of the reference's with the knobs
traced, given the same inputs: the grid's program, and the port's in both
callers.  The reference's ``run_compiled`` divides ``delta_out`` by a
constant, which XLA compiles as the product with its reciprocal; that gap
is measured here (ROADMAP queue 3).  Whole deltas after E >= 2 epochs
cannot be bitwise: the gradient at a moved iterate is the port's closed
form in torch's order, not ``jax.grad`` in XLA's; they are held to 1e-7
absolute (gradients of magnitude 0.1-0.3).  The E = 1 pin is bitwise.
"""
import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import OTAConfig as JaxOTAConfig
from repro.local import work as jwork
from repro.train import paper_repro as jpr
from repro_torch import local as tlocal
from repro_torch.configs.base import OTAConfig
from repro_torch.data import federated_split, make_classification
from repro_torch.local import work as twork
from repro_torch.rng import fma_f32
from repro_torch.train import paper_repro as tpr

M, B, DIM, C = 4, 32, 12, 4
LR = 0.6
ALGOS = {"sgd": {}, "fedavg": {}, "fedprox": {"prox_mu": 0.37},
         "feddyn": {"dyn_alpha": 0.23}}


@pytest.fixture(scope="module")
def data():
    (xtr, ytr), _ = make_classification(n_train=400, n_test=50, dim=DIM,
                                        n_classes=C, noise=2.0, seed=3)
    xd, yd = federated_split(xtr, ytr, m=M, b=B, iid=True, seed=0)
    return xd, yd


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one intra-op thread (thousands of small ops, which a
    parallel run's busy cores slow with a pool of threads to wake)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    rs = np.random.RandomState(1)
    return {"w": (0.1 * rs.randn(DIM, C)).astype(np.float32),
            "b": (0.1 * rs.randn(C)).astype(np.float32)}


def _bits(x):
    x = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return x.view(np.int32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _lw(algo, epochs=3, **kw):
    over = {**ALGOS[algo], **kw}
    return (jwork.get_local(JaxOTAConfig(local=algo, local_epochs=epochs,
                                         **over), LR),
            twork.get_local(OTAConfig(local=algo, local_epochs=epochs,
                                      **over), LR, device="cpu"))


def test_registry_and_exports_match_reference():
    assert set(twork.LOCAL_REGISTRY) == set(jwork.LOCAL_REGISTRY)
    assert twork.LOCAL_OVERRIDE_ATTRS == jwork.LOCAL_OVERRIDE_ATTRS
    for name in ("LOCAL_OVERRIDE_ATTRS", "LOCAL_REGISTRY", "LocalWork",
                 "get_local", "local_device_grads", "register_local"):
        assert hasattr(tlocal, name)
    for name in twork.LOCAL_REGISTRY:
        lw = twork.get_local(OTAConfig(local=name), device="cpu")
        assert lw.name == name and isinstance(lw, twork.LocalWork)
        assert lw.has_dual == (name == "feddyn")
    with pytest.raises(KeyError, match="unknown local algorithm"):
        twork.get_local(OTAConfig(local="gossip"), device="cpu")


def test_identity_gate_and_overrides():
    assert twork.get_local(OTAConfig(), device="cpu").identity
    assert not twork.get_local(OTAConfig(local_epochs=2),
                               device="cpu").identity
    for name in ("fedavg", "fedprox", "feddyn"):
        assert not twork.get_local(OTAConfig(local=name),
                                   device="cpu").identity
    lw = twork.get_local(OTAConfig(local="feddyn", dyn_alpha=0.1),
                         device="cpu")
    assert lw.dyn_alpha.dtype == torch.float32 and lw.dyn_alpha.dim() == 0
    with pytest.raises(AttributeError, match="unknown local override"):
        lw.with_overrides(byz_scale=1.0)
    g = lw.with_overrides(dyn_alpha=[0.1, 0.2])
    assert g.dyn_alpha.shape == (2,) and float(lw.dyn_alpha) == \
        np.float32(0.1)
    assert lw.init_dual(3, 5).shape == (3, 5)
    assert lw.init_dual(3, 5, points=2).shape == (2, 3, 5)
    assert twork.get_local(OTAConfig(local="fedavg"),
                           device="cpu").init_dual(3, 5) is None


@pytest.mark.parametrize("algo", list(ALGOS))
@pytest.mark.parametrize("epochs", [1, 2, 4])
def test_hooks_bitwise_with_jitted_reference(algo, epochs):
    """inner_grad, the step ``w - lr * dvec``, g_sum, delta_out and
    dual_out of one epoch, given the same g, w, w0 and dual: bitwise
    ``jax.jit`` of the reference's hooks with the knobs traced."""
    jl, tl = _lw(algo, epochs)
    rs = np.random.RandomState(epochs)
    g, w, w0, dual, gs = (rs.randn(M, 300).astype(np.float32)
                          for _ in range(5))

    def ref(g, w, w0, dual, gs, e, mu, al):
        lw = jl.with_overrides(local_epochs=e, prox_mu=mu, dyn_alpha=al)
        dvec = lw.inner_grad(g, w, w0, dual)
        n_eff = jnp.maximum(lw.local_epochs, 1.0)
        return (dvec, w - lw.lr * dvec, gs + dvec,
                lw.delta_out(w0, w, gs, n_eff), lw.dual_out(dual, w0, w))

    want = jax.jit(jax.vmap(ref, in_axes=(0,) * 5 + (None,) * 3))(
        g, w, w0, dual, gs, jnp.float32(epochs), jl.prox_mu, jl.dyn_alpha)
    tg, tw, tw0, td, tgs = map(_t, (g, w, w0, dual, gs))
    dvec = tl.inner_grad(tg, tw, tw0, td)
    n_eff = torch.clamp(tl.local_epochs, min=1.0)
    got = (dvec, fma_f32(dvec, -float(np.float32(LR)), tw), tgs + dvec,
           tl.delta_out(tw0, tw, tgs, n_eff), tl.dual_out(td, tw0, tw))
    for name, a, b in zip(("inner_grad", "step", "g_sum", "delta_out",
                           "dual_out"), got, want):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)


@pytest.mark.parametrize("epochs", [2, 3, 4])
def test_delta_out_against_the_constant_divisor(epochs):
    """The reference's run_compiled divides ``delta_out`` by the constant
    ``lr * E``, which XLA compiles as the product with its float32
    reciprocal; its sweeps divide.  The port divides in both callers: one
    ulp from the constant form on a share of entries, never more."""
    jl, tl = _lw("fedavg", epochs)
    rs = np.random.RandomState(0)
    w0, w = (rs.randn(M, 5000).astype(np.float32) for _ in range(2))
    const = jax.jit(lambda a, b: jl.delta_out(
        a, b, None, jnp.maximum(jl.local_epochs, 1.0)))(w0, w)
    got = tl.delta_out(_t(w0), _t(w), None,
                       torch.clamp(tl.local_epochs, min=1.0)).numpy()
    ulps = np.abs(_bits(got).astype(np.int64) - _bits(const))
    assert ulps.max() <= 1
    assert 0.05 < (ulps > 0).mean() < 0.35
    recip = np.float32(1.0) / (np.float32(LR) * np.float32(epochs))
    np.testing.assert_array_equal(_bits(const), _bits((w0 - w) * recip))


def _jax_local(jl, data, params, duals=None):
    xd, yd = data
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    _, unravel = jax.flatten_util.ravel_pytree(pj)
    d = sum(v.size for v in params.values())
    out = jax.jit(lambda p, du: jwork.local_device_grads(
        jl, jpr.flat_grad_fn(unravel), p, jnp.asarray(xd), jnp.asarray(yd),
        jnp.zeros((M, d), jnp.float32), du))(pj, duals)
    return np.asarray(out[0]), (None if out[2] is None
                                else np.asarray(out[2]))


def _port_local(tl, data, params, duals=None):
    xd, yd = data
    pt = {k: _t(v) for k, v in params.items()}
    deltas, _, new_duals = twork.local_device_grads(
        tl, tpr.flat_grad_fn(pt), pt, _t(xd), _t(yd).long(), None,
        None if duals is None else _t(duals))
    return deltas.numpy(), (None if new_duals is None
                            else new_duals.numpy())


@pytest.mark.parametrize("algo", list(ALGOS))
@pytest.mark.parametrize("epochs", [1, 2, 4])
def test_local_device_grads_match_reference(data, params, algo, epochs):
    """Per-device deltas (and FedDyn's duals) against the reference's
    scan, within 1e-7 absolute: from epoch 1 on the gradient at the moved
    iterate sums in torch's order."""
    jl, tl = _lw(algo, epochs)
    d = sum(v.size for v in params.values())
    duals = (0.01 * np.random.RandomState(2).randn(M, d)).astype(np.float32)
    duals = duals if tl.has_dual else None
    want, want_d = _jax_local(jl, data, params, duals)
    got, got_d = _port_local(tl, data, params, duals)
    assert got.shape == want.shape == (M, d)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    if tl.has_dual:
        np.testing.assert_allclose(got_d, want_d, rtol=0, atol=1e-8)


@pytest.mark.parametrize("algo", ["sgd", "fedavg", "fedprox", "feddyn"])
def test_epoch_one_at_static_bound_two_is_the_one_gradient_round(
        data, params, algo):
    """The pin: compiled for ``max_epochs`` 2 and run at E = 1, sgd gives
    ``device_grads`` bitwise (the epoch-0 gradient is the shared-weight
    product), and every algorithm its own E = 1 run bitwise (the cut epoch
    leaves the carry untouched)."""
    xd, yd = data
    pt = {k: _t(v) for k, v in params.items()}
    _, lw2 = _lw(algo, 2)
    assert lw2.max_epochs == 2 and not lw2.identity
    lw2 = lw2.with_overrides(local_epochs=1.0)
    _, lw1 = _lw(algo, 1)
    d = sum(v.size for v in params.values())
    duals = torch.zeros((M, d)) if lw2.has_dual else None
    gf = tpr.flat_grad_fn(pt)
    got, _, gd = twork.local_device_grads(lw2, gf, pt, _t(xd), _t(yd).long(),
                                          None, duals)
    one, _, od = twork.local_device_grads(lw1, gf, pt, _t(xd), _t(yd).long(),
                                          None, duals)
    np.testing.assert_array_equal(_bits(got), _bits(one))
    if algo == "sgd":
        want, _ = tpr.device_grads(pt, _t(xd), _t(yd).long(), None)
        assert torch.equal(got, want)
    if lw2.has_dual:
        np.testing.assert_array_equal(_bits(gd), _bits(od))


def test_flat_grad_fn_matches_reference_grad(data, params):
    """The gradient at per-device iterates (the closed form) against
    ``jax.grad`` of the reference's loss, and at equal iterates against the
    shared-weight ``device_grads`` to the same bar."""
    xd, yd = data
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    flat, unravel = jax.flatten_util.ravel_pytree(pj)
    rs = np.random.RandomState(5)
    w = (np.asarray(flat)[None] + 0.05 * rs.randn(M, flat.size)).astype(
        np.float32)
    gfj = jpr.flat_grad_fn(unravel)
    want = np.asarray(jax.jit(jax.vmap(gfj))(w, jnp.asarray(xd),
                                             jnp.asarray(yd)))
    pt = {k: _t(v) for k, v in params.items()}
    got = tpr.flat_grad_fn(pt)(_t(w), _t(xd), _t(yd).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-8)
    # G points of per-device iterates: each point's as its own call
    w2 = _t(np.stack([w, w[::-1].copy()]))
    both = tpr.flat_grad_fn(pt)(w2, _t(xd), _t(yd).long())
    np.testing.assert_array_equal(_bits(both[0]), _bits(got))


@pytest.mark.parametrize("steps", [2, 3])
def test_legacy_local_steps_device_matches_reference(data, params, steps):
    """``device_grads(local_steps > 1)``, the legacy FedAvg device:
    J fused steps, then the product with ``f32(1 / (J lr))``."""
    xd, yd = data
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    _, unravel = jax.flatten_util.ravel_pytree(pj)
    d = sum(v.size for v in params.values())
    want, _ = jax.jit(lambda p: jpr.device_grads(
        p, unravel, jnp.asarray(xd), jnp.asarray(yd),
        jnp.zeros((M, d), jnp.float32), local_steps=steps,
        local_lr=0.1))(pj)
    pt = {k: _t(v) for k, v in params.items()}
    got, _ = tpr.device_grads(pt, _t(xd), _t(yd).long(), None,
                              local_steps=steps, local_lr=0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-7)
    one = tpr.flat_local_delta(pt, _t(xd), _t(yd).long(), steps, 0.1)
    assert torch.equal(one, got)


def test_grid_of_points_equals_each_point(data, params):
    """Params, duals and knobs of G = 3 points: each point's deltas and
    duals are its own call's, bitwise."""
    xd, yd = data
    _, tl = _lw("feddyn", 4)
    pt = {k: _t(v) for k, v in params.items()}
    d = sum(v.size for v in params.values())
    rs = np.random.RandomState(7)
    duals = _t((0.01 * rs.randn(3, M, d)).astype(np.float32))
    ps = {k: torch.stack([v, 2 * v, -v]) for k, v in pt.items()}
    e, al = [1.0, 4.0, 2.0], [0.1, 0.0, 0.3]
    grid = tl.with_overrides(local_epochs=e, dyn_alpha=al)
    gf = tpr.flat_grad_fn(pt)
    got, _, gd = twork.local_device_grads(grid, gf, ps, _t(xd),
                                          _t(yd).long(), None, duals)
    for g in range(3):
        one = tl.with_overrides(local_epochs=e[g], dyn_alpha=al[g])
        want, _, wd = twork.local_device_grads(
            one, gf, {k: v[g] for k, v in ps.items()}, _t(xd),
            _t(yd).long(), None, duals[g])
        np.testing.assert_array_equal(_bits(got[g]), _bits(want))
        np.testing.assert_array_equal(_bits(gd[g]), _bits(wd))
