"""The port's MoE, Mamba2 and RWKV-6 blocks (``repro_torch.models.moe``,
``ssm``, ``rwkv``) one at a time against the JAX package's on the CPU.

The same seeded numpy inputs and the reference's own params go through
both; the reference runs under ``jit``, as its tests run it.  Bars:

* ``moe_mlp``'s output and aux within rtol 1e-5 / atol 1e-6; the routing
  (``topi``, ``pos``, ``keep``) bitwise the reference's, read from its own
  ``jax.lax.top_k`` and ``jax.nn.one_hot`` calls in an eager run;
* the gradients of every block, leaf by leaf, within rtol 1e-4 and an
  absolute term of ``SCALE_ATOL`` times the leaf's largest magnitude: the
  cotangent is an arbitrary unit normal over 128 tokens, so a gradient
  entry is a sum of terms of size ~max|g| and cancels to any size; an
  absolute bar must scale with it.  ``SCALE_ATOL`` is 2e-6 (measured at
  most 5.2e-7) for MoE and RWKV-6, 5e-5 for Mamba2 (measured 2.3e-5, the
  ``a_log`` gradient): the SSD subtracts chunk sums of log-decays that
  reach a few hundred, so the last-bit differences of the products (MKL
  against Eigen) move a decay by |cum| x eps ~ 3e-5 relative (ROADMAP §3);
* Mamba2 and RWKV-6 outputs within rtol 1e-5 and 1e-5 x max|y| (measured
  2.4e-6 x max|y| for Mamba2, the reference's own jit-against-eager spread
  being 2.0e-6; 5.9e-7 for RWKV-6);
* the float32 helpers bitwise: ``cumsum_xla`` against ``jnp.cumsum``,
  ``a_log`` against ``log(jnp.linspace(1, 16, H))`` for every head count
  up to 352.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import RWKVConfig as JRWKVConfig
from repro.configs.base import SSMConfig as JSSMConfig
from repro.models import moe as jmoe
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro_torch import rng
from repro_torch.configs.base import MoEConfig, RWKVConfig, SSMConfig
from repro_torch.convert import to_torch, tree_leaves, tree_map
from repro_torch.models import moe, rwkv, ssm

D = 128
MOE = dict(num_experts=4, top_k=2, d_expert=64)
SSM = dict(d_state=16, expand=2, head_dim=32, chunk=32)
RWKV = dict(head_dim=32, chunk=32, decay_lora=16)

OUT_RTOL, OUT_ATOL = 1e-5, 1e-6
SCAN_OUT_SCALE_ATOL = 1e-5
GRAD_RTOL = 1e-4
SCALE_ATOL = {"moe": 2e-6, "rwkv": 2e-6, "mamba": 5e-5}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(B, L, seed=0, shift=0.0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, L, D)) + shift).astype(np.float32)


def _paths(tree):
    return [tuple(k.key for k in p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _grads_both(jfn, tfn, params, x, seed=1):
    """The reference's and the port's gradients of ``sum(f(p, x) * gy)``
    for a unit normal cotangent, as [x, *leaves] lists of numpy arrays,
    and both outputs."""
    jy = np.asarray(jax.jit(jfn)(params, x))
    gy = np.random.default_rng(seed).standard_normal(jy.shape).astype(
        np.float32)
    jg = jax.jit(jax.grad(lambda p, x: jnp.sum(jfn(p, x) * gy),
                          argnums=(0, 1)))(params, x)
    tp = tree_map(lambda a: a.requires_grad_(True), to_torch(params, "cpu"))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tfn(tp, tx)
    tg = torch.autograd.grad((ty * torch.from_numpy(gy)).sum(),
                             [tx] + tree_leaves(tp), allow_unused=True,
                             materialize_grads=True)
    want = [np.asarray(jg[1])] + [np.asarray(a) for a in jax.tree.leaves(jg[0])]
    return jy, ty.detach().numpy(), want, [g.numpy() for g in tg]


def _assert_grads(want, got, names, scale_atol):
    for name, a, b in zip(names, want, got):
        assert np.isfinite(b).all(), name
        np.testing.assert_allclose(
            b, a, rtol=GRAD_RTOL, atol=scale_atol * np.abs(a).max(),
            err_msg=str(name))


def _assert_scan_out(jy, ty):
    np.testing.assert_allclose(ty, jy, rtol=OUT_RTOL,
                               atol=SCAN_OUT_SCALE_ATOL * np.abs(jy).max())


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe_params(seed=0):
    return jax.device_get(jmoe.init_moe(jax.random.PRNGKey(seed), D,
                                        JMoEConfig(**MOE)))


def test_init_moe_bitwise():
    want = _moe_params(3)
    got = moe.init_moe(rng.PRNGKey(3, device="cpu"), D, MoEConfig(**MOE))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def _ref_routing(params, x, monkeypatch, **kw):
    """The reference's ``topi`` and ``pos`` from its own ``top_k`` and
    ``one_hot`` calls (eager, so the values are concrete), and its
    ``(out, aux)``."""
    seen, calls = {}, []
    top_k, one_hot = jax.lax.top_k, jax.nn.one_hot

    def spy_top_k(a, k):
        v, i = top_k(a, k)
        seen["topi"] = np.asarray(i)
        return v, i

    def spy_one_hot(a, n, **okw):
        calls.append((np.asarray(a), n))
        return one_hot(a, n, **okw)

    monkeypatch.setattr(jax.lax, "top_k", spy_top_k)
    monkeypatch.setattr(jax.nn, "one_hot", spy_one_hot)
    jmoe.moe_mlp(params, x, JMoEConfig(**MOE), **kw)
    monkeypatch.undo()
    # one-hots of topi (int32), topi, pos over the C slots, topi[..., 0]
    seen["pos"], seen["C"] = calls[2]
    out, aux = jax.jit(lambda p, x: jmoe.moe_mlp(p, x, JMoEConfig(**MOE),
                                                 **kw))(params, x)
    return seen, np.asarray(out), float(aux)


def _check_moe(params, x, monkeypatch, **kw):
    seen, jout, jaux = _ref_routing(params, x, monkeypatch, **kw)
    cfg = MoEConfig(**MOE)
    tp, tx = to_torch(params, "cpu"), torch.from_numpy(x)
    B, L, _ = x.shape
    g = moe.group_size_for(B * L, kw.get("group_size", 256))
    r = moe.route(tp, tx.reshape(B * L // g, g, D), cfg)
    assert r.C == seen["C"]
    np.testing.assert_array_equal(r.topi.numpy(), seen["topi"])
    np.testing.assert_array_equal(r.pos.numpy(), seen["pos"])
    np.testing.assert_array_equal(r.keep.numpy(), seen["pos"] < seen["C"])
    out, aux = moe.moe_mlp(tp, tx, cfg, **kw)
    np.testing.assert_allclose(out.numpy(), jout, rtol=OUT_RTOL,
                               atol=OUT_ATOL)
    np.testing.assert_allclose(float(aux), jaux, rtol=OUT_RTOL, atol=OUT_ATOL)
    return r


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_moe_mlp_matches_reference(seed, monkeypatch):
    """2 x 12 tokens: one group of 24 <= 64, so lossless capacity."""
    params, x = _moe_params(seed), _x(2, 12, seed)
    r = _check_moe(params, x, monkeypatch)
    assert r.C == 24 and bool(r.keep.all())
    cfg = JMoEConfig(**MOE)
    jy, ty, want, got = _grads_both(
        lambda p, x: jmoe.moe_mlp(p, x, cfg)[0],
        lambda p, x: moe.moe_mlp(p, x, MoEConfig(**MOE))[0], params, x)
    np.testing.assert_allclose(ty, jy, rtol=OUT_RTOL, atol=OUT_ATOL)
    _assert_grads(want, got, ["x"] + _paths(params), SCALE_ATOL["moe"])


def test_moe_aux_gradient_matches_reference():
    params, x = _moe_params(0), _x(2, 12, 0)
    cfg = JMoEConfig(**MOE)
    _, _, want, got = _grads_both(
        lambda p, x: jmoe.moe_mlp(p, x, cfg)[1][None],
        lambda p, x: moe.moe_mlp(p, x, MoEConfig(**MOE))[1][None],
        params, x)
    # the aux reaches the router only through ``probs``: no expert weight
    # gradient in the reference, a zero one in the port (allow_unused)
    for name, a, b in zip(["x"] + _paths(params), want, got):
        np.testing.assert_allclose(b, a, rtol=GRAD_RTOL,
                                   atol=SCALE_ATOL["moe"] * max(
                                       np.abs(a).max(), 1e-30),
                                   err_msg=str(name))


def test_moe_mlp_capacity_drops_tokens(monkeypatch):
    """B * L = 256: one group of 256 > 64, so C = int(256 * 2 * 1.25 / 4) =
    160; a router biased toward expert 0 sends it every token, and 96 of
    its choices are dropped, as in the reference."""
    params = _moe_params(0)
    params["router"] = params["router"].copy()
    params["router"][:, 0] += 0.5
    x = _x(2, 128, 4, shift=1.0)
    r = _check_moe(params, x, monkeypatch)
    assert r.C == 160
    assert bool((r.topi[..., 0] == 0).all())
    assert int((~r.keep).sum()) == 96


def test_moe_mlp_group_size_walks_down(monkeypatch):
    """3 x 100 = 300 tokens: 256 does not divide them, so g walks down to
    150 (G = 2, C = 93); and a group size of 7 over 2 x 12 tokens gives
    g = 6."""
    r = _check_moe(_moe_params(1), _x(3, 100, 5), monkeypatch)
    assert r.topi.shape[:2] == (2, 150) and r.C == 93
    assert moe.group_size_for(300) == 150 and moe.group_size_for(24, 7) == 6
    r = _check_moe(_moe_params(1), _x(2, 12, 6), monkeypatch, group_size=7)
    assert r.topi.shape[:2] == (4, 6)


def test_moe_mlp_top_k_ties_take_the_lower_index(monkeypatch):
    """Zero router columns give logits of exactly 0, so their experts'
    probabilities tie for every token: both packages put the lower index
    first, as ``jax.lax.top_k`` does.  All four columns zero: every token
    takes experts 0 and 1; columns 1-3 zero: a token takes 0 and 1 where
    its expert-0 logit is positive, 1 and 2 where it is negative."""
    params = _moe_params(2)
    x = _x(2, 12, 7)
    for zero_from in (0, 1):
        router = _moe_params(2)["router"].copy()
        router[:, zero_from:] = 0.0
        params["router"] = router
        r = _check_moe(params, x, monkeypatch)
        logit0 = (x.reshape(1, -1, D) @ router[:, 0])
        first = np.where(logit0 > 0, 0, 1) if zero_from else \
            np.zeros(logit0.shape, np.int64)
        np.testing.assert_array_equal(r.topi.numpy(),
                                      np.stack([first, first + 1], -1))


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------


def _mamba_params(seed=0, **cfg):
    return jax.device_get(jssm.init_mamba2(jax.random.PRNGKey(seed), D,
                                           JSSMConfig(**dict(SSM, **cfg))))


def test_init_mamba2_bitwise():
    want = _mamba_params(3)
    got = ssm.init_mamba2(rng.PRNGKey(3, device="cpu"), D, SSMConfig(**SSM))
    assert _paths(got) == _paths(want)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("H", [1, 2, 3, 7, 8, 16, 100, 112, 128, 255, 352])
def test_a_log_bitwise(H):
    want = np.asarray(jnp.log(jnp.linspace(1.0, 16.0, H).astype(jnp.float32)))
    np.testing.assert_array_equal(ssm.a_log_init(H).numpy(), want)


@pytest.mark.parametrize("n", [1, 5, 16, 17, 32, 64, 256, 300])
def test_cumsum_xla_bitwise(n):
    x = (30 * np.random.default_rng(n).standard_normal((2, 3, n, 4))).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=2))(x))
    np.testing.assert_array_equal(
        ssm.cumsum_xla(torch.from_numpy(x), 2).numpy(), want)


def test_softplus_is_logaddexp_everywhere():
    x = np.concatenate([np.linspace(-60, 60, 241),
                        [0.0, 19.5, 20.5, 25.0, 88.0]]).astype(np.float32)
    want = np.asarray(jax.jit(jax.nn.softplus)(x))
    gwant = np.asarray(jax.jit(jax.vmap(jax.grad(jax.nn.softplus)))(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = ssm.softplus(tx)
    (g,) = torch.autograd.grad(got.sum(), [tx])
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-30)
    np.testing.assert_allclose(g.numpy(), gwant, rtol=1e-6, atol=1e-30)


def _mamba_fns(cfg):
    jc, tc = JSSMConfig(**cfg), SSMConfig(**cfg)
    return (lambda p, x: jssm.mamba2_forward(p, x, D, jc)[0],
            lambda p, x: ssm.mamba2_forward(p, x, D, tc)[0])


@pytest.mark.parametrize("L", [64, 48])
def test_mamba2_forward_matches_reference(L):
    """L = 64 with chunk 32: two chunks, the state carried between them;
    L = 48: the chunk walks down to 24, two chunks again."""
    params, x = _mamba_params(0), _x(2, L, 1)
    jy, ty, want, got = _grads_both(*_mamba_fns(SSM), params, x)
    _assert_scan_out(jy, ty)
    _assert_grads(want, got, ["x"] + _paths(params), SCALE_ATOL["mamba"])


def test_mamba2_large_dt_bias_gradient_is_finite():
    """dt_bias = 30: softplus is past ``F.softplus``'s switch and every
    decay is ~exp(-30 |A|); the masked gate keeps the gradient finite."""
    params = _mamba_params(2)
    params["dt_bias"] = np.full_like(params["dt_bias"], 30.0)
    jy, ty, want, got = _grads_both(*_mamba_fns(SSM), params, _x(2, 64, 2))
    assert all(np.isfinite(g).all() for g in want)
    _assert_scan_out(jy, ty)
    _assert_grads(want, got, ["x"] + _paths(params), SCALE_ATOL["mamba"])


def test_mamba2_decode_step_and_state_match_reference():
    """From a carried state: a 16-token prefill and one decode step."""
    jc, tc = JSSMConfig(**SSM), SSMConfig(**SSM)
    params = _mamba_params(4)
    r = np.random.default_rng(8)
    state = {"ssm": r.standard_normal((2, 8, 32, 16)).astype(np.float32),
             "conv": r.standard_normal((2, 3, 256)).astype(np.float32)}
    want0 = jax.device_get(jssm.init_mamba2_state(jc, D, 2))
    got0 = ssm.init_mamba2_state(tc, D, 2)
    assert {k: v.shape for k, v in want0.items()} == \
        {k: tuple(v.shape) for k, v in got0.items()}
    for L in (16, 1):
        x = _x(2, L, 9 + L)
        jy, jst = jax.jit(lambda p, x, s: jssm.mamba2_forward(
            p, x, D, jc, s))(params, x, state)
        ty, tst = ssm.mamba2_forward(to_torch(params, "cpu"),
                                     torch.from_numpy(x), D, tc,
                                     to_torch(state, "cpu"))
        _assert_scan_out(np.asarray(jy), ty.numpy())
        for k in ("ssm", "conv"):
            _assert_scan_out(np.asarray(jst[k]), tst[k].numpy())


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------


def _time_params(seed=0):
    return jax.device_get(jrwkv.init_rwkv6_time(jax.random.PRNGKey(seed), D,
                                                JRWKVConfig(**RWKV)))


def _channel_params(seed=0):
    return jax.device_get(jrwkv.init_rwkv6_channel(
        jax.random.PRNGKey(seed), D, 256))


def test_init_rwkv6_bitwise():
    for want, got in (
            (_time_params(3), rwkv.init_rwkv6_time(
                rng.PRNGKey(3, device="cpu"), D, RWKVConfig(**RWKV))),
            (_channel_params(3), rwkv.init_rwkv6_channel(
                rng.PRNGKey(3, device="cpu"), D, 256))):
        assert _paths(got) == _paths(want)
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("L", [64, 40])
def test_rwkv6_time_mix_matches_reference(L):
    """L = 64 with chunk 32: two checkpointed chunks of 32 steps (L = 40:
    chunks of 20); the gradient through the recomputed chunks too."""
    jc, tc = JRWKVConfig(**RWKV), RWKVConfig(**RWKV)
    params = _time_params(0)
    # a live bonus and decays away from exp(-exp(-6)) ~ 1
    r = np.random.default_rng(3)
    params["u"] = (0.5 * r.standard_normal(params["u"].shape)).astype(
        np.float32)
    params["w0"] = (r.uniform(-3, 1, params["w0"].shape)).astype(np.float32)
    jy, ty, want, got = _grads_both(
        lambda p, x: jrwkv.rwkv6_time_mix(p, x, jc)[0],
        lambda p, x: rwkv.rwkv6_time_mix(p, x, tc)[0], params, _x(2, L, 2))
    _assert_scan_out(jy, ty)
    _assert_grads(want, got, ["x"] + _paths(params), SCALE_ATOL["rwkv"])


def test_rwkv6_checkpointed_chunks_equal_one_chunk():
    """The chunking changes what backward keeps, not a bit of the
    result: chunk 16 over 64 steps against one chunk of 64."""
    params = tree_map(lambda a: a.requires_grad_(True),
                      to_torch(_time_params(1), "cpu"))
    x = torch.from_numpy(_x(2, 64, 3))
    outs = []
    for chunk in (16, 64):
        cfg = RWKVConfig(**dict(RWKV, chunk=chunk))
        y, _ = rwkv.rwkv6_time_mix(params, x, cfg)
        outs.append((y, torch.autograd.grad(y.square().sum(),
                                            tree_leaves(params))))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)


def test_rwkv6_channel_mix_matches_reference():
    params = _channel_params(0)
    jy, ty, want, got = _grads_both(
        lambda p, x: jrwkv.rwkv6_channel_mix(p, x)[0],
        lambda p, x: rwkv.rwkv6_channel_mix(p, x)[0], params, _x(2, 64, 4))
    np.testing.assert_allclose(ty, jy, rtol=OUT_RTOL, atol=OUT_ATOL)
    _assert_grads(want, got, ["x"] + _paths(params), SCALE_ATOL["rwkv"])


def test_rwkv6_decode_states_match_reference():
    """Both mixes from carried states, a 16-token prefill and one step."""
    jc, tc = JRWKVConfig(**RWKV), RWKVConfig(**RWKV)
    pt, pc = _time_params(5), _channel_params(5)
    want0 = jax.device_get(jrwkv.init_rwkv6_state(jc, D, 2))
    got0 = rwkv.init_rwkv6_state(tc, D, 2)
    assert _paths(got0) == _paths(want0)
    assert [tuple(a.shape) for a in tree_leaves(got0)] == \
        [a.shape for a in jax.tree.leaves(want0)]
    r = np.random.default_rng(6)
    st = {"time": {"shift": r.standard_normal((2, 1, D)).astype(np.float32),
                   "wkv": r.standard_normal((2, 4, 32, 32)).astype(
                       np.float32)},
          "channel": {"shift": r.standard_normal((2, 1, D)).astype(
              np.float32)}}
    for L in (16, 1):
        x = _x(2, L, 20 + L)
        jt = jax.jit(lambda p, x, s: jrwkv.rwkv6_time_mix(p, x, jc, s))(
            pt, x, st["time"])
        jch = jax.jit(lambda p, x, s: jrwkv.rwkv6_channel_mix(p, x, s))(
            pc, x, st["channel"])
        tt = rwkv.rwkv6_time_mix(to_torch(pt, "cpu"), torch.from_numpy(x),
                                 tc, to_torch(st["time"], "cpu"))
        tch = rwkv.rwkv6_channel_mix(to_torch(pc, "cpu"), torch.from_numpy(x),
                                     to_torch(st["channel"], "cpu"))
        for (jo, js), (to, ts) in ((jt, tt), (jch, tch)):
            _assert_scan_out(np.asarray(jo), to.numpy())
            for a, b in zip(jax.tree.leaves(js), tree_leaves(ts)):
                _assert_scan_out(np.asarray(a), b.numpy())
