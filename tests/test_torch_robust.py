"""The robustness axis, repro_torch against repro, function by function:
fault traces, robust aggregators, the transmit power cap, the round guard,
the fused AMP decode on non-finite observations, and the XLA-order sums
they share with the channel axes.

The reference runs these functions inside ``jit`` (its engine and sweeps);
each port function is held against ``jax.jit`` of its reference with every
scalar traced: bitwise, NaN for NaN, unless a test names a tolerance.
Inputs are drawn from numpy seeds.  The rounds and runs are in
``tests/test_torch_robust_engine.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import amp as jamp
from repro.optim.optim import Optimizer as JaxOptimizer
from repro.robust import aggregators as jagg
from repro.robust import faults as jfl
from repro.robust import guards as jgd
from repro.train import paper_repro as jpr
from repro_torch import rng
from repro_torch import robust
from repro_torch.core import fading as tfad
from repro_torch.core.amp import amp_blocked_core
from repro_torch.device import xla_sum
from repro_torch.kernels import ref
from repro_torch.optim.optim import Optimizer
from repro_torch.robust import aggregators as tagg
from repro_torch.robust import faults as tfl
from repro_torch.robust import guards as tgd
from repro_torch.train import paper_repro as tpr

KINDS = ("nan", "inf", "stale", "dropout")


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _bits(x):
    x = _np(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _same_bits(got, want):
    """Bitwise, any NaN matching any NaN (a NaN's payload is not held)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if got.dtype == np.float32:
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(got)
        np.testing.assert_array_equal(_bits(got[ok]), _bits(want[ok]))
    else:
        np.testing.assert_array_equal(got, want)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _f32(v):
    return torch.tensor(np.float32(v))


def test_robust_all_matches_reference():
    from repro import robust as jrobust
    assert robust.__all__ == jrobust.__all__
    assert tfl.SALT_FAULT == jfl.SALT_FAULT
    assert tfl.FAULT_SEED_SALT == jfl.FAULT_SEED_SALT
    assert tgd.GuardConfig() == tgd.GuardConfig(**vars(jgd.GuardConfig()))
    assert tgd.GuardState._fields == jgd.GuardState._fields


# ---------------------------------------------------------------------------
# fault traces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_fault_draw_bitwise(kind):
    """Every field of the draw, over rounds and seeds, at rates 0 and 1
    too: bitwise ``jax.jit`` of the reference."""
    ref = jax.jit(lambda fk, k, a, b, c: jfl.fault_draw(
        fk, k, 25, byzantine_frac=a, fault_rate=b, erasure_prob=c,
        fault_kind=kind))
    for seed, t, rates in ((0, 0, (0.3, 0.2, 0.1)), (3, 7, (0.1, 0.5, 0.4)),
                           (1, 19, (0.0, 0.0, 0.0)), (2, 4, (1.0, 1.0, 1.0))):
        rk = jax.random.fold_in(jax.random.PRNGKey(1000 + t), jfl.SALT_FAULT)
        want = ref(jfl.fault_base_key(seed), rk, *map(jnp.float32, rates))
        got = tfl.fault_draw(
            tfl.fault_base_key(seed, "cpu"),
            rng.fold_in(rng.PRNGKey(1000 + t), tfl.SALT_FAULT), 25,
            byzantine_frac=_f32(rates[0]), fault_rate=_f32(rates[1]),
            erasure_prob=_f32(rates[2]), fault_kind=kind)
        for name in ("byz", "poison", "stale", "dropout", "erased"):
            _same_bits(getattr(got, name), getattr(want, name))
        assert np.isnan(got.poison_value) == np.isnan(want.poison_value)
        if kind == "inf":
            assert got.poison_value == want.poison_value == float("inf")


def test_unknown_kinds_raise_as_the_reference():
    key = rng.PRNGKey(0)
    with pytest.raises(ValueError, match="fault_kind"):
        tfl.fault_draw(key, key, 4, byzantine_frac=0.1, fault_rate=0.1,
                       erasure_prob=0.0, fault_kind="bitflip")
    draw = tfl.fault_draw(key, key, 4, byzantine_frac=0.1, fault_rate=0.1,
                          erasure_prob=0.0)
    with pytest.raises(ValueError, match="byz_attack"):
        tfl.apply_gradient_faults(torch.zeros(4, 3), draw,
                                  byz_attack="noise")


def test_byzantine_sets_nested_and_batched():
    """A ``(G,)`` fraction gives each point's own set, bitwise the
    reference's ``vmap``, and the sets are nested in the fraction."""
    fracs = np.asarray([0.0, 0.1, 0.3, 0.5, 1.0], np.float32)
    want = jax.jit(jax.vmap(lambda f: jfl.byzantine_set(
        jfl.fault_base_key(0), 25, f)))(fracs)
    got = tfl.byzantine_set(tfl.fault_base_key(0, "cpu"), 25, _t(fracs))
    _same_bits(got, want)
    for g in range(len(fracs)):
        _same_bits(tfl.byzantine_set(tfl.fault_base_key(0, "cpu"), 25,
                                     _f32(fracs[g])), got[g])
    assert all(bool((got[g] <= got[g + 1]).all())
               for g in range(len(fracs) - 1))
    assert int(got[0].sum()) == 0 and int(got[-1].sum()) == 25


def test_fault_draw_for_a_point_axis():
    """G round keys and ``(G,)`` rates give ``(G, m)`` draws, each point's
    bitwise its own call's."""
    keys = rng.fold_in(rng.split(rng.PRNGKey(1004), 3), tfl.SALT_FAULT)
    rates = dict(byzantine_frac=_t(np.float32([0.1, 0.2, 0.3])),
                 fault_rate=_t(np.float32([0.2, 0.0, 0.5])),
                 erasure_prob=_t(np.float32([0.3, 0.1, 0.0])))
    fk = tfl.fault_base_key(5, "cpu")
    got = tfl.fault_draw(fk, keys, 25, fault_kind="stale", **rates)
    for g in range(3):
        one = tfl.fault_draw(fk, keys[g], 25, fault_kind="stale",
                             **{k: v[g] for k, v in rates.items()})
        for a, b in zip(got[:5], one[:5]):
            _same_bits(a[g], b)


@pytest.mark.parametrize("attack", ["sign_flip", "scale"])
def test_gradient_and_frame_faults_bitwise(attack):
    rs = np.random.default_rng(11)
    grads = rs.standard_normal((25, 300)).astype(np.float32)
    frames = rs.standard_normal((25, 130)).astype(np.float32)
    for kind in KINDS:
        rk = jax.random.fold_in(jax.random.PRNGKey(1002), jfl.SALT_FAULT)
        dj = jfl.fault_draw(jfl.fault_base_key(0), rk, 25,
                            byzantine_frac=0.3, fault_rate=0.3,
                            erasure_prob=0.2, fault_kind=kind)
        dt = tfl.fault_draw(tfl.fault_base_key(0, "cpu"),
                            rng.fold_in(rng.PRNGKey(1002), tfl.SALT_FAULT),
                            25, byzantine_frac=0.3, fault_rate=0.3,
                            erasure_prob=0.2, fault_kind=kind)
        gj = jax.jit(lambda g, s: jfl.apply_gradient_faults(
            g, dj, byz_attack=attack, byz_scale=s))(grads, jnp.float32(20.0))
        gt = tfl.apply_gradient_faults(_t(grads), dt, byz_attack=attack,
                                       byz_scale=_f32(20.0))
        _same_bits(gt, gj)
        _same_bits(tfl.apply_frame_faults(_t(frames), dt),
                   jax.jit(lambda f: jfl.apply_frame_faults(f, dj))(frames))
        cohort = np.asarray([3, 0, 24, 7], np.int32)
        for a, b in zip(tfl.take_rows(dt, _t(cohort).long())[:5],
                        jfl.take_rows(dj, jnp.asarray(cohort))[:5]):
            _same_bits(a, b)


# ---------------------------------------------------------------------------
# aggregators and the power cap
# ---------------------------------------------------------------------------


def _frames(m, s, seed, poison=()):
    rs = np.random.default_rng(seed)
    f = (rs.standard_normal((m, s))
         * rs.uniform(0.2, 5.0, (m, 1))).astype(np.float32)
    f[:, :3] = 0.0                                # sparse-frame zeros
    for row, value in poison:
        f[row] = value
    return f


#: (m, s, dead rows, poisoned rows): the paper's 25 devices with NaN and
#: Inf frames, an all-dead round, a majority-poisoned one, and device
#: counts on both sides of XLA's vectorised norm-capped sum
AGG_CASES = [(7, 300, (3,), ()), (25, 2050, (1, 5, 20), ((2, np.nan),)),
             (25, 130, (), ((0, np.inf), (9, np.nan))),
             (4, 66, (0, 1, 2, 3), ()),
             (5, 40, (), ((1, np.nan), (2, np.nan), (3, np.nan))),
             (16, 40, (2,), ()), (19, 33, (), ((4, -np.inf),)),
             (32, 130, (0,), ((5, np.nan),)), (40, 40, (), ()),
             (1, 40, (0,), ()), (3, 17, (), ())]


@pytest.mark.parametrize("aggregator", ["trimmed_mean", "median",
                                        "norm_cap"])
@pytest.mark.parametrize("case", range(len(AGG_CASES)))
def test_robust_combine_bitwise(aggregator, case):
    """Dead rows, NaN and Inf rows, an all-dead round and a
    majority-poisoned one: bitwise ``jax.jit(robust_combine)``."""
    m, s, dead, poison = AGG_CASES[case]
    f = _frames(m, s, case, poison)
    alive = np.ones(m, bool)
    alive[list(dead)] = False
    m_eff = np.float32(max(alive.sum(), 1))
    ref = jax.jit(lambda f, a, me, t, c: jagg.robust_combine(
        f, a, me, aggregator=aggregator, trim_frac=t, norm_cap=c))
    for trim, cap in ((0.1, 1.5), (0.3, 1.0), (0.0, 0.5)):
        want = ref(f, alive, m_eff, jnp.float32(trim), jnp.float32(cap))
        got = tagg.robust_combine(_t(f), _t(alive), _t(m_eff),
                                  aggregator=aggregator,
                                  trim_frac=_f32(trim), norm_cap=_f32(cap))
        _same_bits(got, want)


def test_norm_capped_sum_at_20_to_23_devices():
    """At 20 to 23 devices XLA sums the norm-capped frames in an order the
    port does not reproduce (ROADMAP queue 3): within one ulp of the
    largest term per device, the bound of a reordered float32 sum."""
    for m in (20, 21, 22, 23):
        f = _frames(m, 130, m)
        alive = np.ones(m, bool)
        want = np.asarray(jax.jit(jagg.norm_capped_sum)(f, alive,
                                                         jnp.float32(1.2)))
        got = tagg.norm_capped_sum(_t(f), _t(alive), _f32(1.2)).numpy()
        scale = np.abs(f).max()
        assert np.abs(got - want).max() <= m * np.spacing(np.float32(scale))


def test_robust_combine_point_axis():
    """G points of frames with ``(G,)`` scalars: each point bitwise its own
    call (elementwise ops and a sort, no batched reduction)."""
    f = np.stack([_frames(25, 130, g, ((g, np.nan),)) for g in range(3)])
    alive = np.random.default_rng(0).random((3, 25)) > 0.2
    m_eff = _t(np.maximum(alive.sum(-1), 1).astype(np.float32))
    trim, cap = _t(np.float32([0.1, 0.2, 0.3])), _t(np.float32([1, 1.5, 2]))
    for agg in ("trimmed_mean", "median", "norm_cap"):
        got = tagg.robust_combine(_t(f), _t(alive), m_eff, aggregator=agg,
                                  trim_frac=trim, norm_cap=cap)
        for g in range(3):
            one = tagg.robust_combine(_t(f[g]), _t(alive[g]), m_eff[g],
                                      aggregator=agg, trim_frac=trim[g],
                                      norm_cap=cap[g])
            _same_bits(got[g], one)
    with pytest.raises(ValueError, match="aggregator"):
        tagg.robust_combine(_t(f[0]), _t(alive[0]), 1.0, aggregator="krum")


@pytest.mark.parametrize("m,n", [(25, 2050), (4, 66), (25, 1962), (3, 31),
                                 (25, 12), (2, 4)])
def test_clip_frame_power_bitwise(m, n):
    """Frames at P_t pass with scale 1.0, amplified ones are cut onto the
    cap: bitwise ``jax.jit(clip_frame_power)``, and each of G points its
    own call."""
    rs = np.random.default_rng(m * n)
    f = rs.standard_normal((m, n)).astype(np.float32)
    f *= np.sqrt(500.0 / (f * f).sum(-1, keepdims=True)).astype(np.float32)
    f[::3] *= np.float32(20.0)
    ref = jax.jit(jagg.clip_frame_power)
    for p_max in (1.5 * 500.0, 500.0, 1e9):
        got = tagg.clip_frame_power(_t(f), _f32(p_max))
        _same_bits(got, ref(f, jnp.float32(p_max)))
    honest = tagg.clip_frame_power(_t(f[1:3]), _f32(750.0))
    _same_bits(honest, f[1:3])
    batch = np.stack([f, 2 * f, f[::-1].copy()])
    caps = np.float32([750.0, 500.0, 3000.0])
    got = tagg.clip_frame_power(_t(batch), _t(caps))
    for g in range(3):
        _same_bits(got[g], tagg.clip_frame_power(_t(batch[g]),
                                                 _f32(caps[g])))


@pytest.mark.parametrize("n", [1, 7, 32, 33, 48, 65, 130, 2050, 7850,
                               100_000])
def test_xla_sum_order(n):
    """``device.xla_sum`` is XLA's CPU reduction order: windows of 32 with
    the zero padding split between the ends, bitwise on rows and columns."""
    rs = np.random.default_rng(n)
    x = (rs.standard_normal((3, n)) * 10.0 ** rs.uniform(-3, 3, (3, n))
         ).astype(np.float32)
    _same_bits(xla_sum(_t(x), dim=-1), jax.jit(lambda v: jnp.sum(
        v, axis=-1))(x))
    _same_bits(xla_sum(_t(x * x), dim=-1), jax.jit(lambda v: jnp.sum(
        v * v, axis=-1))(x))
    if n <= 2050:
        xt = np.ascontiguousarray(x.T)
        _same_bits(xla_sum(_t(xt), dim=0), jax.jit(lambda v: jnp.sum(
            v, axis=0))(xt))


@pytest.mark.parametrize("window", [33, 48, 96])
def test_gauss_markov_weights_above_32_bitwise(window):
    """Windows above 32 that are not 64 or 128 (the split padding of XLA's
    windowed sum), held as the channel tests hold the others."""
    def weights(r):
        c = r ** jnp.arange(window, dtype=jnp.float32)
        return c / jnp.sqrt(jnp.sum(c * c))
    fn = jax.jit(weights)
    rhos = np.concatenate([[0.95, 0.5, 0.9, 0.3, 0.99, 0.7777, -0.6],
                           np.random.default_rng(window).uniform(0.3, 1, 60)])
    for rho in rhos.astype(np.float32):
        _same_bits(tfad.gauss_markov_weights(_f32(rho), window),
                   fn(jnp.float32(rho)))


# ---------------------------------------------------------------------------
# the round guard
# ---------------------------------------------------------------------------


def _guard_inputs(seed, d_in=8, n_out=5):
    rs = np.random.default_rng(seed)
    params = {"b": rs.standard_normal(n_out).astype(np.float32),
              "w": rs.standard_normal((d_in, n_out)).astype(np.float32)}
    ghat = rs.standard_normal(n_out + d_in * n_out).astype(np.float32)
    return params, ghat


def _unravel_np(v, params):
    """The flat ``[b, w]`` layout onto params of one point, or of G points
    (``w`` of rank 3)."""
    n_out = params["b"].shape[-1]
    d_in = params["w"].shape[-2]
    return {"b": v[..., :n_out],
            "w": v[..., n_out:].reshape(*v.shape[:-1], d_in, n_out)}


def _guard_pair(guard, params, ghat, gstate, losses, opt="sgd", lr=1.0):
    """One guarded step of each package from the same state: SGD at lr 1
    from the given params, so the step is exact and both packages' params
    can be held bitwise; ``losses`` stands in for the test loss."""
    jopt, topt = JaxOptimizer(name=opt, lr=lr), Optimizer(name=opt, lr=lr)
    jstate = jgd.GuardState(*map(jnp.float32, gstate))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    extras = (np.ones(3, np.float32), np.zeros(3, np.float32))
    old = (np.zeros(3, np.float32), np.ones(3, np.float32))

    def jloss(p):
        return jnp.float32(losses[0]) + 0.0 * jnp.sum(p["b"])

    def jstep(g):
        return jgd.guarded_step(
            guard, jstate, jopt, jparams, jopt.init(jparams), g,
            lambda v: _unravel_np(v, params), extras, old, jloss)
    want = jax.jit(jstep)(ghat)
    tparams = {k: _t(v) for k, v in params.items()}
    got = tgd.guarded_step(
        guard, tgd.GuardState(*map(_f32, gstate)), topt, tparams,
        topt.init(tparams), _t(ghat), lambda v: _unravel_np(v, tparams),
        tuple(map(_t, extras)), tuple(map(_t, old)),
        lambda p: _f32(losses[0]) + 0.0 * p["b"].sum())
    return got, want


@pytest.mark.parametrize("rail", ["clip", "skip", "diverge", "cooldown",
                                  "backoff_blend", "pass"])
def test_guarded_step_bitwise(rail):
    """Each rail on one step: params (SGD at lr 1: an exact step, then the
    blend's fused multiply-add), extras, the guard state and its metrics,
    bitwise ``jax.jit(guarded_step)``."""
    params, ghat = _guard_inputs(3)
    state = (1.0, 0.0, 2.0, 0.0, 0.0)
    guard = tgd.GuardConfig()
    loss = (1.0,)
    if rail == "clip":
        guard = tgd.GuardConfig(update_clip=0.5)
        ghat = ghat * np.float32(3.0)
    elif rail == "skip":
        ghat[4] = np.nan
    elif rail == "diverge":
        guard = tgd.GuardConfig(divergence_factor=1.5)
        loss = (5.0,)
    elif rail == "cooldown":
        guard = tgd.GuardConfig(divergence_factor=1.5)
        state, loss = (0.5, 3.0, 2.0, 1.0, 1.0), (5.0,)
    elif rail == "backoff_blend":
        guard = tgd.GuardConfig(divergence_factor=1.5, update_clip=2.0)
        state = (0.25, 0.0, 2.0, 0.0, 2.0)
    got, want = _guard_pair(guard, params, ghat, state, loss)
    (tp, _, te, tg, tl, tm), (jp, _, je, jg, jl, jm) = got, want
    for k in jp:
        _same_bits(tp[k], jp[k])
    for a, b in zip(te, je):
        _same_bits(a, b)
    for a, b in zip(tg, jg):
        _same_bits(a, b)
    _same_bits(tl, jl)
    assert set(tm) == set(jm)
    for k in jm:
        _same_bits(tm[k], jm[k])
    expect_skip = rail == "skip"
    expect_backoff = rail == "diverge"
    assert float(tm["guard_skipped"]) == float(expect_skip)
    assert float(tm["guard_backoff"]) == float(expect_backoff)


def test_guarded_step_point_axis():
    """A ``(G,)`` guard state: each point's rails and params are its own
    step's (one point skipped, one diverged, one passed)."""
    params, ghat = _guard_inputs(5)
    guard = tgd.GuardConfig(divergence_factor=1.5)
    ghats = np.stack([ghat, ghat * 2, ghat * 3])
    ghats[0, 2] = np.nan
    opt = Optimizer(name="adam", lr=1e-2)
    pg = {k: _t(np.stack([v] * 3)) for k, v in params.items()}
    state_g = opt.init(pg)
    state_g["count"] = state_g["count"].expand(3).clone()
    losses = _t(np.float32([1.0, 9.0, 1.0]))
    prev = tgd.GuardState(*(_t(np.float32(v)) for v in (
        [1, 1, 0.5], [0, 0, 0], [2, 2, 2], [0, 0, 0], [0, 0, 0])))
    extras = (torch.ones(3, 4), torch.zeros(3, 4))
    old = (torch.zeros(3, 4), torch.ones(3, 4))

    def unravel_t(v, like):
        return _unravel_np(v, like)
    got = tgd.guarded_step(guard, prev, opt, pg, state_g, _t(ghats),
                           lambda v: unravel_t(v, pg), extras, old,
                           lambda p: losses + 0.0 * p["b"].sum(-1))
    assert got[5]["guard_skipped"].tolist() == [1.0, 0.0, 0.0]
    assert got[5]["guard_backoff"].tolist() == [0.0, 1.0, 0.0]
    for g in range(3):
        p1 = {k: v[g] for k, v in pg.items()}
        s1 = opt.init(p1)
        one = tgd.guarded_step(
            guard, tgd.GuardState(*(v[g] for v in prev)), opt, p1, s1,
            _t(ghats[g]), lambda v: unravel_t(v, p1),
            tuple(e[g] for e in extras), tuple(o[g] for o in old),
            lambda p: losses[g] + 0.0 * p["b"].sum())
        for k in p1:
            _same_bits(got[0][k][g], one[0][k])
            _same_bits(got[1]["m"][k][g], one[1]["m"][k])
        assert int(got[1]["count"][g]) == int(one[1]["count"])
        for a, b in zip(got[2], one[2]):
            _same_bits(a[g], b)
        for a, b in zip(got[3], one[3]):
            _same_bits(a[g], b)


# ---------------------------------------------------------------------------
# non-finite observations: the fused AMP decode's plain version, accuracy
# ---------------------------------------------------------------------------


def _amp_y(n_blocks, s, c, seed, poison=None):
    """A block-sparse signal's projection plus a little noise, one entry of
    block 0 replaced by ``poison``."""
    rs = np.random.default_rng(seed)
    x = np.zeros((n_blocks, c), np.float32)
    for b in range(n_blocks):
        x[b, rs.choice(c, s // 8, replace=False)] = rs.standard_normal(s // 8)
    y = (ref.ota_project_ref(_t(x), 77, s).numpy()
         + 0.01 * rs.standard_normal((n_blocks, s))).astype(np.float32)
    if poison is not None:
        y[0, 5] = poison
    return y


@pytest.mark.parametrize("poison", [np.nan, np.inf, -np.inf, None])
def test_fused_amp_plain_on_nonfinite_y(poison):
    """The fused decode's plain version against the reference's Pallas
    kernel in interpret mode (as the reference's own tests run it) on a y
    with one NaN or Inf in block 0: the same NaN pattern (block 0 all NaN),
    the other block within rtol 1e-4 / atol 1e-5 and bitwise the clean
    decode's, with and without the point axis."""
    n_blocks, s, c, iters = 2, 64, 256, 6
    y = _amp_y(n_blocks, s, c, 1, poison)
    clean = _amp_y(n_blocks, s, c, 1, None)
    want = np.asarray(jamp.amp_blocked_core(jnp.asarray(y), 77, c,
                                            iters=iters, use_kernel=True))
    got = amp_blocked_core(_t(y), 77, c, iters)
    np.testing.assert_array_equal(np.isnan(_np(got)), np.isnan(want))
    if poison is not None:
        assert np.isnan(_np(got)[0]).all()
    ok = ~np.isnan(want)
    np.testing.assert_allclose(_np(got)[ok], want[ok], rtol=1e-4, atol=1e-5)
    _same_bits(got[1], amp_blocked_core(_t(clean), 77, c, iters)[1])
    # G = 3 points, one of them poisoned: the others keep their bits
    batch = np.stack([clean, y, clean * 2])
    got_g = amp_blocked_core(_t(batch), 77, c, iters)
    for g in range(3):
        _same_bits(got_g[g], amp_blocked_core(_t(batch[g]), 77, c, iters))


def test_accuracy_on_nan_params_matches_reference():
    """An unguarded poisoned round leaves NaN weights: argmax over NaN
    logits picks the first NaN in both packages, so accuracy agrees
    bitwise; the loss is NaN in both."""
    rs = np.random.default_rng(2)
    x = rs.standard_normal((300, 12)).astype(np.float32)
    y = rs.integers(0, 5, 300).astype(np.int32)
    w = rs.standard_normal((12, 5)).astype(np.float32)
    b = rs.standard_normal(5).astype(np.float32)
    w[3, 2] = np.nan                # NaN logits wherever x[:, 3] != 0
    b_nan = b.copy()
    b_nan[4] = np.nan               # column 4 NaN for every row
    for bb in (b, b_nan):
        jp = {"w": jnp.asarray(w), "b": jnp.asarray(bb)}
        tp = {"w": _t(w), "b": _t(bb)}
        _same_bits(tpr.accuracy(tp, _t(x), _t(y).long()),
                   jax.jit(jpr.accuracy)(jp, x, y))
        assert np.isnan(float(tpr.ce_loss(tp, _t(x), _t(y).long())))
        assert np.isnan(float(jpr.ce_loss(jp, x, y)))


# ---------------------------------------------------------------------------
# round_masked's robust branches against the reference's, under jit
# ---------------------------------------------------------------------------

M_DEV, D = 4, 256

#: analog and digital over the robust matrix: every fault kind, the analog
#: power cap on and off, every digital aggregator
ROUND_CASES = (
    [("a_dsgd", kind, "mean", clip) for kind in KINDS
     for clip in (False, True)]
    + [("d_dsgd", kind, agg, False) for kind in KINDS
       for agg in ("mean", "trimmed_mean", "median", "norm_cap")])


def _round_cfg(scheme, kind, aggregator, clip, **kw):
    from repro.configs.base import OTAConfig as JaxOTAConfig
    base = dict(scheme=scheme, s_frac=0.5, k_frac=0.25, p_avg=500.0,
                total_steps=10, projection="dense", amp_iters=6,
                mean_removal_steps=2, robust=True, byzantine_frac=0.5,
                byz_scale=20.0, fault_rate=0.4, fault_kind=kind,
                erasure_prob=0.3, aggregator=aggregator, trim_frac=0.25,
                norm_cap=1.5, clip_power=clip, power_cap=1.5)
    base.update(kw)
    return JaxOTAConfig(**base)


def _port_cfg(cfg):
    import dataclasses
    from repro_torch.configs.base import OTAConfig
    return OTAConfig(**dataclasses.asdict(cfg))


def _check_rounds(cfg, rounds=4, mask=None, same_nan=True):
    """``rounds`` rounds of ``round_masked`` from each package, each device's
    gradient drawn anew and each package carrying its own error state: the
    same NaN pattern in ghat and the error state, the finite entries within
    the AMP bar rtol 1e-4 / atol 1e-5 (analog) or the digital bar rtol 1e-5
    / atol 1e-7 (SBC's means sum in torch's order, ROADMAP queue 3), its
    atol scaled by the largest magnitude of the compared array, since
    Byzantine gradients reach 20 times the honest ones; the fault metrics
    equal."""
    from repro.core import schemes as jsc
    from repro.experiments import engine as jeng
    from repro_torch.core import schemes as tsc
    from repro_torch.experiments import engine as teng
    sj = jsc.get_scheme(cfg, D, M_DEV)
    st = tsc.get_scheme(_port_cfg(cfg), D, M_DEV, device="cpu")
    mask = np.ones(M_DEV, np.float32) if mask is None else mask
    ref = jax.jit(lambda g, dl, s, k: jeng.round_masked(
        sj, g, dl, s, k, jnp.asarray(mask), jsc.MACContext(m=M_DEV)))
    tol = (dict(rtol=1e-4, atol=1e-5) if st.analog
           else dict(rtol=1e-5, atol=1e-7))
    rs = np.random.default_rng(7)
    dj = np.zeros((M_DEV, D), np.float32)
    dt = torch.zeros((M_DEV, D))
    nan_rounds = 0
    for t in range(rounds):
        base = rs.standard_normal(D).astype(np.float32)
        grads = base[None] + 0.1 * rs.standard_normal((M_DEV, D)).astype(
            np.float32)
        gj, dj, mj = ref(grads, dj, jnp.int32(t),
                         jax.random.PRNGKey(1000 + t))
        gt, dt, mt = teng.round_masked(
            st, _t(grads), dt, t, rng.PRNGKey(1000 + t), _t(mask),
            tsc.MACContext(m=M_DEV))
        gj, dj = np.asarray(gj), np.asarray(dj)
        np.testing.assert_array_equal(np.isnan(_np(gt)), np.isnan(gj))
        nan_rounds += bool(np.isnan(gj).any())
        ok = np.isfinite(gj)
        for got, want, what in ((_np(gt)[ok], gj[ok], "ghat"),
                                (_np(dt), dj, "state")):
            scale = 1.0 if st.analog else max(1.0, float(np.abs(want).max(
                initial=0.0)))
            np.testing.assert_allclose(got, want, rtol=tol["rtol"],
                                       atol=tol["atol"] * scale,
                                       err_msg=f"{what} {t}")
        assert set(mt) == set(mj)
        for k in ("active_frac", "byz_frac", "fault_frac"):
            assert float(mt[k]) == float(mj[k]), (k, t)
        # carry on from the reference's state where NaN stopped the round
        dt = _t(dj.copy())
    return nan_rounds


@pytest.mark.parametrize("scheme,kind,aggregator,clip", ROUND_CASES)
def test_round_masked_robust_matches_reference(scheme, kind, aggregator,
                                               clip):
    nan_rounds = _check_rounds(_round_cfg(scheme, kind, aggregator, clip))
    if kind in ("nan", "inf") and aggregator == "mean":
        assert nan_rounds > 0       # the poison reaches the MAC


def test_round_masked_robust_with_a_mask():
    """Padded devices: a fault or a Byzantine draw on a device that does not
    exist counts for nothing and its state does not move."""
    mask = np.asarray([1, 1, 0, 1], np.float32)
    for scheme, agg in (("a_dsgd", "mean"), ("d_dsgd", "norm_cap")):
        _check_rounds(_round_cfg(scheme, "stale", agg, scheme == "a_dsgd"),
                      mask=mask)


@pytest.mark.parametrize("scheme", ["a_dsgd", "d_dsgd"])
def test_robust_zero_rates_is_bitwise_the_plain_round(scheme):
    """``robust=True`` at zero rates, no defence: ``round_masked`` with an
    all-ones mask is ``round_simulated`` bit for bit (ghat, error state)."""
    from repro_torch.core import schemes as tsc
    from repro_torch.experiments import engine as teng
    cfg = _port_cfg(_round_cfg(scheme, "nan", "mean", False,
                               byzantine_frac=0.0, fault_rate=0.0,
                               erasure_prob=0.0))
    st = tsc.get_scheme(cfg, D, M_DEV, device="cpu")
    assert st.robust_on
    rs = np.random.default_rng(3)
    grads = _t(rs.standard_normal((M_DEV, D)).astype(np.float32))
    deltas = _t(0.1 * rs.standard_normal((M_DEV, D)).astype(np.float32))
    for t in range(3):
        key = rng.PRNGKey(1000 + t)
        gm, dm, mm = teng.round_masked(st, grads, deltas, t, key,
                                       torch.ones(M_DEV), tsc.MACContext(
                                           m=M_DEV))
        gs, ds, _ = tsc.round_simulated(st, grads, deltas, t, key,
                                        tsc.MACContext(m=M_DEV))
        _same_bits(gm, gs)
        _same_bits(dm, ds)
        assert float(mm["byz_frac"]) == float(mm["fault_frac"]) == 0.0


def test_mac_hook_still_raises():
    """The ``mac`` hook is ported: it replaces the flat MAC sum after the
    frame faults, so the poisoned frames reach it.  (The name dates from
    when the hook raised.)"""
    from repro_torch.core import schemes as tsc
    from repro_torch.experiments import engine as teng
    st = tsc.get_scheme(_port_cfg(_round_cfg("a_dsgd", "nan", "mean",
                                             False)), D, M_DEV, device="cpu")
    seen = []

    def mac(frames, mac_key, sigma2):
        seen.append(torch.isnan(frames).any(dim=-1))
        return frames.sum(dim=-2)
    teng.round_masked(st, torch.ones(M_DEV, D), torch.zeros(M_DEV, D), 0,
                      rng.PRNGKey(0), torch.ones(M_DEV),
                      tsc.MACContext(m=M_DEV), mac=mac)
    fault = st.fault_draw(rng.fold_in(rng.PRNGKey(0), tfl.SALT_FAULT), 0,
                          M_DEV)
    assert torch.equal(seen[0], fault.poison)