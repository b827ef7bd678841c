"""The channel axes, repro_torch against repro: fading processes, CSI models,
the disk geometry and the subband schedulers.

The reference runs its channel functions inside ``jit`` (``run_compiled``,
``run_sweep``), where XLA's CPU backend fuses ``a*b + c`` into one fused
multiply-add, divides by a constant as the product with its float32
reciprocal and sums in its own order; each port function is held against
``jax.jit`` of its reference with every scalar traced, bitwise where the
function is elementwise.  Runs use the golden parity cases at M = 4
(``tests/golden/parity_cases.py``) against the live reference; their
rounds and runs against the reference on each projector are in
``tests/test_torch_channel_dense.py`` and ``test_torch_channel_blocked.py``.
"""
import dataclasses
import os
import sys
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import OTAConfig as JaxOTAConfig
from repro.core import channel as jch
from repro.core import fading as jfad
from repro.core import geometry as jgeo
from repro.core import scheduling as jsch
from repro.experiments import engine as jeng
from repro_torch import rng
from repro_torch.configs.base import OTAConfig
from repro_torch.core import channel as tch
from repro_torch.core import fading as tfad
from repro_torch.core import geometry as tgeo
from repro_torch.core import scheduling as tsch
from repro_torch.experiments import SCALAR_VMAP_AXES, run_sweep
from repro_torch.train import paper_repro as tpr
from repro_torch.train.checkpoint import load_checkpoint

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tests.golden.parity_cases import PARITY_CASES  # noqa: E402
from tests.torch_channel_cases import (  # noqa: E402
    CPU, EVERY, M, case as _case, compiled, make_data, one_torch_thread,
    port as _port,
)

#: rounds of the runs below (the parity cases' files run ten)
STEPS = 6


def _compiled(data, cfg, **kw):
    return compiled(data, cfg, steps=STEPS, **kw)


def _bits(x):
    x = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _same_bits(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _f32(v):
    return torch.tensor(np.float32(v))


# ---------------------------------------------------------------------------
# the XLA-exact helpers of rng.py
# ---------------------------------------------------------------------------


def _rne_f32(fr: Fraction) -> np.float32:
    """The float32 nearest the exact ``fr``, ties to even."""
    f = np.float32(float(fr))
    lo = f if Fraction(float(f)) <= fr else np.nextafter(f, np.float32(-1e38))
    hi = np.nextafter(lo, np.float32(1e38))
    if Fraction(float(lo)) == fr:
        return lo
    dl, dh = fr - Fraction(float(lo)), Fraction(float(hi)) - fr
    if dl != dh:
        return lo if dl < dh else hi
    return lo if int(lo.view(np.int32)) % 2 == 0 else hi


def test_fma_f32_rounds_once_on_constructed_ties():
    """``a*b`` half an ulp of ``c`` off by 2**-47 relative: the float64 sum
    lands on a float32 midpoint that the exact sum misses.  Held against
    exact rational arithmetic, and against XLA's fused ``a*b + c``."""
    rs = np.random.default_rng(3)
    n = 400
    c = (rs.integers(1 << 23, 1 << 24, n) * 2.0 ** rs.integers(-30, 30, n)
         * 2.0 ** -23).astype(np.float32)
    c *= np.where(rs.random(n) < 0.5, -1, 1).astype(np.float32)
    ulp = np.abs(np.nextafter(c, np.float32(np.inf)) - c).astype(np.float64)
    a = (np.where(rs.random(n) < 0.5, -1.0, 1.0) * ulp / 2
         * (1 + 2.0 ** -23)).astype(np.float32)
    b = np.where(rs.random(n) < 0.5, 1 - 2.0 ** -23,
                 1 + 2.0 ** -23).astype(np.float32)
    exact = np.array([_rne_f32(Fraction(float(x)) * Fraction(float(y))
                               + Fraction(float(z)))
                      for x, y, z in zip(a, b, c)], np.float32)
    got = rng.fma_f32(_t(a), _t(b), _t(c))
    _same_bits(got, exact)
    _same_bits(got, jax.jit(lambda x, y, z: x * y + z)(a, b, c))
    # the float64 sum rounded again misses a third of them
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (_bits(twice) != _bits(exact)).sum() > n // 5


def test_fma_f32_bitwise_with_xla_on_a_million_inputs():
    x = np.random.default_rng(4).standard_normal((3, 1_000_000)).astype(
        np.float32)
    _same_bits(rng.fma_f32(*map(_t, x)),
               jax.jit(lambda a, b, c: a * b + c)(*x))


def test_exp_f32_bitwise_with_xla():
    rs = np.random.default_rng(0)
    x = np.concatenate([
        rs.uniform(-20, 5, 1_000_000), rs.uniform(-90, 90, 200_000),
        [0.0, -0.0, np.inf, -np.inf, 88.8, -87.8, 88.72, 89.0, -87.5,
         -103.0]]).astype(np.float32)
    got = rng.exp_f32(_t(x))
    _same_bits(got, jnp.exp(x))
    _same_bits(got, jax.jit(jnp.exp)(x))
    assert torch.isnan(rng.exp_f32(torch.tensor([np.nan]))).all()


def test_pow_f32_bitwise_with_xla():
    """Elementwise pairs, and the Gauss-Markov weights ``rho ** arange(W)``
    one rho at a time, as the reference's channel draw computes them."""
    rs = np.random.default_rng(1)
    x = (np.abs(rs.standard_normal(1_000_000)) * 3).astype(np.float32)
    y = (rs.standard_normal(1_000_000) * 5).astype(np.float32)
    _same_bits(rng.pow_f32(_t(x), _t(y)), jax.jit(jnp.power)(x, y))
    sx = np.array([0, -0.0, 1, -1, -2, 0.5, 3], np.float32)
    sy = np.array([0, 1, 2, 3, -1, -3, 0.5, 200, -200], np.float32)
    xx, yy = (a.ravel() for a in np.meshgrid(sx, sy))
    want = np.asarray(jax.jit(jnp.power)(xx, yy))
    got = rng.pow_f32(_t(xx), _t(yy)).numpy()
    same = (_bits(got) == _bits(want)) | (np.isnan(got) & np.isnan(want))
    assert same.all(), list(zip(xx[~same], yy[~same]))
    idx = jnp.arange(64, dtype=jnp.float32)
    per_rho = jax.jit(lambda r: r ** idx)
    rhos = np.concatenate([rs.uniform(-1, 1, 150), rs.uniform(0.9, 1, 50),
                           [0.95, 0.76891184, 0.21075504]]).astype(np.float32)
    want = np.stack([np.asarray(per_rho(jnp.float32(r))) for r in rhos])
    _same_bits(rng.pow_f32(_t(rhos)[:, None], torch.arange(64.0)), want)


def test_fold_in_takes_a_tensor_of_salts():
    key = rng.PRNGKey(17)
    salts = torch.tensor([[0, 5, 2**20 + 3], [7, 2**32 - 1, 1]])
    got = rng.fold_in(key, salts)
    want = jax.vmap(jax.vmap(lambda s: jax.random.fold_in(
        jax.random.PRNGKey(17), s)))(jnp.asarray(salts.numpy(), jnp.uint32))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))
    stack = rng.split(key, 3)                              # keys (3, 2)
    assert rng.fold_in(stack, salts[0]).shape == (3, 3, 2)
    for i in range(3):
        for j in range(3):
            assert torch.equal(rng.fold_in(stack, salts[0])[i, j],
                               rng.fold_in(stack[i], int(salts[0, j])))


def test_normal_scaled_folds_the_constant_as_jit_does():
    key = jax.random.PRNGKey(9)
    want = jax.jit(lambda k: jax.random.normal(k, (2, 5000)) / jnp.sqrt(2.0))(
        key)
    got = rng.normal_scaled(rng.PRNGKey(9), (2, 5000),
                            float(np.float32(1) / np.sqrt(np.float32(2))))
    _same_bits(got, want)


# ---------------------------------------------------------------------------
# fading.py, channel.py's fading helpers, geometry.py, scheduling.py
# ---------------------------------------------------------------------------


def _normals(n, seed):
    rs = np.random.default_rng(seed)
    return (rs.standard_normal(n).astype(np.float32),
            rs.standard_normal(n).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_complex_normals_magnitude_and_rayleigh_bitwise(seed):
    key, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    want = jax.jit(jfad.complex_normals, static_argnums=1)(key, 1000)
    got = tfad.complex_normals(kt, 1000)
    _same_bits(got[0], want[0])
    _same_bits(got[1], want[1])
    re, im = _normals(200_000, seed)
    _same_bits(tfad.magnitude(_t(re), _t(im)), jax.jit(jfad.magnitude)(re, im))
    _same_bits(tch.rayleigh_gains(kt, 1000),
               jax.jit(jch.rayleigh_gains, static_argnums=1)(key, 1000))
    h = np.asarray(want[0]) ** 2 + 0.5
    for thr in (0.3, 0.9):
        pj, aj = jax.jit(jch.truncated_inversion_power)(h, jnp.float32(thr))
        pt, at = tch.truncated_inversion_power(_t(h), _f32(thr))
        _same_bits(pt, pj)
        np.testing.assert_array_equal(at.numpy(), np.asarray(aj))


@pytest.mark.parametrize("process", ["static", "iid", "gauss_markov"])
@pytest.mark.parametrize("window", [16, 32, 64])
def test_process_gains_bitwise(process, window):
    spec = jfad.FadingSpec(process=process, window=window)
    tspec = tfad.FadingSpec(process=process, window=window)
    fk, fkt = jfad.fading_base_key(3), tfad.fading_base_key(3)
    fn = jax.jit(lambda rk, r, s: jfad.process_gains(spec, fk, rk, s, 25,
                                                     rho=r))
    for step, rho in ((0, 0.95), (7, 0.5), (12, 0.99)):
        rk = jax.random.fold_in(jax.random.PRNGKey(1000 + step), 2)
        want = fn(rk, jnp.float32(rho), jnp.int32(step))
        got = tfad.process_gains(tspec, fkt,
                                 rng.fold_in(rng.PRNGKey(1000 + step), 2),
                                 step, 25, rho=_f32(rho))
        _same_bits(got[0], want[0])
        _same_bits(got[1], want[1])


@pytest.mark.parametrize("window", [8, 32, 64, 128])
def test_gauss_markov_weights_bitwise(window):
    """Both of XLA's forms: an unrolled window of up to 32 (``rho**2`` as
    ``rho * rho``, the squares fused into the sum) and longer ones summed
    in windows of 32."""
    def weights(r):
        c = r ** jnp.arange(window, dtype=jnp.float32)
        return c / jnp.sqrt(jnp.sum(c * c))
    fn = jax.jit(weights)
    rhos = np.concatenate([[0.95, 0.5, 0.9, 0.3, 0.99, 0.7777, -0.6],
                           np.random.default_rng(window).uniform(0.3, 1, 60)])
    for rho in rhos.astype(np.float32):
        _same_bits(tfad.gauss_markov_weights(_f32(rho), window),
                   fn(jnp.float32(rho)))


@pytest.mark.parametrize("err_var", [0.0, 0.1, 0.4])
def test_csi_estimate_and_misalignment_bitwise(err_var):
    re, im = _normals(2000, 5)
    key = jax.random.PRNGKey(5)
    ej, fj = jax.jit(jfad.csi_estimate)(re, im, key, jnp.float32(err_var))
    et, ft = tfad.csi_estimate(_t(re), _t(im), rng.PRNGKey(5), _f32(err_var))
    _same_bits(et, ej)
    _same_bits(ft, fj)
    gj = jax.jit(jfad.misalignment_gain)(re, im, ej, fj, jnp.float32(err_var))
    gt = tfad.misalignment_gain(_t(re), _t(im), et, ft, _f32(err_var))
    _same_bits(gt, gj)
    if err_var == 0.0:
        _same_bits(et, re)
        assert (gt == 1.0).all()


@pytest.mark.parametrize("m,k", [(4, 2), (25, 2), (25, 16), (25, 32),
                                 (40, 5), (100, 33)])
def test_blind_combiner_stats(m, k):
    """Sums and two products.  The gain is bitwise up to 32 devices (XLA's
    GEMV order, its sequential sum over the devices); above that XLA sums
    the devices in another order, and the gain stays within 4 ulp of its
    scale.  The noise scale sums the antennas in XLA's vectorised order,
    which the port does not follow: within 1e-6 relative."""
    rs = np.random.default_rng(m * 100 + k)
    re = rs.standard_normal((m, k)).astype(np.float32)
    im = rs.standard_normal((m, k)).astype(np.float32)
    gj, nj = jax.jit(jfad.blind_combiner_stats)(re, im)
    gt, nt = tfad.blind_combiner_stats(_t(re), _t(im))
    if m <= 32:
        _same_bits(gt, gj)
    scale = float(np.abs(np.asarray(gj)).max())
    np.testing.assert_allclose(gt.numpy(), gj, rtol=0,
                               atol=4 * np.spacing(np.float32(scale)))
    np.testing.assert_allclose(nt.numpy(), nj, rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_geometry_bitwise(seed):
    spec, tspec = jgeo.GeometrySpec(), tgeo.GeometrySpec()
    key, kt = jgeo.geometry_base_key(seed), tgeo.geometry_base_key(seed)
    pj = jax.jit(jgeo.unit_positions, static_argnums=1)(key, 500)
    pt = tgeo.unit_positions(kt, 500)
    _same_bits(pt[0], pj[0])
    _same_bits(pt[1], pj[1])
    for radius, gamma in ((800.0, 3.0), (100.0, 2.0), (1600.0, 3.7)):
        dj = jax.jit(lambda r: jgeo.device_distances(key, 500, r, spec))(
            jnp.float32(radius))
        _same_bits(tgeo.device_distances(kt, 500, _f32(radius), tspec), dj)
        gj = jax.jit(lambda r, g: jgeo.large_scale_gains(key, 500, r, g,
                                                         spec))(
            jnp.float32(radius), jnp.float32(gamma))
        gt = tgeo.large_scale_gains(kt, 500, _f32(radius), _f32(gamma),
                                    tspec)
        _same_bits(gt, gj)


def test_link_budget_diagnostics():
    spec, tspec = jgeo.GeometrySpec(), tgeo.GeometrySpec()
    d = np.linspace(1, 5000, 1000).astype(np.float32)
    np.testing.assert_allclose(
        tgeo.fspl_db(_t(d), 915e6).numpy(),
        jax.jit(lambda x: jgeo.fspl_db(x, 915e6))(d), rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        tgeo.link_budget_db(_t(d), _f32(3.0), tspec).numpy(),
        jax.jit(lambda x, g: jgeo.link_budget_db(x, g, spec))(
            d, jnp.float32(3.0)), rtol=0, atol=1e-4)
    cfg = OTAConfig(geometry="disk", geo_ref_dist=50.0, bs_height=12.5)
    assert tgeo.spec_from_cfg(cfg) == tgeo.GeometrySpec(
        **dataclasses.asdict(jgeo.spec_from_cfg(
            JaxOTAConfig(**dataclasses.asdict(cfg)))))
    with pytest.raises(ValueError):
        tgeo.spec_from_cfg(OTAConfig(geometry="hex"))


@pytest.mark.parametrize("name", ["round_robin", "gain_ranked", "prop_fair"])
def test_schedule_bitwise(name):
    """Eight rounds with a masked device and tied gains: the transmit set
    equal, prop_fair's carried state bitwise."""
    sj = jsch.get_scheduler(JaxOTAConfig(scheduler=name, n_subbands=3))
    st = tsch.get_scheduler(OTAConfig(scheduler=name, n_subbands=3))
    state_j, state_t = sj.init_state(10), st.init_state(10)
    rs = np.random.default_rng(11)
    mask = np.ones(10, bool)
    mask[7] = False
    for t in range(8):
        gains = rs.exponential(size=10).astype(np.float32)
        gains[3] = gains[4]
        n_sub = 3.0 if t < 5 else 2.5

        def ref(g, s, ns, mk):
            return jsch.schedule(sj, jax.random.PRNGKey(0), t, g, ns,
                                 state=s, mask=mk)
        got, new_t = tsch.schedule(st, rng.PRNGKey(0), t, _t(gains),
                                   _f32(n_sub), state=state_t,
                                   mask=_t(mask))
        want, new_j = jax.jit(ref)(gains, state_j, jnp.float32(n_sub), mask)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert not got.numpy()[7]
        if sj.has_state:
            _same_bits(new_t, new_j)
            state_j, state_t = new_j, new_t


def test_get_scheduler_and_floor_mod():
    assert tsch.get_scheduler(OTAConfig()) is None
    assert set(tsch.registered_schedulers()) == set(
        jsch.registered_schedulers())
    with pytest.raises(KeyError):
        tsch.get_scheduler(OTAConfig(scheduler="fifo"))
    with pytest.raises(ValueError):
        tsch.get_scheduler(OTAConfig(scheduler="round_robin", n_subbands=0))
    x = np.array([-7.5, -3.0, 0.0, 2.5, 11.0, -0.0], np.float32)
    for m in (4.0, 25.0):
        _same_bits(tsch._floor_mod(_t(x), m), jnp.mod(x, jnp.float32(m)))


# ---------------------------------------------------------------------------
# csi_err_var = 0 against Rayleigh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data():
    return make_data()


@pytest.mark.parametrize("projection", ["dense", "blocked"])
def test_csi_err_zero_is_fading_bitwise(data, projection):
    """At ``csi_err_var = 0`` the estimate is ``h`` bit for bit, so the run
    is ``a_dsgd_fading``'s with the same threshold (the reference's pin);
    only the misalignment metric is added, and it is exactly 1."""
    zero = _compiled(data, _case("a_dsgd_csi_err0", projection))
    fad = _compiled(data, _case("a_dsgd_rayleigh", projection))
    assert zero.accs == fad.accs
    assert zero.losses == fad.losses
    for mz, mf in zip(zero.metrics, fad.metrics):
        assert mz.pop("chan_gain") == 1.0
        assert mz == mf
    for k in fad.params:
        assert torch.equal(zero.params[k], fad.params[k])


# ---------------------------------------------------------------------------
# the schedulers through run_compiled, and a resumed prop_fair run
# ---------------------------------------------------------------------------


def _scheduled(name, **kw):
    base = dataclasses.replace(
        PARITY_CASES["a_dsgd_geometry"], scheduler=name, n_subbands=2,
        cell_radius=800.0)
    return dataclasses.replace(base, **kw)


@pytest.mark.parametrize("name", ["round_robin", "gain_ranked", "prop_fair"])
def test_schedulers_through_run_compiled(data, name):
    """Each scheduler on Rayleigh fading and the disk geometry: test losses
    within 1e-5 of the JAX engine's, the transmit fraction equal; the
    looped driver refuses a scheduler, as the reference's does."""
    cfg = _scheduled(name)
    got = _compiled(data, cfg)
    want = jeng.run_compiled(*data, cfg, steps=STEPS, lr=1e-3,
                             eval_every=EVERY)
    np.testing.assert_allclose(got.all_losses, want.all_losses, rtol=0,
                               atol=1e-5)
    for mg, mw in zip(got.metrics, want.metrics):
        assert mg["active_frac"] == pytest.approx(mw["active_frac"])
        assert mg["active_frac"] <= 2 / M
    with pytest.raises(ValueError, match="schedul"):
        tpr.run_federated(*data, _port(cfg), steps=1, **CPU)


def _npz_layout(path):
    with np.load(path) as f:
        return {k: (f[k].dtype.str, f[k].shape) for k in f.files}


def test_prop_fair_resume_is_bitwise(data, tmp_path):
    """A prop_fair run stopped at a checkpoint and resumed equals the run
    without a stop bitwise, its scheduler state carried through the file,
    whose keys, dtypes and shapes are the JAX engine's."""
    cfg = _scheduled("prop_fair")
    full = _compiled(data, cfg)
    kw = dict(checkpoint_dir=str(tmp_path / "t"), checkpoint_every=2)
    assert _compiled(data, cfg, stop_after_step=3, **kw) is None
    path = tmp_path / "t" / "engine_ckpt.npz"
    loaded, step = load_checkpoint(str(path), "cpu")
    assert step == 4 and len(loaded["carry"]) == 5
    assert loaded["carry"][4].shape == (M,) and (loaded["carry"][4] > 0).any()
    jeng.run_compiled(*data, cfg, steps=STEPS, eval_every=EVERY,
                      checkpoint_dir=str(tmp_path / "j"), checkpoint_every=2,
                      stop_after_step=3)
    assert _npz_layout(path) == _npz_layout(tmp_path / "j" /
                                            "engine_ckpt.npz")
    resumed = _compiled(data, cfg, resume=True, **kw)
    assert resumed.accs == full.accs
    assert resumed.losses == full.losses
    assert resumed.metrics == full.metrics
    for k in full.params:
        assert torch.equal(resumed.params[k], full.params[k])


# ---------------------------------------------------------------------------
# a grid over each channel scalar equals its points' own runs
# ---------------------------------------------------------------------------

#: each scalar axis on the configuration it acts on, with three values
SCALAR_GRIDS = {
    "csi_err_var": (_case("a_dsgd_csi_err", "blocked"), [0.0, 0.1, 0.4]),
    "fading_threshold": (_case("a_dsgd_rayleigh", "dense"), [0.3, 0.6, 0.9]),
    "fading_rho": (_case("a_dsgd_gauss_markov", "blocked"),
                   [0.5, 0.9, 0.95]),
    "cell_radius": (_case("a_dsgd_geometry", "blocked"),
                    [100.0, 400.0, 1600.0]),
    "path_loss_exp": (_case("a_dsgd_geometry", "dense"), [2.0, 3.0, 3.7]),
    "n_subbands": (_scheduled("gain_ranked"), [1.0, 2.0, 3.0]),
}


@pytest.mark.parametrize("axis", SCALAR_VMAP_AXES)
def test_scalar_axis_grid_matches_its_points(data, axis):
    """``run_sweep`` batches the axis as a ``(G,)`` override in one round
    per step; every record equals its own ``run_compiled`` entry for
    entry, and the points differ."""
    cfg, values = SCALAR_GRIDS[axis]
    xd, yd, xt, yt = data
    res = run_sweep((xd, yd), (xt, yt), _port(cfg), {axis: values},
                    steps=STEPS, eval_every=EVERY, **CPU)
    assert [r[axis] for r in res.records] == values
    for rec, v in zip(res.records, values):
        one = _compiled(data, dataclasses.replace(cfg, **{axis: v}))
        assert rec["accs"] == one.accs
        assert rec["losses"] == one.losses
        assert rec["metrics"] == one.metrics
    assert len({tuple(r["losses"]) for r in res.records}) > 1
