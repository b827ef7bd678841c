"""repro_torch.core (compression, channel, projection, AMP) against repro.core."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import amp as jamp
from repro.core import channel as jch
from repro.core import compression as jcomp
from repro.core import projection as jproj
from repro_torch import rng
from repro_torch.core import amp as tamp
from repro_torch.core import channel as tch
from repro_torch.core import compression as tcomp
from repro_torch.core import projection as tproj

AMP_TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_amp_fused.py:86


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

# 2003 rows: 7 (d, k) groups of 285 rows below the 65536-sample bound, and
# 8 rows at d = 70000, which exercise the strided sample
_THRESHOLD_GROUPS = [(64, 3), (97, 50), (256, 64), (999, 10), (1500, 700),
                     (2048, 2047), (3000, 1), (70000, 5000)]


@pytest.mark.parametrize("d,k", _THRESHOLD_GROUPS)
def test_sampled_topk_threshold_bitwise(d, k):
    rs = np.random.default_rng(d + k)
    rows = 285 if d < 10000 else 8
    v = (rs.standard_normal((rows, d))
         * rs.uniform(0.01, 10, (rows, 1))).astype(np.float32)
    key = jax.random.PRNGKey(0)
    tau_j = np.asarray(jax.vmap(
        lambda r: jcomp.sampled_topk_threshold(r, k, key))(jnp.asarray(v)))
    tau_t = tcomp.sampled_topk_threshold(_t(v), k).numpy()
    np.testing.assert_array_equal(tau_t, tau_j)
    np.testing.assert_array_equal(np.abs(v) >= tau_t[:, None],
                                  np.abs(v) >= tau_j[:, None])


def test_top_k_sparsify_bitwise():
    rs = np.random.default_rng(3)
    v = rs.standard_normal((4, 500)).astype(np.float32)
    v[0, :10] = 1.5                                  # ties at the cut
    sj = np.asarray(jax.vmap(lambda r: jcomp.top_k_sparsify(r, 37))(v))
    np.testing.assert_array_equal(tcomp.top_k_sparsify(_t(v), 37).numpy(), sj)


# ---------------------------------------------------------------------------
# channel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_mr", [True, False])
def test_frame_mac_and_normalize(use_mr):
    rs = np.random.default_rng(4)
    g = rs.standard_normal((4, 130)).astype(np.float32)
    p_t = np.float32([500.0, 250.0, 500.0, 125.0])
    fj, aj = jax.vmap(lambda r, p: jch.make_frame(r, p, use_mr))(
        jnp.asarray(g), jnp.asarray(p_t))
    ft, at = tch.make_frame(_t(g), _t(p_t), use_mr)
    # mean(g) sums in another order than XLA; g - mu cancels near mu, so
    # an absolute floor of a few float32 ulp of the frame's scale
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-6)
    np.testing.assert_allclose(tch.frame_power(ft).numpy(), p_t, rtol=1e-5)

    key_j = jax.random.fold_in(jax.random.PRNGKey(11), 0)
    key_t = rng.fold_in(rng.PRNGKey(11), 0)
    yj = jch.mac_sum(fj, key_j, 1.0)
    yt = tch.mac_sum(ft, key_t, 1.0)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tch.ps_normalize(yt, use_mr).numpy(),
                               np.asarray(jch.ps_normalize(yj, use_mr)),
                               rtol=1e-6, atol=1e-6)


def test_ps_normalize_floor():
    y = torch.tensor([1.0, 2.0, 0.5, 1e-4])
    np.testing.assert_array_equal(
        tch.ps_normalize(y, True).numpy(),
        np.asarray(jch.ps_normalize(jnp.asarray(y.numpy()), True)))


# ---------------------------------------------------------------------------
# projection + AMP
# ---------------------------------------------------------------------------


def test_dense_projector_matrix():
    pj = jproj.DenseProjector(d=300, s_tilde=148, seed=3)
    pt = tproj.DenseProjector(d=300, s_tilde=148, seed=3)
    # jax.random.normal within rng's measured ulp gap, then / sqrt(s)
    np.testing.assert_allclose(pt.matrix("cpu").numpy(), np.asarray(pj.matrix()),
                               rtol=1e-6, atol=1e-7)


def test_dense_matrix_defaults_to_the_card(monkeypatch):
    """``matrix("cpu")`` builds on the CPU and divides truly (the same bits
    as ``normal / sqrt(s_tilde)`` there); ``None`` is the card, as at every
    entry point, and raises where there is none."""
    pt = tproj.DenseProjector(d=50, s_tilde=148, seed=3)
    want = rng.normal(rng.PRNGKey(3, device="cpu"), (148, 50)) / float(
        np.sqrt(np.float32(148)))
    assert torch.equal(pt.matrix("cpu"), want)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tproj.DenseProjector(d=50, s_tilde=148, seed=3).matrix()


def _block_sparse(d, c, per_block, seed):
    rs = np.random.default_rng(seed)
    x = np.zeros(d, np.float32)
    for b in range(d // c):
        idx = rs.choice(c, per_block, replace=False)
        x[b * c + idx] = rs.standard_normal(per_block)
    return x


def test_amp_decode_dense():
    d, s = 400, 160
    pj = jproj.DenseProjector(d=d, s_tilde=s, seed=1)
    pt = tproj.DenseProjector(d=d, s_tilde=s, seed=1)
    x = _block_sparse(d, d, 20, 0)
    y = np.asarray(pj.project(jnp.asarray(x)))
    xj = np.asarray(jamp.amp_decode_dense(jnp.asarray(y), pj.matrix(), 15))
    xt = tamp.amp_decode_dense(_t(y), pt.matrix("cpu"), 15).numpy()
    np.testing.assert_allclose(xt, xj, **AMP_TOL)
    assert np.linalg.norm(xt - x) / np.linalg.norm(x) < 0.2


@pytest.mark.parametrize("rademacher", [True, False])
def test_amp_decode_blocked(rademacher):
    d, c, sb = 1024, 128, 64
    kw = dict(d=d, block_size=c, s_block=sb, seed=2, rademacher=rademacher)
    pj, pt = jproj.BlockedProjector(**kw), tproj.BlockedProjector(**kw)
    x = _block_sparse(d, c, sb // 4, 1)
    y = np.asarray(pj.project(jnp.asarray(x)))
    np.testing.assert_allclose(pt.project(_t(x)).numpy(), y, rtol=3e-5,
                               atol=3e-5)
    yb = y.reshape(pj.n_blocks, sb)
    xj = np.asarray(jamp.amp_decode_blocked(jnp.asarray(yb), pj, iters=8))
    xt = tamp.amp_decode_blocked(_t(yb), pt, iters=8).numpy()
    np.testing.assert_allclose(xt, xj, **AMP_TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_amp_blocked_core(use_kernel):
    """The chunked decode against the reference's chunked scan
    (use_kernel=False) and its fused Pallas kernel in interpret mode
    (use_kernel=True); the port's CPU tensors take the plain version."""
    d, c, sb = 4096, 256, 128
    pj = jproj.BlockedProjector(d=d, block_size=c, s_block=sb, seed=5,
                                rademacher=True)
    x = _block_sparse(d, c, sb // 4, 2)
    yb = np.asarray(pj.project(jnp.asarray(x))).reshape(pj.n_blocks, sb)
    xj = np.asarray(jamp.amp_blocked_core(jnp.asarray(yb), 5, c, iters=20,
                                          chunk_blocks=4,
                                          use_kernel=use_kernel))
    xt = tamp.amp_blocked_core(_t(yb), 5, c, iters=20, chunk_blocks=4,
                               use_kernel=use_kernel).numpy()
    np.testing.assert_allclose(xt, xj, **AMP_TOL)
    assert np.linalg.norm(xt.reshape(-1) - x) / np.linalg.norm(x) < 0.1


def test_amp_blocked_core_id_offset_subrange_bitwise():
    d, c, sb = 2048, 128, 64
    pt = tproj.BlockedProjector(d=d, block_size=c, s_block=sb, seed=9)
    yb = pt.project(_t(_block_sparse(d, c, sb // 4, 3))).reshape(-1, sb)
    full = tamp.amp_blocked_core(yb, 9, c, iters=10, chunk_blocks=4)
    half = pt.n_blocks // 2
    part = tamp.amp_blocked_core(yb[half:], 9, c, iters=10, chunk_blocks=4,
                                 id_offset=half)
    np.testing.assert_array_equal(part.numpy(), full[half:].numpy())


def test_amp_decode_dispatch_matches_reference_routes():
    """amp_decode takes the same route as the reference: fused for
    use_kernel, the chunked loop past chunk_blocks, else launch-per-op.

    Nine iterations, not the eight of ``tests/test_amp_fused.py``'s
    dispatch test: that test counts the reference's traces of its fused
    kernel, and a trace this test left in the same worker would hide one."""
    d, c, sb = 1024, 128, 64
    x = _block_sparse(d, c, sb // 4, 4)
    for uk in (False, True):
        kw = dict(d=d, block_size=c, s_block=sb, seed=2, rademacher=True,
                  use_kernel=uk)
        pj, pt = jproj.BlockedProjector(**kw), tproj.BlockedProjector(**kw)
        y = np.asarray(jproj.BlockedProjector(
            **{**kw, "use_kernel": False}).project(jnp.asarray(x)))
        xj = np.asarray(jamp.amp_decode(jnp.asarray(y), pj, iters=9))
        xt = tamp.amp_decode(_t(y), pt, iters=9).numpy()
        np.testing.assert_allclose(xt, xj, **AMP_TOL)


# ---------------------------------------------------------------------------
# the error feedback's two steps and the average-power check
# ---------------------------------------------------------------------------


def test_error_feedback_and_residual_bitwise():
    rs = np.random.default_rng(11)
    g, delta, g_sp = (rs.standard_normal((3, 4097)).astype(np.float32)
                      * s for s in (1.0, 0.3, 2.0))
    g_ec = jcomp.error_feedback(jnp.asarray(g), jnp.asarray(delta))
    got = tcomp.error_feedback(_t(g), _t(delta))
    np.testing.assert_array_equal(got.numpy(), np.asarray(g_ec))
    np.testing.assert_array_equal(
        tcomp.residual(got, _t(g_sp)).numpy(),
        np.asarray(jcomp.residual(g_ec, jnp.asarray(g_sp))))


@pytest.mark.parametrize("schedule", ["constant", "lh_stair", "lh_steps",
                                      "hl_steps"])
def test_verify_average_power_on_both_sides_of_the_tolerance(schedule):
    from repro.core import power as jpower
    from repro_torch.core import power as tpower
    ps = tpower.schedule_array(30, 200.0, schedule)
    mean = float(ps.mean())
    rs = np.random.default_rng(12)
    noisy = ps * (1.0 + 1e-3 * rs.standard_normal(ps.shape))
    cases = [(ps, 200.0, 1e-6), (noisy, 200.0, 1e-6), (ps, mean, 0.0),
             (ps, mean * (1 - 1e-7), 1e-6), (ps, mean * (1 - 2e-6), 1e-6),
             (ps, mean * 0.999, 1e-3), (ps, mean * 0.998, 1e-3)]
    outcomes = []
    for arr, p_avg, tol in cases:
        want = jpower.verify_average_power(arr, p_avg, tol)
        got = tpower.verify_average_power(arr, p_avg, tol)
        assert got == want and isinstance(got, bool), (p_avg, tol)
        outcomes.append(got)
    assert True in outcomes and False in outcomes, outcomes
