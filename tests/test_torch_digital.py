"""The digital baselines (D-DSGD, SignSGD, QSGD), repro_torch against repro.

The three compressors and the host bit accounting against
``repro.core.compression``; each digital scheme's round on the golden
parity inputs (the stored ``grads``, ``PRNGKey(11)``) against the
reference's ``round_simulated``; ``run_federated`` and ``run_compiled``
against the JAX engine at the sizes of ``tests/test_experiments.py``; and
the Dirichlet partition, bitwise.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import OTAConfig as JaxOTAConfig
from repro.core import compression as jc
from repro.core import schemes as js
from repro.data import partition as jpart
from repro.experiments import engine as jeng
from repro_torch import rng
from repro_torch.configs.base import OTAConfig
from repro_torch.core import compression as tc
from repro_torch.core import schemes as ts
from repro_torch.data import federated_split, make_classification
from repro_torch.data import partition as tpart
from repro_torch.experiments import engine
from repro_torch.train import paper_repro as tpr

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tests.golden.parity_cases import PARITY_CASES  # noqa: E402

DIGITAL = ("d_dsgd", "signsgd", "qsgd")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "simulated_parity.npz")
#: the per-round bar: the digital means and QSGD's norm sum
#: in another order than XLA's, an ulp apart
RTOL, ATOL = 1e-5, 1e-7


def _rows(n_rows, d, seed):
    rs = np.random.default_rng(seed)
    return rs.standard_normal((n_rows, d)).astype(np.float32)


# ---------------------------------------------------------------------------
# compressors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,q_max", [(256, 40), (1000, 7), (63, 63)])
@pytest.mark.parametrize("q_t", [0, 1, 5, 40])
def test_sbc_and_signsgd_match_reference(d, q_max, q_t):
    """Row by row against the reference's per-device functions; q_t is
    clipped to q_max as there.  SBC within an ulp (its means), signs
    bitwise."""
    v = _rows(5, d, d + q_t)
    q = jnp.asarray(q_t, jnp.int32)
    want_sbc = np.stack([np.asarray(jc.sbc_quantize(jnp.asarray(r), q,
                                                    q_max)) for r in v])
    want_sign = np.stack([np.asarray(jc.signsgd_compress(jnp.asarray(r), q,
                                                         q_max)) for r in v])
    qt = torch.tensor(q_t, dtype=torch.int32)
    got_sbc = tc.sbc_quantize(torch.from_numpy(v), qt, q_max).numpy()
    got_sign = tc.signsgd_compress(torch.from_numpy(v), qt, q_max).numpy()
    np.testing.assert_allclose(got_sbc, want_sbc, rtol=RTOL, atol=ATOL)
    assert (got_sbc != 0).tolist() == (want_sbc != 0).tolist()
    np.testing.assert_array_equal(got_sign, want_sign)


@pytest.mark.parametrize("d,q_max,q_t,bits", [(256, 40, 9, 2), (1000, 7, 7, 4),
                                              (63, 20, 0, 2)])
def test_qsgd_matches_reference(d, q_max, q_t, bits):
    """Per-row keys (the device keys of a round): the levels and support
    equal the reference's, the values within an ulp of the norm."""
    v = _rows(6, d, d + bits)
    keys_j = jax.random.split(jax.random.PRNGKey(d), 6)
    want = np.stack([np.asarray(jc.qsgd_compress(
        jnp.asarray(r), jnp.asarray(q_t, jnp.int32), q_max, bits, k))
        for r, k in zip(v, keys_j)])
    got = tc.qsgd_compress(torch.from_numpy(v),
                           torch.tensor(q_t, dtype=torch.int32), q_max, bits,
                           torch.from_numpy(np.asarray(keys_j)
                                            .astype(np.int64))).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got != 0).tolist() == (want != 0).tolist()


def test_compressors_take_a_budget_per_row():
    """A (G, M, d) batch with one q_t per point equals each point's call
    with its own scalar q_t, bitwise (the grid's digital rows)."""
    v = torch.from_numpy(_rows(12, 300, 3).reshape(3, 4, 300))
    q = torch.tensor([[2], [0], [17]], dtype=torch.int32)
    keys = rng.split(rng.PRNGKey(5), 12).reshape(3, 4, 2)
    for fn in (lambda x, qq, k: tc.sbc_quantize(x, qq, 20),
               lambda x, qq, k: tc.signsgd_compress(x, qq, 20),
               lambda x, qq, k: tc.qsgd_compress(x, qq, 20, 2, k)):
        batched = fn(v, q, keys)
        for g in range(3):
            assert torch.equal(batched[g], fn(v[g], q[g, 0], keys[g]))


# ---------------------------------------------------------------------------
# bit accounting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", DIGITAL)
@pytest.mark.parametrize("m", [10, 25, 50])
def test_q_schedules_equal_reference(scheme, m):
    """At the paper's d = 7850, s = d/2 and d/4 and the P-bar of Figs. 2-7:
    the q_t schedules are the reference's, entry for entry."""
    d = 7850
    p_ts = np.asarray([1.0, 20.0, 50.0, 200.0, 500.0, 1000.0, 5000.0])
    for s in (d // 2, d // 4):
        for l_q in (2, 4):
            want = jc.digital_q_schedule(d, s, m, p_ts, 1.0, scheme=scheme,
                                         l_q=l_q, q_cap=d // 2)
            got = tc.digital_q_schedule(d, s, m, p_ts, 1.0, scheme=scheme,
                                        l_q=l_q, q_cap=d // 2)
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)


def test_bit_costs_equal_reference():
    q = np.asarray([0.0, 1.0, 17.0, 3925.0, 7850.0])
    for fn in ("ddsgd_bits", "signsgd_bits"):
        np.testing.assert_array_equal(getattr(tc, fn)(7850, q),
                                      getattr(jc, fn)(7850, q))
    np.testing.assert_array_equal(tc.qsgd_bits(7850, q, 2),
                                  jc.qsgd_bits(7850, q, 2))
    np.testing.assert_array_equal(
        tc.mac_bit_budget(1962, 25, q, 1.0), jc.mac_bit_budget(1962, 25, q,
                                                               1.0))
    assert sorted(tc.BIT_COSTS) == sorted(jc.BIT_COSTS)
    with pytest.raises(ValueError, match="no bit-cost model"):
        tc.digital_q_schedule(10, 5, 2, np.ones(2), 1.0, scheme="a_dsgd")


# ---------------------------------------------------------------------------
# the schemes' round on the golden parity inputs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def golden_rounds():
    grads = np.load(GOLDEN)["grads"]
    m, d = grads.shape
    deltas = np.zeros_like(grads)
    out = {}
    for name in DIGITAL:
        cfg = PARITY_CASES[name]
        sj = js.get_scheme(cfg, d, m)
        st = ts.get_scheme(OTAConfig(**dataclasses.asdict(cfg)), d, m,
                           device="cpu")
        for step in (0, 5):
            gj, dj, mj = js.round_simulated(sj, grads, deltas, step,
                                            jax.random.PRNGKey(11))
            gt, dt, mt = ts.round_simulated(st, torch.from_numpy(grads),
                                            torch.from_numpy(deltas), step,
                                            rng.PRNGKey(11))
            out[name, step] = ((np.asarray(gj), np.asarray(dj),
                                {k: float(v) for k, v in mj.items()}),
                               (gt.numpy(), dt.numpy(),
                                {k: float(v) for k, v in mt.items()}))
    return out


@pytest.mark.parametrize("name", DIGITAL)
@pytest.mark.parametrize("step", [0, 5])
def test_round_ghat_and_deltas_on_parity_inputs(golden_rounds, name, step):
    (gj, dj, _), (gt, dt, _) = golden_rounds[name, step]
    np.testing.assert_allclose(gt, gj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dt, dj, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", DIGITAL)
def test_round_metrics_on_parity_inputs(golden_rounds, name):
    """q_t averages as jnp.mean of int32 does (float32), p_t and the
    active fraction as the reference's."""
    for step in (0, 5):
        (_, _, mj), (_, _, mt) = golden_rounds[name, step]
        assert set(mt) == set(mj) == {"q_t", "p_t", "active_frac"}
        for k in mj:
            np.testing.assert_allclose(mt[k], mj[k], rtol=1e-6)


@pytest.mark.parametrize("name", DIGITAL)
def test_scheme_shape_facts_match_reference(name):
    cfg = PARITY_CASES[name]
    for d, m in ((256, 6), (7850, 25)):
        sj = js.get_scheme(cfg, d, m)
        st = ts.get_scheme(OTAConfig(**dataclasses.asdict(cfg)), d, m,
                           device="cpu")
        assert st.channel_dim() == sj.channel_dim()
        assert st.q_max == sj.q_max
        np.testing.assert_array_equal(st.q_sched.numpy(),
                                      np.asarray(sj.q_sched))
    assert "d_dsgd" in ts.registered_schemes()


# ---------------------------------------------------------------------------
# whole runs against the JAX engine (tests/test_experiments.py's sizes)
# ---------------------------------------------------------------------------

STEPS, EVERY, M, B = 6, 2, 4, 64


@pytest.fixture(scope="module")
def data():
    (xtr, ytr), (xte, yte) = make_classification(
        n_train=800, n_test=300, dim=48, noise=2.0, seed=3)
    xd, yd = federated_split(xtr, ytr, m=M, b=B, iid=True, seed=0)
    return xd, yd, xte, yte


def _kw(name):
    return dict(scheme=name, s_frac=0.5, p_avg=500.0, total_steps=STEPS)


@pytest.mark.parametrize("name", DIGITAL)
def test_runs_match_jax_engine(data, name):
    """run_compiled == run_federated entry for entry; against the JAX
    engine accuracies equal, losses within 1e-5, metrics within 1e-5."""
    want = jeng.run_compiled(*data, JaxOTAConfig(**_kw(name)), steps=STEPS,
                             lr=1e-3, eval_every=EVERY)
    loop = tpr.run_federated(*data, OTAConfig(**_kw(name)), steps=STEPS,
                             lr=1e-3, eval_every=EVERY, device="cpu")
    got = engine.run_compiled(*data, OTAConfig(**_kw(name)), steps=STEPS,
                              lr=1e-3, eval_every=EVERY, device="cpu")
    assert got.accs == loop.accs and got.losses == loop.losses
    assert got.metrics == loop.metrics
    assert got.all_accs.tolist() == want.all_accs.tolist()
    np.testing.assert_allclose(got.all_losses, want.all_losses, rtol=0,
                               atol=1e-5)
    for mg, mw in zip(got.metrics, want.metrics):
        assert set(mg) == set(mw)
        for k in mw:
            np.testing.assert_allclose(mg[k], mw[k], rtol=1e-5)


@pytest.mark.parametrize("name", DIGITAL)
def test_masked_all_ones_is_round_simulated(data, name):
    """round_masked's digital branch at the all-ones mask is
    round_simulated, metrics included."""
    xd, yd, _, _ = data
    params = tpr.init_linear(xd.shape[-1], 10, "cpu")
    grads, _ = tpr.device_grads(params, torch.from_numpy(xd),
                                torch.from_numpy(yd).long(), None)
    deltas = 0.01 * torch.from_numpy(_rows(M, grads.shape[1], 9))
    scheme = ts.get_scheme(OTAConfig(**_kw(name)), grads.shape[1], M,
                           device="cpu")
    ctx = ts.MACContext(m=M)
    key = rng.PRNGKey(1003)
    g0, d0, m0 = ts.round_simulated(scheme, grads, deltas, 3, key, ctx)
    g1, d1, m1 = engine.round_masked(scheme, grads, deltas, 3, key,
                                     torch.ones(M), ctx)
    assert torch.equal(g0, g1) and torch.equal(d0, d1)
    assert {k: float(v) for k, v in m0.items()} == \
        {k: float(v) for k, v in m1.items()}


# ---------------------------------------------------------------------------
# the Dirichlet partition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("beta", [0.1, 0.5, 1.0, 100.0])
@pytest.mark.parametrize("seed", [0, 7])
def test_partition_dirichlet_bitwise(beta, seed):
    y = np.random.default_rng(1).integers(0, 10, 3000)
    want = jpart.partition_dirichlet(y, 20, 50, beta, seed=seed)
    got = tpart.partition_dirichlet(y, 20, 50, beta, seed=seed)
    np.testing.assert_array_equal(got, want)
    x = np.arange(3000 * 2, dtype=np.float32).reshape(3000, 2)
    xj, yj = jpart.make_partition(x, y, 20, 50, kind="dirichlet", beta=beta,
                                  seed=seed)
    xt, yt = tpart.make_partition(x, y, 20, 50, kind="dirichlet", beta=beta,
                                  seed=seed)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(yt, yj)
    with pytest.raises(ValueError, match="beta"):
        tpart.partition_dirichlet(y, 2, 5, 0.0)
