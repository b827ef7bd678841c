"""The sampled-cohort population engine, repro_torch against repro,
function by function: the Gumbel and exponential draws, the sampler, churn,
stragglers, the run-level population arrays, the banks' gather and scatter,
the arithmetic partitions, the edge-site MAC and the schemes' cohort draws.

Each function is held bitwise against the reference as the reference's
engine calls it: the per-round draws under ``jax.jit`` with every scalar
traced, the run-level arrays (``init_population``, drawn before the run)
eagerly, as ``CompiledPopulation`` draws them.  The rounds and runs are in
``tests/test_torch_population_engine.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import OTAConfig as JaxOTAConfig
from repro.core import schemes as jsch
from repro.data import partition as jpart
from repro.population import churn as jchurn
from repro.population import hierarchy as jhier
from repro.population import state as jstate
from repro.population import stragglers as jstrag
from repro.population.sampler import sample_cohort as jsample
from repro_torch import population as tpop
from repro_torch import rng
from repro_torch.configs.base import OTAConfig
from repro_torch.core import schemes as tsch
from repro_torch.data import partition as tpart
from repro_torch.data import make_classification
from repro_torch.population import churn, hierarchy, state, stragglers
from repro_torch.population.sampler import sample_cohort


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one intra-op thread (thousands of small ops, which a
    parallel run's busy cores slow with a pool of threads to wake)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _same(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if got.dtype == np.float32:
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.astype(np.float32).view(np.int32))
    else:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64))


def _key(seed):
    return jax.random.PRNGKey(seed), rng.PRNGKey(seed)


@pytest.mark.parametrize("n", [1, 33, 4096, 100_000])
def test_gumbel_and_exponential_bitwise(n):
    for seed in (0, 7):
        jk, tk = _key(seed)
        _same(rng.gumbel(tk, (n,)),
              jax.jit(lambda k: jax.random.gumbel(k, (n,)))(jk))
        _same(rng.exponential(tk, (n,)),
              jax.jit(lambda k: jax.random.exponential(k, (n,)))(jk))
    # a stack of keys draws each key's own
    keys = rng.split(rng.PRNGKey(3), 3)
    both = rng.gumbel(keys, (n,))
    for g in range(3):
        _same(both[g], rng.gumbel(keys[g], (n,)))


@pytest.mark.parametrize("m,k,up", [(50, 8, 50), (50, 50, 50), (40, 15, 10),
                                    (40, 5, 10), (12, 12, 0), (25, 25, 13)])
def test_sample_cohort_bitwise(m, k, up):
    """Cohort, membership and rank: bitwise the reference under jit, with
    fewer than K devices up too (scores tie at -inf; lower index first)."""
    rs = np.random.RandomState(m + k + up)
    avail = np.zeros(m, bool)
    avail[rs.choice(m, up, replace=False)] = True
    for seed in range(4):
        jk, tk = _key(seed)
        want = jax.jit(lambda kk, a: jsample(kk, a, k))(jk, avail)
        got = sample_cohort(tk, torch.from_numpy(avail), k)
        for a, b in zip(got, want):
            _same(a, b)
        assert int(got[1].sum()) == min(k, up)
        assert torch.all(got[0][1:] > got[0][:-1])
    with pytest.raises(ValueError):
        sample_cohort(rng.PRNGKey(0), torch.ones(4, dtype=torch.bool), 5)


def test_sample_cohort_points_each_their_own():
    keys = rng.split(rng.PRNGKey(9), 3)
    avail = torch.from_numpy(np.random.RandomState(0).rand(3, 30) < 0.5)
    got = sample_cohort(keys, avail, 6)
    for g in range(3):
        for a, b in zip(got, sample_cohort(keys[g], avail[g], 6)):
            assert torch.equal(a[g], b)


@pytest.mark.parametrize("spread,life", [(0.0, 0.0), (0.5, 20.0),
                                         (0.3, 0.0), (0.0, 4.5)])
def test_churn_bitwise(spread, life):
    jk, tk = _key(11)
    ja, jd = jchurn.init_arrival_departure(jk, 300, 40, spread, life)
    ta, td = churn.init_arrival_departure(tk, 300, 40, spread, life)
    _same(ta, ja)
    _same(td, jd)
    assert ta.dtype == td.dtype == torch.int32
    avail = jax.jit(lambda k, r, t: jchurn.availability(ja, jd, t, k, r))
    for t in (0, 5, 17, 10 ** 6):
        for rate in (1.0, 0.7, 0.0):
            want = avail(jk, jnp.float32(rate), jnp.int32(t))
            _same(churn.availability(ta, td, t, tk, rate), want)


def test_stragglers_bitwise():
    jk, tk = _key(5)
    for sigma in (0.0, 0.5, 1.3):
        _same(stragglers.init_speed(tk, 500, sigma),
              jstrag.init_speed(jk, 500, sigma))
    speed = stragglers.init_speed(tk, 64, 0.5)
    want = jax.jit(jstrag.latencies)(jk, jnp.asarray(speed.numpy()))
    lat = stragglers.latencies(tk, speed)
    _same(lat, want)
    for dl in (float("inf"), 5.0, 0.4):
        _same(stragglers.deadline_mask(lat, dl),
              jstrag.deadline_mask(jnp.asarray(lat.numpy()), dl))


POPS = {
    "default": dict(m_total=40, k_cohort=8),
    "everything": dict(m_total=300, k_cohort=16, capacity=64, bank_size=16,
                       arrival_spread=0.4, mean_lifetime=12.0,
                       avail_rate=0.8, speed_sigma=0.7,
                       straggler_deadline=3.0, shadowing_sigma_db=6.0,
                       n_sites=3, seed=4),
}


@pytest.mark.parametrize("name", list(POPS))
def test_init_population_bitwise(name):
    """The run-level arrays as CompiledPopulation draws them (eagerly):
    the shadowing gains ``10 ** (db / 10)`` through powf, the speeds, the
    churn trace, the sites, and cold banks of the right shape."""
    kw = POPS[name]
    want = jstate.init_population(jstate.PopulationConfig(**kw), 7, 20)
    got = state.init_population(state.PopulationConfig(**kw), 7, 20,
                                device="cpu")
    for f in ("gains", "speed", "arrival", "departure", "site"):
        _same(getattr(got, f), getattr(want, f))
    _same(got.banks.deltas, want.banks.deltas)
    _same(got.banks.owner, want.banks.owner)
    assert got.banks.owner.dtype == torch.int32
    pop = state.PopulationConfig(**kw)
    assert pop.state_capacity == jstate.PopulationConfig(**kw).state_capacity
    assert pop.n_banks == jstate.PopulationConfig(**kw).n_banks


def test_init_population_under_jit_is_a_few_ulps_away():
    """The reference's engine draws the run-level arrays eagerly, and the
    port is bitwise that (above).  Under ``jit`` XLA folds the constants
    (``sigma * normal`` into the draw, the division by 10 into a product)
    and rounds about a third of the gains and an eighth of the speeds
    differently, by up to 9 ulps (ROADMAP queue 3)."""
    kw = dict(m_total=20000, k_cohort=1, shadowing_sigma_db=6.0,
              speed_sigma=0.7)
    jitted = jax.jit(lambda: jstate.init_population(
        jstate.PopulationConfig(**kw), 1, 1))()
    got = state.init_population(state.PopulationConfig(**kw), 1, 1,
                                device="cpu")
    for f, share in (("gains", (0.25, 0.5)), ("speed", (0.05, 0.2))):
        a = _np(getattr(got, f)).view(np.int32).astype(np.int64)
        w = np.asarray(getattr(jitted, f)).view(np.int32).astype(np.int64)
        ulps = np.abs(a - w)
        assert ulps.max() <= 16, f
        assert share[0] < (ulps > 0).mean() < share[1], f


def test_population_config_errors_match_reference():
    for kw in (dict(m_total=4, k_cohort=5), dict(m_total=4, k_cohort=0),
               dict(m_total=4, k_cohort=2, capacity=-1),
               dict(m_total=4, k_cohort=2, bank_size=0),
               dict(m_total=4, k_cohort=2, n_sites=0)):
        with pytest.raises(ValueError):
            jstate.PopulationConfig(**kw)
        with pytest.raises(ValueError):
            state.PopulationConfig(**kw)
    assert state.NEVER == jstate.NEVER
    assert {f.name for f in dataclasses.fields(state.PopulationConfig)} == \
        {f.name for f in dataclasses.fields(jstate.PopulationConfig)}


def test_exports_match_reference():
    import repro.population as jp
    assert sorted(tpop.__all__) == sorted(jp.__all__)
    for name in tpop.__all__:
        assert hasattr(tpop, name)


@pytest.mark.parametrize("capacity,bank_size", [(8, 4), (8, 8), (24, 5),
                                                (3, 2)])
def test_banks_gather_scatter_bitwise(capacity, bank_size):
    """Random cohorts scattered and gathered for a few rounds, collisions
    included (capacity below the id range): banks, owners and views equal
    the reference's at every step."""
    d = 3
    jb = jstate.init_banks(capacity, bank_size, d)
    tb = state.init_banks(capacity, bank_size, d, device="cpu")
    rs = np.random.RandomState(capacity * bank_size)
    for _ in range(6):
        cohort = np.sort(rs.choice(40, 7, replace=False)).astype(np.int32)
        vals = rs.randn(7, d).astype(np.float32)
        _same(state.gather_cohort(tb, torch.from_numpy(cohort)),
              jax.jit(jstate.gather_cohort)(jb, cohort))
        jb = jax.jit(jstate.scatter_cohort)(jb, cohort, vals)
        tb = state.scatter_cohort(tb, torch.from_numpy(cohort),
                                  torch.from_numpy(vals))
        _same(tb.deltas, jb.deltas)
        _same(tb.owner, jb.owner)


def test_banks_lowest_id_wins_and_eviction_reads_cold():
    tb = state.init_banks(8, 8, 1, device="cpu")
    tb = state.scatter_cohort(tb, torch.tensor([1, 9]),
                              torch.tensor([[5.0], [11.0]]))
    assert int(tb.owner[0, 1]) == 1 and float(tb.deltas[0, 1, 0]) == 5.0
    tb = state.scatter_cohort(tb, torch.tensor([9]), torch.tensor([[3.0]]))
    assert float(state.gather_cohort(tb, torch.tensor([1]))[0, 0]) == 0.0
    assert float(state.gather_cohort(tb, torch.tensor([9]))[0, 0]) == 3.0
    # the old banks are untouched (a guard may restore them)
    assert int(state.scatter_cohort(tb, torch.tensor([2]),
                                    torch.tensor([[1.0]])).owner[0, 2]) == 2
    assert int(tb.owner[0, 2]) == -1


def test_banks_with_a_point_axis_are_each_points_own():
    tb = state.init_banks(8, 4, 2, device="cpu", points=2)
    cohorts = torch.tensor([[1, 9, 3], [0, 2, 8]])
    vals = torch.arange(12.0).reshape(2, 3, 2)
    both = state.scatter_cohort(tb, cohorts, vals)
    for g in range(2):
        one = state.scatter_cohort(state.init_banks(8, 4, 2, device="cpu"),
                                   cohorts[g], vals[g])
        assert torch.equal(both.deltas[g], one.deltas)
        assert torch.equal(both.owner[g], one.owner)
        assert torch.equal(state.gather_cohort(both, cohorts)[g],
                           state.gather_cohort(one, cohorts[g]))


@pytest.fixture(scope="module")
def pool():
    (_, y), _ = make_classification(n_train=1200, n_test=10, dim=4,
                                    n_classes=5, noise=2.0, seed=0)
    return y


@pytest.mark.parametrize("kind,m,b,spd", [("iid", 100_000, 32, 2),
                                          ("iid", 30, 40, 2),
                                          ("label_shards", 50_000, 16, 2),
                                          ("label_shards", 77, 12, 3)])
def test_population_partition_equals_reference(pool, kind, m, b, spd):
    want = jpart.population_partition(pool, m=m, b=b, kind=kind,
                                      shards_per_device=spd, seed=1)
    got = tpart.population_partition(pool, m=m, b=b, kind=kind,
                                     shards_per_device=spd, seed=1)
    for f in ("kind", "m", "b", "n", "n_classes", "shards_per_device"):
        assert getattr(got, f) == getattr(want, f)
    for f in ("order", "class_perm", "pools", "sizes"):
        a, w = getattr(got, f), getattr(want, f)
        assert (a is None) == (w is None)
        if a is not None:
            np.testing.assert_array_equal(a, w)
    devices = np.asarray([0, 1, 7, m // 2, m - 1])
    np.testing.assert_array_equal(
        got.sample_indices(torch.from_numpy(devices)).numpy(),
        np.asarray(want.sample_indices(devices)))
    two = got.sample_indices(torch.from_numpy(np.stack([devices,
                                                        devices[::-1]])))
    assert two.shape == (2, 5, b)
    if kind == "label_shards":
        for dev in (0, m - 1):
            np.testing.assert_array_equal(got.device_labels(dev),
                                          want.device_labels(dev))
    devs = np.random.default_rng(0).choice(m, min(m, 60), replace=False)
    assert tpart.population_label_bias(got, pool, devices=devs) == \
        jpart.population_label_bias(want, pool, devices=devs)
    with pytest.raises(ValueError):
        tpart.population_partition(pool, m=m, b=b, kind="dirichlet")


def test_label_bias_equals_reference(pool):
    rs = np.random.RandomState(0)
    y_dev = pool[rs.choice(len(pool), (9, 40))]
    assert tpart.label_bias(y_dev) == jpart.label_bias(y_dev)


@pytest.mark.parametrize("trim", [0.0, 0.25])
@pytest.mark.parametrize("sig,scale,bh", [(1.0, 1.0, 0.0), (1.0, 2.5, 0.3),
                                          (0.7, 0.3, 1.7)])
def test_site_mac_sum_bitwise(trim, sig, scale, bh):
    """The two-stage MAC against the reference's ``site_mac_sum`` under
    ``jit`` with the scalars traced (its sweep's program): site noise
    first, then the rows in row order, the sites in XLA's order, the
    backhaul as one fused multiply-add."""
    rs = np.random.RandomState(int(10 * sig + scale))
    k, s, ns = 12, 130, 4
    frames = rs.randn(k, s).astype(np.float32)
    sites = rs.randint(0, ns, k).astype(np.int32)
    jk, tk = _key(5)
    want = jax.jit(lambda f, si, kk, a, b_, c: jhier.site_mac_sum(
        f, si, ns, kk, a, b_, c, site_trim_frac=trim))(
        frames, sites, jk, jnp.float32(sig), jnp.float32(scale),
        jnp.float32(bh))
    got = hierarchy.site_mac_sum(
        torch.from_numpy(frames), torch.from_numpy(sites), ns, tk,
        torch.tensor(np.float32(sig)), torch.tensor(np.float32(scale)),
        torch.tensor(np.float32(bh)), site_trim_frac=trim)
    _same(got, want)
    np.testing.assert_array_equal(hierarchy.site_assignment(10, 3),
                                  jhier.site_assignment(10, 3))


def test_site_mac_sum_points_each_their_own():
    rs = np.random.RandomState(0)
    frames = torch.from_numpy(rs.randn(2, 6, 20).astype(np.float32))
    sites = torch.from_numpy(rs.randint(0, 3, (2, 6)))
    keys = rng.split(rng.PRNGKey(1), 2)
    sc = torch.tensor([1.0, 2.0])
    both = hierarchy.site_mac_sum(frames, sites, 3, keys, 1.0, sc, sc)
    for g in range(2):
        _same(both[g], hierarchy.site_mac_sum(frames[g], sites[g], 3,
                                              keys[g], 1.0, sc[g], sc[g]))


def test_site_trim_discards_a_poisoned_site():
    keys = rng.PRNGKey(7)
    frames = rng.normal(keys, (12, 40))
    sites = torch.arange(12) % 4
    honest = frames.sum(0)
    bad = torch.where((sites == 2)[:, None], 1e6, frames)
    plain = hierarchy.site_mac_sum(bad, sites, 4, keys, 0.0)
    trimmed = hierarchy.site_mac_sum(bad, sites, 4, keys, 0.0,
                                     site_trim_frac=0.25)
    assert (plain - honest).abs().max() > 1e5
    assert (trimmed - honest).abs().max() < (plain - honest).abs().max() / 100


CHANNEL_CFGS = {
    "awgn": dict(scheme="a_dsgd"),
    "fading": dict(scheme="a_dsgd", fading="rayleigh"),
    "blind": dict(scheme="a_dsgd_blind", ps_antennas=3),
    "geometry": dict(scheme="a_dsgd", fading="rayleigh", geometry="disk",
                     cell_radius=400.0),
    "robust": dict(scheme="d_dsgd", robust=True, byzantine_frac=0.3,
                   fault_rate=0.2, fault_kind="dropout", erasure_prob=0.1),
}


@pytest.mark.parametrize("name", list(CHANNEL_CFGS))
def test_cohort_draws_bitwise(name):
    """``cohort_channel_draw`` (the mask scattered to M, the cohort's rows)
    and ``cohort_fault_draw`` against the reference's under jit."""
    kw = dict(s_frac=0.5, total_steps=10, projection="dense",
              **CHANNEL_CFGS[name])
    m_total, d = 30, 40
    cohort = np.asarray([1, 4, 5, 11, 20, 29], np.int32)
    mask = np.asarray([1, 1, 0, 1, 0, 1], bool)
    js = jsch.get_scheme(JaxOTAConfig(**kw), d, 6)
    ts = tsch.get_scheme(OTAConfig(**kw), d, 6, device="cpu")
    jk, tk = _key(1003)
    want = jax.jit(lambda kk: js.cohort_channel_draw(
        jax.random.fold_in(kk, 2), 3, jnp.asarray(cohort), m_total,
        mask=jnp.asarray(mask)))(jk)
    got = ts.cohort_channel_draw(rng.fold_in(tk, 2), 3,
                                 torch.from_numpy(cohort).long(), m_total,
                                 mask=torch.from_numpy(mask))
    for f in ("p_factor", "active", "gain", "noise_scale"):
        a, w = getattr(got, f), getattr(want, f)
        assert (a is None) == (w is None), f
        if a is not None:
            np.testing.assert_allclose(_np(a).astype(np.float32),
                                       np.asarray(w, np.float32),
                                       rtol=0 if name != "blind" else 1e-6,
                                       atol=0)
    if ts.robust_on:
        wf = jax.jit(lambda kk: js.cohort_fault_draw(
            jax.random.fold_in(kk, 6), 3, jnp.asarray(cohort), m_total))(jk)
        gf = ts.cohort_fault_draw(rng.fold_in(tk, 6), 3,
                                  torch.from_numpy(cohort).long(), m_total)
        for a, w in zip(gf[:5], wf[:5]):
            _same(a, w)
    # the full cohort is the dense draw
    full = ts.cohort_channel_draw(rng.fold_in(tk, 2), 3,
                                  torch.arange(m_total), m_total)
    dense = ts.channel_draw(rng.fold_in(tk, 2), 3, m_total)
    assert torch.equal(full.p_factor.expand(m_total),
                       dense.p_factor.expand(m_total))


def test_banked_memory_law_at_1e5_devices():
    """M = 10^5 devices, K = 16, capacity 2048 at the reference's own small
    width (dim 16, 4 classes): the persistent d-sized state is
    capacity-sized, far below the dense (M, d) footprint, and three
    sampled rounds run on it."""
    m_total, k, cap = 100_000, 16, 2048
    (xtr, ytr), (xte, yte) = make_classification(
        n_train=2000, n_test=400, dim=16, n_classes=4, noise=2.0, seed=0)
    part = tpart.population_partition(ytr, m=m_total, b=32, kind="iid",
                                      seed=0)
    pdata = tpop.PopulationData.from_pool(xtr, ytr, part, device="cpu")
    pop = tpop.PopulationConfig(m_total=m_total, k_cohort=k, capacity=cap,
                                bank_size=256, avail_rate=0.9,
                                speed_sigma=0.5, straggler_deadline=5.0)
    cfg = OTAConfig(scheme="a_dsgd", s_frac=0.5, k_frac=0.25, p_avg=500.0,
                    total_steps=3, projection="dense", amp_iters=4,
                    mean_removal_steps=1)
    exp = tpop.PopulationExperiment(cfg=cfg, pop=pop, steps=3, eval_every=1)
    cp = tpop.CompiledPopulation(pdata, xte, yte, exp, device="cpu")
    banks = cp.pstate0.banks
    assert banks.deltas.shape == (cap // 256, 256, cp.d)
    nbytes = banks.deltas.numel() * banks.deltas.element_size()
    assert nbytes < m_total * cp.d * 4 / 10
    run = tpop.run_population(pdata, xte, yte, cfg, pop, steps=3,
                              eval_every=1, device="cpu")
    assert len(run.accs) == 3 and np.isfinite(run.losses).all()
