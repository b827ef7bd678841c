"""The CUDA kernels against their plain versions on the card, and a sweep
grid's point axis against each point's own call there.

Marked ``cuda``: they skip where no CUDA device is present.  On a machine
with one, from the root of the checkout:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.core.amp import amp_blocked_core
from repro_torch.kernels import (amp_fused, build, ef_sparsify, layout, ops,
                                 ota_project, ref)

pytestmark = pytest.mark.cuda

SHAPES = [(1, 128, 32), (3, 256, 64), (4, 512, 128), (2, 384, 96),
          (5, 64, 16)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.device import resolve_device
    return resolve_device(None)


def _launches(kernel):
    return ops.launch_counts()[kernel]


def _gen(dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("m,n", [(1, 5), (3, 10007), (25, 7850), (1, 7850),
                                 (4, 3), (2, 1)])
def test_ef_sparsify_bitwise(dev, m, n):
    gen = _gen(dev, n)
    g = torch.randn(m, n, generator=gen, device=dev)
    d = torch.randn(m, n, generator=gen, device=dev)
    tau = torch.rand(m, generator=gen, device=dev)
    before = _launches("ef_sparsify")
    sp, nd = ef_sparsify.ef_sparsify(g, d, tau)
    sr, dr = ref.ef_sparsify_ref(g, d, tau)
    assert _launches("ef_sparsify") == before + 1
    assert torch.equal(sp, sr) and torch.equal(nd, dr)


@pytest.mark.parametrize("g_off,d_off", [(1, 1), (2, 2), (3, 3), (1, 2),
                                         (0, 3)])
def test_ef_sparsify_offset_views(dev, g_off, d_off):
    """Inputs that start off a 16-byte boundary: the flat range's head and
    tail are single entries where all arrays share the offset, and every
    entry is where they do not."""
    m, n = 25, 7850
    gen = _gen(dev, 31 + g_off + d_off)
    gbuf = torch.randn(m * n + 4, generator=gen, device=dev)
    dbuf = torch.randn(m * n + 4, generator=gen, device=dev)
    g = gbuf[g_off:g_off + m * n].view(m, n)
    d = dbuf[d_off:d_off + m * n].view(m, n)
    tau = torch.rand(m, generator=gen, device=dev)
    sp, nd = ef_sparsify.ef_sparsify(g, d, tau)
    sr, dr = ref.ef_sparsify_ref(g, d, tau)
    assert torch.equal(sp, sr) and torch.equal(nd, dr)


# (n_blocks, c, s_block): SHAPES and the main path's 2 blocks of 4096 -> 1024
P_SHAPES = SHAPES + [(2, 4096, 1024)]


@pytest.mark.parametrize("nb,c,sb", P_SHAPES)
@pytest.mark.parametrize("rademacher", [True, False])
@pytest.mark.parametrize("m", [1, 3, 25, 33])
def test_ota_project(dev, nb, c, sb, rademacher, m):
    x = torch.randn(m, nb, c, generator=_gen(dev, nb * c + m), device=dev)
    seed = torch.tensor(0xDEADBEEF, dtype=torch.int64, device=dev)
    before = _launches("ota_project")
    y = ota_project.ota_project(x, seed, sb, rademacher)
    assert _launches("ota_project") == before + 1
    want = ref.ota_project_ref(x, seed, sb, rademacher)
    np.testing.assert_allclose(y.cpu().numpy(), want.cpu().numpy(),
                               rtol=3e-5, atol=3e-5)
    assert torch.equal(y, ota_project.ota_project(x, seed, sb, rademacher))
    if (nb, c, sb) == (2, 4096, 1024) and rademacher:
        # bitwise with the plain version at the main path's shape, as the
        # kernel it replaces was
        assert torch.equal(y, want)


def _noisy_block_sparse(nb, c, sb, rademacher, gen, dev):
    x = torch.zeros(nb, c, device=dev)
    for b in range(nb):
        idx = torch.randperm(c, generator=gen, device=dev)[:max(1, sb // 8)]
        x[b, idx] = torch.randn(idx.numel(), generator=gen, device=dev)
    return ref.ota_project_ref(x, 9, sb, rademacher) \
        + 0.01 * torch.randn(nb, sb, generator=gen, device=dev)


@pytest.mark.parametrize("rademacher", [True, False])
def test_amp_fused(dev, rademacher):
    nb, c, sb = 8, 256, 128
    gen = _gen(dev, 3)
    x = torch.zeros(nb, c, device=dev)
    for b in range(nb):
        x[b, torch.randperm(c, generator=gen, device=dev)[:sb // 8]] = 1.0
    yb = ref.ota_project_ref(x, 9, sb, rademacher)
    out = amp_fused.amp_decode_fused(yb, 9, c, iters=20,
                                     rademacher=rademacher)
    want = amp_blocked_core(yb, 9, c, iters=20, rademacher=rademacher)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)
    part = amp_fused.amp_decode_fused(yb[3:].contiguous(), 9, c, iters=20,
                                      rademacher=rademacher, id_offset=3)
    assert torch.equal(part, out[3:])


# (n_blocks, s_block, c, iters): the main path's decode (clusters of 16
# CTAs), a ragged one (clusters of 2, 500-column slices), more blocks than
# the card holds at once of one-CTA clusters and of 4-CTA clusters
AMP_SHAPES = [(2, 1024, 4096, 20), (3, 100, 1000, 20), (512, 32, 64, 20),
              (300, 256, 1024, 10)]


@pytest.mark.parametrize("nb,sb,c,iters", AMP_SHAPES)
@pytest.mark.parametrize("rademacher", [True, False])
def test_amp_fused_clusters(dev, nb, sb, c, iters, rademacher):
    """The bar against the plain decode, two runs bitwise, and an
    ``id_offset`` sub-range bitwise the full decode's rows."""
    yb = _noisy_block_sparse(nb, c, sb, rademacher, _gen(dev, nb + c), dev)
    before = _launches("amp_fused")
    out = amp_fused.amp_decode_fused(yb, 9, c, iters=iters,
                                     rademacher=rademacher)
    assert _launches("amp_fused") == before + 1
    want = amp_blocked_core(yb, 9, c, iters=iters, rademacher=rademacher)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)
    again = amp_fused.amp_decode_fused(yb, 9, c, iters=iters,
                                       rademacher=rademacher)
    assert torch.equal(out, again)
    lo = nb // 3 + 1
    part = amp_fused.amp_decode_fused(yb[lo:].contiguous(), 9, c,
                                      iters=iters, rademacher=rademacher,
                                      id_offset=lo)
    assert torch.equal(part, out[lo:])


# (n_blocks, s_block, c, iters): the main path's decode; 500-column
# slices, whose last word is 20 columns; 501-column slices, whose 21-column
# last word ends in a part group, over a 102-row segment (no multiple of 4);
# s = c / 2 at the default c, which keeps the column-major copy of the sign
# bits; 3072 x 4096 and 2048 x 8192, which turn the bits around in
# registers instead; 4401 x 4100, whose adjoint tables come in
# three chunks, and 701 x 32770, whose forward tables come in three and
# adjoint tables in two, both ragged
TABLE_SHAPES = [(2, 1024, 4096, 20), (3, 100, 1000, 20), (3, 102, 1002, 20),
                (2, 2048, 4096, 20), (1, 3072, 4096, 20), (1, 2048, 8192, 20),
                (1, 4401, 4100, 20), (1, 701, 32770, 20)]


@pytest.mark.parametrize("nb,sb,c,iters", TABLE_SHAPES)
def test_amp_fused_sign_tables_bitwise(dev, nb, sb, c, iters):
    """The Rademacher decode, its products summed through tables of signed
    partial sums, equals the plain version bitwise, padded groups and all."""
    yb = _noisy_block_sparse(nb, c, sb, True, _gen(dev, 7 * nb + sb), dev)
    out = amp_fused.amp_decode_fused(yb, 9, c, iters=iters)
    want = amp_blocked_core(yb, 9, c, iters=iters)
    assert torch.equal(out, want)
    assert int((want != 0).sum()) > 0


def _one_bit_per_entry_bytes(s, c):
    """Shared memory of a Rademacher CTA that keeps one sign bit per entry
    of A (rows at an odd stride of words), partials and z in float64, and
    no tables."""
    k = layout.amp_cluster_size(s, c)
    g = layout.amp_row_segments(s, c)
    cw, rw = -(-c // k), -(-s // k)
    words = (cw + 31) // 32
    doubles = s + max(s, g * words * 32) + cw + rw + 4 + layout.AMP_WARPS
    return doubles * 8 + 4 * (layout.AMP_WARPS + 1 + rw + s * (words | 1))


def test_amp_fused_tables_fit_where_one_bit_per_entry_did(dev):
    """Every Rademacher block whose sign bits, one per entry of A, fitted
    a CTA's 227 KB of shared memory still fits beside the tables: at the
    largest such s of each c, and at every s up to 64."""
    lib = build.library()
    limit = 232448
    cs = list(range(1, 4200, 7)) + list(range(4200, 120000, 331))
    checked = 0
    for c in cs:
        lo, hi = 0, 1
        while _one_bit_per_entry_bytes(hi, c) <= limit:
            lo, hi = hi, 2 * hi
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if _one_bit_per_entry_bytes(mid, c) <= limit \
                else (lo, mid)
        for s in set(range(1, min(lo, 64) + 1)) | ({lo} if lo else set()):
            k = layout.amp_cluster_size(s, c)
            g = layout.amp_row_segments(s, c)
            assert lib.amp_fused_smem_bytes(s, c, k, g, 1) <= limit, (s, c)
            checked += 1
    assert checked > 10000


@pytest.mark.parametrize("rademacher,tables", [(True, 1), (False, 0)])
def test_amp_fused_counts_sign_tables_on_card(dev, rademacher, tables):
    """A Rademacher launch adds 1 to ``amp_fused.sign_tables``, a Gaussian
    launch 0; each adds 1 to ``launches.amp_fused``."""
    yb = _noisy_block_sparse(2, 1000, 100, rademacher, _gen(dev, 5), dev)
    before = tracing.totals().get("amp_fused.sign_tables", 0)
    launches = _launches("amp_fused")
    amp_fused.amp_decode_fused(yb, 9, 1000, iters=3, rademacher=rademacher)
    assert _launches("amp_fused") == launches + 1
    assert tracing.totals().get("amp_fused.sign_tables", 0) == \
        before + tables


def test_amp_fused_shapes_in_any_order(dev):
    """A launch of a small cluster shape does not cap a later, larger one:
    each launch's shared memory is its own, whatever ran before."""
    gen = _gen(dev, 17)
    for nb, sb, c in [(4, 256, 1024), (2, 1024, 4096), (3, 100, 1000),
                      (2, 1024, 4096)]:
        yb = _noisy_block_sparse(nb, c, sb, True, gen, dev)
        out = amp_fused.amp_decode_fused(yb, 9, c, iters=5)
        want = amp_blocked_core(yb, 9, c, iters=5)
        np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-4, atol=1e-5)


# (n_blocks, c, s_block): bench_kernels.py's shapes, the path's, a ragged
# c that is no multiple of the kernel's 256-column tile, and a ragged s
# that is no multiple of its cluster (777 rows on 4 CTAs: 194 and 195)
T_SHAPES = SHAPES + [(2, 4096, 1024), (3, 1000, 100), (3, 1000, 777),
                     (64, 1024, 256)]


@pytest.mark.parametrize("nb,c,sb", T_SHAPES)
@pytest.mark.parametrize("rademacher", [True, False])
@pytest.mark.parametrize("m", [1, 3, 25])
def test_ota_project_t(dev, nb, c, sb, rademacher, m):
    y = torch.randn(m, nb, sb, generator=_gen(dev, nb * sb + m), device=dev)
    seed = torch.tensor(0xDEADBEEF, dtype=torch.int64, device=dev)
    before = _launches("ota_project_t")
    r = ops.ota_project_t(y, seed=seed, c=c, rademacher=rademacher,
                          use_kernel=True)
    assert _launches("ota_project_t") == before + 1
    assert r.shape == (m, nb, c)
    np.testing.assert_allclose(
        r.cpu().numpy(), ref.ota_project_t_ref(y, seed, c, rademacher).cpu().numpy(),
        rtol=3e-5, atol=3e-5)
    again = ops.ota_project_t(y, seed=seed, c=c, rademacher=rademacher,
                              use_kernel=True)
    assert torch.equal(r, again)
    if rademacher and (nb, c, sb) in ((2, 4096, 1024), (64, 1024, 256)):
        # bitwise with the plain version at the unfused decode's shape and
        # bench_kernels.py's medium one, as the kernel it replaces was
        assert torch.equal(r, ref.ota_project_t_ref(y, seed, c, rademacher))


@pytest.mark.parametrize("m", [1, 3])
def test_projections_past_the_grid_limit(dev, m):
    """More blocks than the grid's y limit (65 535): each CTA loops over
    blocks y, y + 65 535, ..., so every block is projected with its own
    hash, against the plain versions, one launch a call."""
    nb, c, sb = 70_001, 64, 16
    gen = _gen(dev, nb + m)
    seed = torch.tensor(0xDEADBEEF, dtype=torch.int64, device=dev)
    x = torch.randn(m, nb, c, generator=gen, device=dev)
    before = _launches("ota_project")
    y = ota_project.ota_project(x, seed, sb, True)
    assert _launches("ota_project") == before + 1
    np.testing.assert_allclose(
        y.cpu().numpy(), ref.ota_project_ref(x, seed, sb, True).cpu().numpy(),
        rtol=3e-5, atol=3e-5)
    before = _launches("ota_project_t")
    r = ota_project.ota_project_t(y, seed, c)
    assert _launches("ota_project_t") == before + 1
    np.testing.assert_allclose(
        r.cpu().numpy(), ref.ota_project_t_ref(y, seed, c).cpu().numpy(),
        rtol=3e-5, atol=3e-5)


def test_ota_project_t_shapes_in_any_order(dev):
    """A launch of one shape leaves nothing that a later shape depends on
    (cluster sizes 8, 4, 1 and back)."""
    gen = _gen(dev, 23)
    for m, nb, sb, c in [(1, 2, 1024, 4096), (3, 3, 777, 1000),
                         (25, 5, 16, 64), (1, 2, 1024, 4096),
                         (3, 3, 777, 1000)]:
        y = torch.randn(m, nb, sb, generator=gen, device=dev)
        r = ota_project.ota_project_t(y, 7, c)
        np.testing.assert_allclose(
            r.cpu().numpy(), ref.ota_project_t_ref(y, 7, c).cpu().numpy(),
            rtol=3e-5, atol=3e-5)


def test_ota_project_t_adjoint_identity(dev):
    nb, c, sb = 3, 1000, 100
    gen = _gen(dev, 11)
    x = torch.randn(nb, c, generator=gen, device=dev)
    y = torch.randn(nb, sb, generator=gen, device=dev)
    ax = ota_project.ota_project(x, 5, sb)
    aty = ota_project.ota_project_t(y, 5, c)
    np.testing.assert_allclose(float((ax.double() * y.double()).sum()),
                               float((x.double() * aty.double()).sum()),
                               rtol=1e-4)


def test_unfused_decode_on_card(dev):
    """amp_decode_blocked on a use_kernel projector: iters adjoint and
    iters + 1 forward launches, and the plain projector's decode."""
    from repro_torch.core.amp import amp_decode_blocked
    from repro_torch.core.projection import BlockedProjector
    nb, c, sb, iters = 4, 512, 128, 10
    gen = _gen(dev, 5)
    x = torch.zeros(nb, c, device=dev)
    for b in range(nb):
        x[b, torch.randperm(c, generator=gen, device=dev)[:sb // 8]] = 1.0
    proj = BlockedProjector(d=nb * c, block_size=c, s_block=sb, seed=9,
                            use_kernel=True)
    yb = ref.ota_project_ref(x, 9, sb) \
        + 0.01 * torch.randn(nb, sb, generator=gen, device=dev)
    ops.reset_launches()
    out = amp_decode_blocked(yb, proj, iters=iters)
    counts = ops.launch_counts()
    assert counts["ota_project_t"] == iters
    assert counts["ota_project"] == iters + 1
    plain = amp_decode_blocked(
        yb, BlockedProjector(d=nb * c, block_size=c, s_block=sb, seed=9),
        iters=iters)
    np.testing.assert_allclose(out.cpu().numpy(), plain.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)


def test_run_federated_on_card_matches_cpu(dev):
    from repro_torch.configs.base import OTAConfig
    from repro_torch.data import federated_split, make_classification
    from repro_torch.train.paper_repro import run_federated
    (xtr, ytr), (xte, yte) = make_classification(n_train=400, n_test=300,
                                                 dim=64, seed=1)
    xd, yd = federated_split(xtr, ytr, m=4, b=32, seed=0)
    cfg = OTAConfig(projection="blocked", block_size=128, s_frac=0.5,
                    k_frac=0.25, rademacher=True, use_kernel=True,
                    total_steps=5, amp_iters=10, mean_removal_steps=2)
    ops.reset_launches()
    rg = run_federated(xd, yd, xte, yte, cfg, steps=5, eval_every=1)
    # the fused decode: the adjoint kernel is not on this path
    assert ops.launch_counts() == {"ef_sparsify": 5, "ota_project": 5,
                                   "ota_project_t": 0, "amp_fused": 5}
    rc = run_federated(xd, yd, xte, yte, cfg, steps=5, eval_every=1,
                       device="cpu")
    np.testing.assert_allclose(rg.losses, rc.losses, rtol=1e-4, atol=1e-5)


def _graph_case(name, dev):
    """One wrapper call at its path's shape, as a closure over its inputs."""
    gen = _gen(dev, 41)
    if name == "ef_sparsify":
        g = torch.randn(25, 7850, generator=gen, device=dev)
        d = torch.randn(25, 7850, generator=gen, device=dev)
        tau = torch.rand(25, generator=gen, device=dev)
        return lambda: ef_sparsify.ef_sparsify(g, d, tau)
    if name == "ota_project":
        x = torch.randn(25, 2, 4096, generator=gen, device=dev)
        return lambda: ota_project.ota_project(x, 12345, 1024)
    if name == "ota_project_t":
        y = torch.randn(1, 2, 1024, generator=gen, device=dev)
        return lambda: ota_project.ota_project_t(y, 12345, 4096)
    if name == "amp_fused_points":
        yb = torch.stack([_noisy_block_sparse(2, 4096, 1024, True, gen, dev)
                          for _ in range(4)])
        return lambda: amp_fused.amp_decode_fused(yb, 9, 4096, iters=20)
    yb = _noisy_block_sparse(2, 4096, 1024, True, gen, dev)
    return lambda: amp_fused.amp_decode_fused(yb, 9, 4096, iters=20)


@pytest.mark.parametrize("name", ["ef_sparsify", "ota_project",
                                  "ota_project_t", "amp_fused",
                                  "amp_fused_points"])
def test_wrapper_captured_in_cuda_graph(dev, name):
    """Each wrapper can be captured in a CUDA graph (as ``chip_smoke.py``
    times it) and the replayed graph's output equals an eager call."""
    fn = _graph_case(name, dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    graph.replay()
    torch.cuda.synchronize()
    eager = eager if isinstance(eager, tuple) else (eager,)
    captured = captured if isinstance(captured, tuple) else (captured,)
    assert all(torch.equal(a, b) for a, b in zip(eager, captured))


def test_dense_matrix_on_card_equals_cpu(dev):
    """The paper-scale dense A on the card is the CPU's bit for bit, at an
    s_tilde whose square root is inexact (148), and ``None`` is the card."""
    from repro_torch.core.projection import DenseProjector
    proj = DenseProjector(d=300, s_tilde=148, seed=3)
    on_card = proj.matrix(dev)
    assert on_card.device.type == "cuda"
    assert torch.equal(on_card.cpu(), proj.matrix("cpu"))
    assert proj.matrix().device.type == "cuda"


@pytest.mark.parametrize("scheme", ["ideal", "a_dsgd"])
def test_engine_equals_run_federated_on_card(dev, scheme):
    """On the card too the engine equals the looped ``run_federated`` entry
    for entry: the ideal link divides by M truly in both (the engine's M is
    a tensor, the loop's a python int)."""
    from repro_torch.configs.base import OTAConfig
    from repro_torch.data import federated_split, make_classification
    from repro_torch.experiments import engine
    from repro_torch.train.paper_repro import run_federated
    (xtr, ytr), (xte, yte) = make_classification(
        n_train=800, n_test=300, dim=48, noise=2.0, seed=3)
    xd, yd = federated_split(xtr, ytr, m=25, b=32, iid=True, seed=0)
    cfg = OTAConfig(scheme=scheme, s_frac=0.5, k_frac=0.25, p_avg=500.0,
                    total_steps=6, projection="blocked", block_size=64,
                    use_kernel=True, amp_iters=6, mean_removal_steps=2)
    loop = run_federated(xd, yd, xte, yte, cfg, steps=6, lr=1e-3,
                         eval_every=2)
    eng = engine.run_compiled(xd, yd, xte, yte, cfg, steps=6, lr=1e-3,
                              eval_every=2)
    assert eng.accs == loop.accs and eng.losses == loop.losses
    assert all(torch.equal(eng.params[k], loop.params[k])
               for k in loop.params)


@pytest.mark.parametrize("points", [1, 3, 4])
@pytest.mark.parametrize("rademacher", [True, False])
def test_amp_fused_points(dev, points, rademacher):
    """G points of the main path's decode in one launch: each point bitwise
    its own G = 1 launch, the bar against the plain version (bitwise for
    Rademacher entries), and an ``id_offset`` sub-range of every point
    bitwise the full decode's rows."""
    gen = _gen(dev, 50 + points)
    yb = torch.stack([_noisy_block_sparse(2, 4096, 1024, rademacher, gen,
                                          dev) for _ in range(points)])
    before = _launches("amp_fused")
    out = amp_fused.amp_decode_fused(yb, 9, 4096, iters=20,
                                     rademacher=rademacher)
    assert _launches("amp_fused") == before + 1
    assert out.shape == (points, 2, 4096)
    for g in range(points):
        one = amp_fused.amp_decode_fused(yb[g], 9, 4096, iters=20,
                                         rademacher=rademacher)
        assert torch.equal(out[g], one)
    want = amp_blocked_core(yb, 9, 4096, iters=20, rademacher=rademacher)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)
    if rademacher:
        assert torch.equal(out, want)
    part = amp_fused.amp_decode_fused(yb[:, 1:].contiguous(), 9, 4096,
                                      iters=20, rademacher=rademacher,
                                      id_offset=1)
    assert torch.equal(part, out[:, 1:])


def test_amp_fused_max_active_clusters(dev):
    """The card holds at least one 16-CTA cluster of the main path's
    decode, and the query answers for the other cluster sizes too."""
    assert amp_fused.max_active_clusters(1024, 4096) >= 1
    assert amp_fused.max_active_clusters(1024, 4096, rademacher=False) >= 1
    assert amp_fused.max_active_clusters(32, 64) >= 1


def test_point_rows_pass_through_the_wrappers(dev):
    """A grid's (G, M) rows go through ef_sparsify and ota_project as G * M
    rows, and each point's rows are bitwise its own M-row call."""
    gen = _gen(dev, 61)
    g = torch.randn(4, 25, 7850, generator=gen, device=dev)
    d = torch.randn(4, 25, 7850, generator=gen, device=dev)
    tau = torch.rand(4, 25, generator=gen, device=dev)
    x = torch.randn(4, 25, 2, 4096, generator=gen, device=dev)
    sp, nd = ef_sparsify.ef_sparsify(g, d, tau)
    y = ota_project.ota_project(x, 12345, 1024)
    for p in range(4):
        sp1, nd1 = ef_sparsify.ef_sparsify(g[p], d[p], tau[p])
        assert torch.equal(sp[p], sp1) and torch.equal(nd[p], nd1)
        assert torch.equal(y[p], ota_project.ota_project(x[p], 12345, 1024))


@pytest.mark.parametrize("scheme", ["ideal", "a_dsgd", "d_dsgd", "qsgd",
                                    "signsgd"])
def test_run_grid_equals_run_compiled_on_card(dev, scheme):
    """A batched grid of P-bar points equals each point's own run on the
    card, accuracies and losses bitwise, for every scheme of the paper."""
    from repro_torch.configs.base import OTAConfig
    from repro_torch.data import federated_split, make_classification
    from repro_torch.experiments import engine, sweep
    (xtr, ytr), (xte, yte) = make_classification(
        n_train=800, n_test=300, dim=48, noise=2.0, seed=3)
    xd, yd = federated_split(xtr, ytr, m=25, b=32, iid=True, seed=0)
    cfg = OTAConfig(scheme=scheme, s_frac=0.5, k_frac=0.25, p_avg=500.0,
                    total_steps=6, projection="blocked", block_size=64,
                    use_kernel=True, amp_iters=6, mean_removal_steps=2)
    grid = [{"p_avg": 50.0}, {"p_avg": 500.0}, {"p_avg": 2000.0}]
    ce = engine.CompiledExperiment(xd, yd, xte, yte, engine.Experiment(
        cfg=cfg, steps=6, eval_every=2))
    ov, keys, _ = sweep.grid_inputs(ce, grid, 6)
    outs = ce.run_grid(ov, keys)
    for g, point in enumerate(grid):
        one = engine.run_compiled(
            xd, yd, xte, yte, dataclasses.replace(cfg, **point),
            steps=6, lr=1e-3, eval_every=1)
        assert outs["acc"][g].cpu().numpy().tolist() == \
            one.all_accs.tolist()
        assert outs["loss"][g].cpu().numpy().tolist() == \
            one.all_losses.tolist()


@pytest.mark.parametrize("scheme", ["d_dsgd", "signsgd", "qsgd"])
def test_digital_run_federated_on_card_matches_cpu(dev, scheme):
    """The digital baselines' looped driver on the card, within the bar of
    the CPU's run (the gradients' cuBLAS sums differ from the CPU's)."""
    from repro_torch.configs.base import OTAConfig
    from repro_torch.data import federated_split, make_classification
    from repro_torch.train.paper_repro import run_federated
    (xtr, ytr), (xte, yte) = make_classification(
        n_train=800, n_test=300, dim=48, noise=2.0, seed=3)
    xd, yd = federated_split(xtr, ytr, m=25, b=32, iid=True, seed=0)
    cfg = OTAConfig(scheme=scheme, s_frac=0.5, p_avg=500.0, total_steps=6)
    rg = run_federated(xd, yd, xte, yte, cfg, steps=6, eval_every=1)
    rc = run_federated(xd, yd, xte, yte, cfg, steps=6, eval_every=1,
                       device="cpu")
    assert [m["q_t"] for m in rg.metrics] == [m["q_t"] for m in rc.metrics]
    np.testing.assert_allclose(rg.losses, rc.losses, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the point axis, site by site, at the sweep phase's shapes: G = 4 points of
# M = 25 devices, d = 7850, frames of 2 * 1024 + 2, 10 000 test rows.  A
# batched call must give each point the bits of that point's own call on
# fresh tensors, as the point's own run holds them.
# ---------------------------------------------------------------------------

G, M_DEV, D_MODEL, S_TILDE, N_TEST = 4, 25, 7850, 2048, 10000


def _lone(fn, *xs):
    """``fn`` on a fresh copy of each point's inputs, stacked."""
    outs = [fn(*(x[g].clone() for x in xs)) for g in range(xs[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(parts) for parts in zip(*outs))
    return torch.stack(outs)


def _assert_same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert torch.equal(a, b), float((a.double() - b.double()).abs().max())


def _site_case(name, dev):
    """``(fn, inputs)`` of one point-axis site: ``fn`` takes either the
    batched inputs or one point's."""
    from repro_torch import rng
    from repro_torch.core import amp, channel, schemes
    from repro_torch.core.projection import DenseProjector
    from repro_torch.train import paper_repro as tpr
    gen = _gen(dev, 7)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    if name == "mac_sum":
        keys = rng.split(rng.PRNGKey(3, dev), G)
        return (lambda f, k: channel.mac_sum(f, k, 1.0),
                (randn(G, M_DEV, S_TILDE + 2), keys))
    if name.startswith("make_frame"):
        n = int(name.split("_")[-1])
        return (lambda g, p: channel.make_frame(g, p, True),
                (randn(G, M_DEV, n), 500.0 * randn(G, M_DEV).abs()))
    if name == "frame_power":
        frames, _ = channel.make_frame(randn(G, M_DEV, S_TILDE),
                                       500.0 * randn(G, M_DEV).abs(), True)
        return channel.frame_power, (frames,)
    if name == "metric_mean":
        ints = torch.randint(0, 500, (G, M_DEV), generator=gen, device=dev,
                             dtype=torch.int32)
        return (lambda f, i: (schemes.metric_mean(f),
                              schemes.metric_mean(i)),
                (randn(G, M_DEV).abs(), ints))
    xd = randn(M_DEV, 40, 784)
    yd = torch.randint(0, 10, (M_DEV, 40), generator=gen, device=dev)
    params = (0.1 * randn(G, 10), 0.1 * randn(G, 784, 10))
    if name == "device_grads":
        return (lambda b, w, mom: tpr.device_grads(
                    {"b": b, "w": w}, xd, yd, mom, momentum_correction=0.5),
                (*params, randn(G, M_DEV, D_MODEL)))
    if name == "accuracy_and_loss":
        xt = randn(N_TEST, 784)
        yt = torch.randint(0, 10, (N_TEST,), generator=gen, device=dev)
        return (lambda b, w: (tpr.accuracy({"b": b, "w": w}, xt, yt),
                              tpr.ce_loss({"b": b, "w": w}, xt, yt)),
                params)
    if name == "dense_amp":
        proj = DenseProjector(d=D_MODEL, s_tilde=S_TILDE, seed=5)
        return (lambda y: amp.amp_decode(y, proj, iters=20),
                (randn(G, S_TILDE),))
    if name in CHANNEL_SITES:
        return _channel_site(name, dev)
    if name in ROBUST_SITES:
        return _robust_site(name, dev)
    raise KeyError(name)


#: the channel axes' point-axis sites: the Gauss-Markov weights and their
#: product with the innovations, the blind combiner's sums and products,
#: the CSI estimate, the geometry gains and the schedule
CHANNEL_SITES = ("gauss_markov_weights", "gauss_markov_gains",
                 "blind_combiner", "csi_estimate", "geometry_gains",
                 "schedule")


#: the robustness axis's point-axis sites: the power cap on G points'
#: frames with a (G,) cap, the three combines with (G,) scalars, the fault
#: draw with (G,) rates and G round keys
ROBUST_SITES = ("clip_frame_power", "trimmed_mean", "median", "norm_cap",
                "fault_draw")


@pytest.mark.parametrize("name", ["mac_sum", "make_frame_2048",
                                  "make_frame_1962", "frame_power",
                                  "metric_mean", "device_grads",
                                  "accuracy_and_loss", "dense_amp",
                                  *CHANNEL_SITES, *ROBUST_SITES])
def test_point_axis_site_on_card(dev, name):
    fn, xs = _site_case(name, dev)
    _assert_same(fn(*xs), _lone(fn, *xs))


def _round_cfg(name):
    from repro_torch.configs.base import ota_overrides
    base = dataclasses.replace(ota_overrides("mnist_mlp"), use_kernel=True,
                               amp_iters=20, total_steps=20)
    if name == "a_dsgd_dense":
        return dataclasses.replace(base, scheme="a_dsgd", projection="dense",
                                   use_kernel=False)
    return dataclasses.replace(base, scheme=name)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["ideal", "a_dsgd", "a_dsgd_dense",
                                  "d_dsgd", "signsgd", "qsgd"])
def test_point_axis_round_on_card(dev, name, masked):
    """One batched round (``round_simulated``, or ``round_masked`` with a
    mask per point) at the sweep's shapes: each point's ghat, error state
    and metrics are its own round's, bitwise."""
    from repro_torch import rng
    from repro_torch.core.schemes import (
        MACContext, get_scheme, round_simulated,
    )
    from repro_torch.experiments.engine import round_masked
    cfg = _round_cfg(name)
    gen = _gen(dev, 11)
    grads = 0.01 * torch.randn(G, M_DEV, D_MODEL, generator=gen, device=dev)
    deltas = 0.01 * torch.randn(G, M_DEV, D_MODEL, generator=gen, device=dev)
    keys = rng.split(rng.PRNGKey(1002, dev), G)
    masks = (torch.rand(G, M_DEV, generator=gen, device=dev) > 0.3).float()
    one = [get_scheme(dataclasses.replace(cfg, p_avg=p), D_MODEL, M_DEV,
                      device=dev) for p in (50.0, 200.0, 500.0, 1000.0)]
    ov = {"p_sched": torch.stack([s.p_sched for s in one])}
    if hasattr(one[0], "q_sched"):
        ov["q_sched"] = torch.stack([s.q_sched for s in one])
    grid = one[0].with_overrides(**ov)
    grid.q_max = max(getattr(s, "q_max", 1) for s in one)
    ctx = MACContext(m=M_DEV, use_kernel=cfg.use_kernel)

    def round_(sch, g, d, k, mk):
        if masked:
            return round_masked(sch, g, d, 1, k, mk, ctx)
        return round_simulated(sch, g, d, 1, k, ctx)

    gh, dl, met = round_(grid, grads, deltas, keys, masks)
    for p, sch in enumerate(one):
        gh1, dl1, met1 = round_(sch, grads[p].clone(), deltas[p].clone(),
                                keys[p].clone(), masks[p].clone())
        assert torch.equal(gh[p], gh1) and torch.equal(dl[p], dl1)
        assert set(met) == set(met1)
        for k in met1:
            assert torch.equal(met[k][p], met1[k]), k


# ---------------------------------------------------------------------------
# the channel axes on the card
# ---------------------------------------------------------------------------


def _helper_case(name, gen):
    """``(fn, inputs)`` of one XLA-exact helper of rng.py, on CPU tensors."""
    from repro_torch import rng
    cpu = torch.Generator().manual_seed(21)
    x = torch.randn(3, 200_000, generator=cpu)
    if name == "fma_f32":
        # constructed ties (a*b half an ulp of c off by 2**-47) and randoms
        c = torch.rand(4096, generator=cpu) + 1.0
        ulp = torch.nextafter(c, torch.full_like(c, 3.0)) - c
        a = (ulp.double() / 2 * (1 + 2.0 ** -23)).float()
        b = torch.full_like(c, 1 - 2.0 ** -23)
        return rng.fma_f32, (torch.cat([x[0], a]), torch.cat([x[1], b]),
                             torch.cat([x[2], c]))
    if name == "exp_f32":
        return rng.exp_f32, (torch.cat([25 * x[0] - 20, 90 * x[1]]),)
    if name == "pow_f32":
        rho = torch.rand(2000, 1, generator=cpu) * 2 - 1
        return (lambda r, y: (rng.pow_f32(r, torch.arange(64.0,
                                                          device=r.device)),
                              rng.pow_f32(y.abs() * 3, 5 * y)),
                (rho, x[0]))
    if name == "log_f32":
        return rng.log_f32, (x[0].abs() * 100 + 1e-30,)
    if name == "fold_in_tensor":
        key = rng.PRNGKey(17)
        salts = torch.arange(64, dtype=torch.int64) + (1 << 20) - 7
        return (lambda s: rng.fold_in(key.to(s.device), s), (salts,))
    if name == "normal_scaled":
        key = rng.fold_in(rng.split(rng.PRNGKey(3), 64), 2)
        return (lambda k: rng.normal_scaled(k, (2, 25), 0.70710677), (key,))
    raise KeyError(name)


@pytest.mark.parametrize("name", ["fma_f32", "exp_f32", "pow_f32", "log_f32",
                                  "fold_in_tensor", "normal_scaled"])
def test_xla_helpers_on_card_equal_cpu(dev, name):
    """Each XLA-exact helper gives the CPU's bits on the card."""
    fn, xs = _helper_case(name, None)
    want = fn(*xs)
    got = fn(*(x.to(dev) for x in xs))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b), name


def _channel_site(name, dev):
    """``(fn, inputs)`` of one channel point-axis site: a ``(G,)`` scalar or
    ``(G, ...)`` gains batched, or one point's slice."""
    from repro_torch import rng
    from repro_torch.configs.base import OTAConfig
    from repro_torch.core import fading, geometry, scheduling
    gen = _gen(dev, 13)
    rho = torch.tensor([0.5, 0.9, 0.95, 0.99], device=dev)
    if name == "gauss_markov_weights":
        return (lambda r: fading.gauss_markov_weights(r, 64), (rho,))
    if name == "gauss_markov_gains":
        spec = fading.FadingSpec(process="gauss_markov", window=64)
        fkey = fading.fading_base_key(0, dev)
        return (lambda r: fading.process_gains(spec, fkey, fkey, 7, M_DEV,
                                               rho=r), (rho,))
    if name == "blind_combiner":
        return (fading.blind_combiner_stats,
                (torch.randn(G, M_DEV, 32, generator=gen, device=dev),
                 torch.randn(G, M_DEV, 32, generator=gen, device=dev)))
    if name == "csi_estimate":
        re = torch.randn(M_DEV, generator=gen, device=dev)
        keys = rng.split(rng.PRNGKey(4, dev), G)
        return (lambda k, v: fading.csi_estimate(re, re * 0.5, k, v),
                (keys, torch.tensor([0.0, 0.1, 0.4, 0.8], device=dev)))
    if name == "geometry_gains":
        spec = geometry.GeometrySpec()
        key = geometry.geometry_base_key(0, dev)
        return (lambda r, g: geometry.large_scale_gains(key, M_DEV, r, g,
                                                        spec),
                (torch.tensor([100.0, 400.0, 800.0, 1600.0], device=dev),
                 torch.tensor([2.0, 3.0, 3.0, 3.7], device=dev)))
    if name == "schedule":
        sch = scheduling.get_scheduler(OTAConfig(scheduler="prop_fair"))
        mask = torch.rand(G, M_DEV, generator=gen, device=dev) > 0.2
        return (lambda g, s, n, mk: scheduling.schedule(
                    sch, None, 3, g, n, state=s, mask=mk),
                (torch.rand(G, M_DEV, generator=gen, device=dev) * 3,
                 torch.rand(G, M_DEV, generator=gen, device=dev),
                 torch.tensor([1.0, 2.0, 2.0, 5.0], device=dev), mask))
    raise KeyError(name)


CHANNEL_ROUNDS = {
    "fading_gauss_markov": (dict(scheme="a_dsgd_fading",
                                 fading_process="gauss_markov",
                                 fading_window=64),
                            "fading_rho", (0.5, 0.9, 0.95, 0.99)),
    "csi_err": (dict(scheme="a_dsgd_csi_err"), "csi_err_var",
                (0.0, 0.1, 0.4, 0.8)),
    "fading_threshold": (dict(scheme="a_dsgd_fading"), "fading_threshold",
                         (0.1, 0.3, 0.6, 0.9)),
    "blind": (dict(scheme="a_dsgd_blind", ps_antennas=2), "p_avg",
              (50.0, 200.0, 500.0, 1000.0)),
    "geometry": (dict(scheme="a_dsgd", fading="rayleigh", geometry="disk",
                      path_loss_exp=3.0), "cell_radius",
                 (100.0, 400.0, 800.0, 1600.0)),
}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", list(CHANNEL_ROUNDS))
def test_point_axis_channel_round_on_card(dev, name, masked):
    """One batched channel round at the sweep's shapes, with a ``(G,)``
    channel scalar (or P-bar for the blind combiner): each point's ghat,
    error state and metrics are its own round's, bitwise."""
    from repro_torch import rng
    from repro_torch.core.schemes import (
        MACContext, get_scheme, round_simulated,
    )
    from repro_torch.experiments.engine import round_masked
    kw, axis, values = CHANNEL_ROUNDS[name]
    cfg = dataclasses.replace(_round_cfg("a_dsgd"), **kw)
    gen = _gen(dev, 17)
    grads = 0.01 * torch.randn(G, M_DEV, D_MODEL, generator=gen, device=dev)
    deltas = 0.01 * torch.randn(G, M_DEV, D_MODEL, generator=gen, device=dev)
    keys = rng.split(rng.PRNGKey(1003, dev), G)
    masks = (torch.rand(G, M_DEV, generator=gen, device=dev) > 0.3).float()
    one = [get_scheme(dataclasses.replace(cfg, **{axis: v}), D_MODEL, M_DEV,
                      device=dev) for v in values]
    if axis == "p_avg":
        ov = {"p_sched": torch.stack([s.p_sched for s in one])}
    else:
        ov = {axis: torch.stack([getattr(s, axis) for s in one])}
    grid = one[0].with_overrides(**ov)
    ctx = MACContext(m=M_DEV, use_kernel=True)

    def round_(sch, g, d, k, mk):
        if masked:
            return round_masked(sch, g, d, 1, k, mk, ctx)
        return round_simulated(sch, g, d, 1, k, ctx)

    gh, dl, met = round_(grid, grads, deltas, keys, masks)
    for p, sch in enumerate(one):
        gh1, dl1, met1 = round_(sch, grads[p].clone(), deltas[p].clone(),
                                keys[p].clone(), masks[p].clone())
        assert torch.equal(gh[p], gh1) and torch.equal(dl[p], dl1)
        assert set(met) == set(met1)
        for k in met1:
            assert torch.equal(met[k][p], met1[k]), k


@pytest.mark.parametrize("axis,values,kw", [
    ("csi_err_var", [0.0, 0.1, 0.4], dict(scheme="a_dsgd_csi_err")),
    ("n_subbands", [1.0, 2.0, 3.0],
     dict(scheme="a_dsgd", fading="rayleigh", geometry="disk",
          scheduler="prop_fair")),
])
def test_channel_grid_equals_run_compiled_on_card(dev, axis, values, kw):
    """A batched grid of a channel scalar equals each point's own run on
    the card, accuracies and losses bitwise; the kernels launch once a
    round for the whole grid."""
    from repro_torch.configs.base import OTAConfig
    from repro_torch.data import federated_split, make_classification
    from repro_torch.experiments import engine, sweep
    (xtr, ytr), (xte, yte) = make_classification(
        n_train=800, n_test=300, dim=48, noise=2.0, seed=3)
    xd, yd = federated_split(xtr, ytr, m=25, b=32, iid=True, seed=0)
    cfg = OTAConfig(s_frac=0.5, k_frac=0.25, p_avg=500.0, total_steps=6,
                    projection="blocked", block_size=64, use_kernel=True,
                    amp_iters=6, mean_removal_steps=2, **kw)
    grid = [{axis: v} for v in values]
    ce = engine.CompiledExperiment(xd, yd, xte, yte, engine.Experiment(
        cfg=cfg, steps=6, eval_every=2))
    ov, keys, _ = sweep.grid_inputs(ce, grid, 6)
    ops.reset_launches()
    outs = ce.run_grid(ov, keys)
    assert ops.launch_counts()["amp_fused"] == 6
    for g, point in enumerate(grid):
        one = engine.run_compiled(
            xd, yd, xte, yte, dataclasses.replace(cfg, **point),
            steps=6, lr=1e-3, eval_every=1)
        assert outs["acc"][g].cpu().numpy().tolist() == \
            one.all_accs.tolist()
        assert outs["loss"][g].cpu().numpy().tolist() == \
            one.all_losses.tolist()


# ---------------------------------------------------------------------------
# the robustness axis on the card
# ---------------------------------------------------------------------------


def _robust_site(name, dev):
    """``(fn, inputs)`` of one robust point-axis site at the sweep's shapes
    (G = 4 points of 25 devices, frames of 2 * 1024 + 2; digital frames of
    3925)."""
    from repro_torch import rng
    from repro_torch.robust import aggregators, faults
    gen = _gen(dev, 19)
    if name == "clip_frame_power":
        frames = torch.randn(G, M_DEV, S_TILDE + 2, generator=gen,
                             device=dev)
        frames[:, ::3] *= 20.0
        return (aggregators.clip_frame_power,
                (frames, torch.tensor([1.5, 2.0, 1.0, 3.0], device=dev)
                 * (S_TILDE + 2)))
    if name == "fault_draw":
        keys = rng.split(rng.PRNGKey(6, dev), G)
        fkey = faults.fault_base_key(0, dev)
        return (lambda k, a, b, c: faults.fault_draw(
                    fkey, k, M_DEV, byzantine_frac=a, fault_rate=b,
                    erasure_prob=c, fault_kind="stale")[:5],
                (keys, torch.tensor([0.0, 0.1, 0.3, 0.5], device=dev),
                 torch.tensor([0.1, 0.2, 0.0, 0.4], device=dev),
                 torch.tensor([0.3, 0.0, 0.1, 0.2], device=dev)))
    frames = torch.randn(G, M_DEV, 3925, generator=gen, device=dev)
    frames[1, 4] = float("nan")
    frames[2, 7] = float("inf")
    alive = torch.rand(G, M_DEV, generator=gen, device=dev) > 0.2
    m_eff = alive.float().sum(-1).clamp(min=1.0)
    return (lambda f, a, me, t, c: aggregators.robust_combine(
                f, a, me, aggregator=name, trim_frac=t, norm_cap=c),
            (frames, alive, m_eff,
             torch.tensor([0.1, 0.2, 0.25, 0.0], device=dev),
             torch.tensor([1.5, 1.0, 2.0, 1.5], device=dev)))


def _same_nan(a, b):
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(a[~nan], b[~nan]))


@pytest.mark.parametrize("value", [float("nan"), float("inf"),
                                   float("-inf")])
@pytest.mark.parametrize("points", [1, 4])
def test_amp_fused_nonfinite(dev, value, points):
    """A NaN or an Inf in block 0 of one point's y, at the main path's
    shape: the plain version's NaN pattern (the whole block) and its other
    entries bitwise; every clean block and point bitwise the clean
    decode."""
    nb, c, sb = 2, 4096, 1024
    gen = _gen(dev, 23)
    x = torch.zeros(points, nb, c, device=dev)
    for p in range(points):
        for b in range(nb):
            x[p, b, torch.randperm(c, generator=gen, device=dev)[:sb // 8]] \
                = torch.randn(sb // 8, generator=gen, device=dev)
    clean = (ref.ota_project_ref(x, 9, sb) + 0.01 * torch.randn(
        points, nb, sb, generator=gen, device=dev)).contiguous()
    bad = points // 2
    yb = clean.clone()
    yb[bad, 0, 100] = value
    if points == 1:
        yb, clean = yb[0], clean[0]
    out = amp_fused.amp_decode_fused(yb, 9, c, iters=20)
    want = amp_blocked_core(yb, 9, c, iters=20)
    ok = amp_fused.amp_decode_fused(clean, 9, c, iters=20)
    assert _same_nan(out, want)
    out, ok = out.reshape(points, nb, c), ok.reshape(points, nb, c)
    assert bool(torch.isnan(out[bad, 0]).all())
    keep = torch.ones(points, nb, dtype=torch.bool, device=dev)
    keep[bad, 0] = False
    assert torch.equal(out[keep], ok[keep])


def test_accuracy_over_nan_logits_on_card_equals_cpu(dev):
    """NaN weights after an unguarded poisoned round: argmax over NaN
    logits gives the CPU's (and jnp's) first-NaN index on the card too, so
    the accuracy is the CPU's bitwise."""
    from repro_torch.train import paper_repro as tpr
    cpu = torch.Generator().manual_seed(29)
    x = torch.randn(10000, 784, generator=cpu)
    y = torch.randint(0, 10, (10000,), generator=cpu)
    w = 0.01 * torch.randn(784, 10, generator=cpu)
    b = torch.zeros(10)
    for case in range(3):
        wc, bc = w.clone(), b.clone()
        if case == 0:
            wc[5, 3] = float("nan")     # NaN wherever x[:, 5] != 0
        elif case == 1:
            bc[7] = float("nan")        # column 7 NaN in every row
        else:
            wc[:] = float("nan")
        logits = x @ wc + bc
        assert torch.equal(logits.to(dev).argmax(-1).cpu(), logits.argmax(-1))
        p_cpu = {"w": wc, "b": bc}
        p_dev = {k: v.to(dev) for k, v in p_cpu.items()}
        assert torch.equal(tpr.accuracy(p_dev, x.to(dev), y.to(dev)).cpu(),
                           tpr.accuracy(p_cpu, x, y))


#: a batched robust round: (config fields, the (G,) axis, its values)
ROBUST_ROUNDS = {
    "analog_capped": (dict(scheme="a_dsgd", robust=True, byz_scale=20.0,
                           clip_power=True, fault_kind="nan",
                           fault_rate=0.1), "byzantine_frac",
                      (0.0, 0.1, 0.3, 0.5)),
    "analog_dropout": (dict(scheme="a_dsgd", robust=True,
                            fault_kind="dropout", byzantine_frac=0.1),
                       "fault_rate", (0.0, 0.1, 0.3, 0.5)),
    "digital_norm_cap": (dict(scheme="d_dsgd", robust=True,
                              aggregator="norm_cap", byz_scale=20.0,
                              erasure_prob=0.1), "byzantine_frac",
                         (0.0, 0.1, 0.3, 0.5)),
    "digital_trimmed": (dict(scheme="d_dsgd", robust=True,
                             aggregator="trimmed_mean", byzantine_frac=0.3,
                             fault_kind="stale", fault_rate=0.2),
                        "trim_frac", (0.0, 0.1, 0.2, 0.3)),
}


@pytest.mark.parametrize("name", list(ROBUST_ROUNDS))
def test_point_axis_robust_round_on_card(dev, name):
    """One batched robust round (``round_masked``, a mask per point) at the
    sweep's shapes with a ``(G,)`` robust scalar: each point's ghat, error
    state and metrics are its own round's, bitwise, NaN for NaN."""
    from repro_torch import rng
    from repro_torch.core.schemes import MACContext, get_scheme
    from repro_torch.experiments.engine import round_masked
    kw, axis, values = ROBUST_ROUNDS[name]
    cfg = dataclasses.replace(_round_cfg("a_dsgd"), **kw)
    gen = _gen(dev, 31)
    grads = 0.01 * torch.randn(G, M_DEV, D_MODEL, generator=gen, device=dev)
    deltas = 0.01 * torch.randn(G, M_DEV, D_MODEL, generator=gen, device=dev)
    keys = rng.split(rng.PRNGKey(1005, dev), G)
    masks = (torch.rand(G, M_DEV, generator=gen, device=dev) > 0.2).float()
    one = [get_scheme(dataclasses.replace(cfg, **{axis: v}), D_MODEL, M_DEV,
                      device=dev) for v in values]
    ov = {axis: torch.stack([getattr(s, axis) for s in one])}
    if hasattr(one[0], "q_sched"):
        ov["q_sched"] = torch.stack([s.q_sched for s in one])
    grid = one[0].with_overrides(**ov)
    ctx = MACContext(m=M_DEV, use_kernel=cfg.use_kernel)
    gh, dl, met = round_masked(grid, grads, deltas, 1, keys, masks, ctx)
    for p, sch in enumerate(one):
        gh1, dl1, met1 = round_masked(sch, grads[p].clone(),
                                      deltas[p].clone(), 1, keys[p].clone(),
                                      masks[p].clone(), ctx)
        assert _same_nan(gh[p], gh1) and _same_nan(dl[p], dl1)
        assert set(met) == set(met1)
        for k in met1:
            assert _same_nan(met[k][p], met1[k]), k


def test_guarded_robust_grid_equals_run_compiled_on_card(dev):
    """A guarded grid over the fault rate (NaN frames) and a sweep over
    byzantine_frac x clip_power equal each point's own run on the card,
    accuracies, losses and the guard's column bitwise; the kernels launch
    once a round for each group."""
    from repro_torch.configs.base import OTAConfig
    from repro_torch.data import federated_split, make_classification
    from repro_torch.experiments import engine, sweep
    from repro_torch.robust import GuardConfig
    (xtr, ytr), (xte, yte) = make_classification(
        n_train=800, n_test=300, dim=48, noise=2.0, seed=3)
    xd, yd = federated_split(xtr, ytr, m=25, b=32, iid=True, seed=0)
    cfg = OTAConfig(scheme="a_dsgd", s_frac=0.5, k_frac=0.25, p_avg=500.0,
                    total_steps=6, projection="blocked", block_size=64,
                    use_kernel=True, amp_iters=6, mean_removal_steps=2,
                    fault_kind="nan", robust=True)
    guard = GuardConfig()
    ce = engine.CompiledExperiment(xd, yd, xte, yte, engine.Experiment(
        cfg=cfg, steps=6, eval_every=1, guard=guard))
    grid = [{"fault_rate": r} for r in (0.0, 0.05, 0.2)]
    ov, keys, _ = sweep.grid_inputs(ce, grid, 6)
    ops.reset_launches()
    outs = ce.run_grid(ov, keys)
    assert ops.launch_counts()["amp_fused"] == 6
    for g, point in enumerate(grid):
        one = engine.run_compiled(xd, yd, xte, yte,
                                  dataclasses.replace(cfg, **point),
                                  steps=6, eval_every=1, guard=guard)
        assert outs["loss"][g].cpu().numpy().tolist() == \
            one.all_losses.tolist()
        assert outs["metrics"]["guard_skipped"][g].cpu().tolist() == \
            [m["guard_skipped"] for m in one.metrics]
    base = dataclasses.replace(cfg, robust=False, fault_kind="nan",
                               byz_scale=20.0)
    ops.reset_launches()
    res = sweep.run_sweep((xd, yd), (xte, yte), base,
                          {"byzantine_frac": [0.0, 0.3],
                           "clip_power": [False, True]}, steps=6,
                          eval_every=2)
    assert ops.launch_counts()["amp_fused"] == 12
    for rec in res.records:
        one = engine.run_compiled(xd, yd, xte, yte, dataclasses.replace(
            base, robust=True, byzantine_frac=rec["byzantine_frac"],
            clip_power=rec["clip_power"]), steps=6, eval_every=2)
        assert rec["accs"] == one.accs and rec["losses"] == one.losses


# ---------------------------------------------------------------------------
# the local-compute axis and the population engine on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [20, 64])
def test_kernels_at_cohort_widths_bitwise(dev, m):
    """Fig. 12's 20 devices (a partial device tile) and Fig. 10's K = 64
    (eight full tiles) at the main path's shapes: ota_project (Rademacher,
    2 x 4096 -> 1024) and ef_sparsify (m x 7850) bitwise with their plain
    versions."""
    gen = _gen(dev, 100 + m)
    x = torch.randn(m, 2, 4096, generator=gen, device=dev)
    seed = torch.tensor(4242, dtype=torch.int64, device=dev)
    y = ota_project.ota_project(x, seed, 1024, True)
    assert torch.equal(y, ref.ota_project_ref(x, seed, 1024, True))
    g = torch.randn(m, 7850, generator=gen, device=dev)
    d = torch.randn(m, 7850, generator=gen, device=dev)
    tau = torch.rand(m, generator=gen, device=dev)
    sp, nd = ef_sparsify.ef_sparsify(g, d, tau)
    sr, dr = ref.ef_sparsify_ref(g, d, tau)
    assert torch.equal(sp, sr) and torch.equal(nd, dr)


def _local_data(m=20, b=50, dim=48):
    from repro_torch.data import federated_split, make_classification
    (xtr, ytr), (xte, yte) = make_classification(
        n_train=2000, n_test=300, dim=dim, noise=2.0, seed=3)
    xd, yd = federated_split(xtr, ytr, m=m, b=b, kind="dirichlet",
                             beta=0.25, seed=0)
    return xd, yd, xte, yte


def test_local_e1_pin_on_card(dev):
    """sgd compiled for 2 epochs and run at E = 1 is device_grads bitwise
    on the card, and each algorithm's cut epoch leaves its carry
    untouched."""
    from repro_torch.configs.base import OTAConfig
    from repro_torch.local import get_local, local_device_grads
    from repro_torch.train.paper_repro import device_grads, flat_grad_fn
    xd, yd, _, _ = _local_data()
    gen = _gen(dev, 5)
    params = {"w": 0.1 * torch.randn(48, 10, generator=gen, device=dev),
              "b": 0.1 * torch.randn(10, generator=gen, device=dev)}
    x, y = torch.as_tensor(xd, device=dev), torch.as_tensor(yd,
                                                            device=dev).long()
    gf = flat_grad_fn(params)
    for algo in ("sgd", "fedavg", "fedprox", "feddyn"):
        cfg = OTAConfig(local=algo, local_epochs=2, prox_mu=0.5,
                        dyn_alpha=0.1)
        lw2 = get_local(cfg, 0.6, device=dev).with_overrides(
            local_epochs=1.0)
        lw1 = get_local(dataclasses.replace(cfg, local_epochs=1), 0.6,
                        device=dev)
        duals = torch.zeros(20, 490, device=dev) if lw2.has_dual else None
        a = local_device_grads(lw2, gf, params, x, y, None, duals)
        b = local_device_grads(lw1, gf, params, x, y, None, duals)
        assert torch.equal(a[0], b[0]), algo
        if algo == "sgd":
            assert torch.equal(a[0], device_grads(params, x, y, None)[0])


def test_local_points_each_their_own_on_card(dev):
    """G = 3 points of FedDyn (E and alpha per point): each point's deltas
    and duals are its own call's, bitwise, on the card."""
    from repro_torch.configs.base import OTAConfig
    from repro_torch.local import get_local, local_device_grads
    from repro_torch.train.paper_repro import flat_grad_fn
    xd, yd, _, _ = _local_data()
    x, y = torch.as_tensor(xd, device=dev), torch.as_tensor(yd,
                                                            device=dev).long()
    gen = _gen(dev, 6)
    ps = {"w": 0.1 * torch.randn(3, 48, 10, generator=gen, device=dev),
          "b": 0.1 * torch.randn(3, 10, generator=gen, device=dev)}
    duals = 0.01 * torch.randn(3, 20, 490, generator=gen, device=dev)
    lw = get_local(OTAConfig(local="feddyn", local_epochs=4), 0.6,
                   device=dev)
    e, al = [1.0, 4.0, 2.0], [0.1, 0.0, 0.3]
    gf = flat_grad_fn({k: v[0] for k, v in ps.items()})
    got, _, gd = local_device_grads(lw.with_overrides(
        local_epochs=e, dyn_alpha=al), gf, ps, x, y, None, duals)
    for g in range(3):
        want, _, wd = local_device_grads(
            lw.with_overrides(local_epochs=e[g], dyn_alpha=al[g]), gf,
            {k: v[g].clone() for k, v in ps.items()}, x, y, None,
            duals[g].clone())
        assert torch.equal(got[g], want) and torch.equal(gd[g], wd)


@pytest.mark.parametrize("algo", ["fedavg", "fedprox", "feddyn"])
def test_local_grid_equals_run_compiled_on_card(dev, algo):
    """A local_epochs grid on the kernel path equals each point's own
    run_compiled on the card, bitwise."""
    from repro_torch.configs.base import OTAConfig
    from repro_torch.experiments import engine, run_sweep
    xd, yd, xte, yte = _local_data()
    cfg = OTAConfig(scheme="a_dsgd", s_frac=0.5, k_frac=0.25,
                    p_avg=50000.0, total_steps=6, projection="blocked",
                    block_size=64, rademacher=True, use_kernel=True,
                    amp_iters=6, mean_removal_steps=2, local=algo,
                    prox_mu=0.5, dyn_alpha=0.1)
    res = run_sweep((xd, yd), (xte, yte), cfg, {"local_epochs": [1, 2, 4]},
                    steps=6, eval_every=2, local_lr=0.6)
    for rec in res.records:
        one = engine.run_compiled(xd, yd, xte, yte, dataclasses.replace(
            cfg, local_epochs=rec["local_epochs"]), steps=6, eval_every=2,
            local_lr=0.6)
        assert rec["accs"] == one.accs and rec["losses"] == one.losses


def test_population_pieces_on_card_equal_cpu(dev):
    """The sampler (Gumbel scores, the stable sort with ties at -inf),
    availability, latencies, the banks' gather and scatter with
    collisions, and the edge-site MAC: the CPU's bits on the card."""
    from repro_torch import rng
    from repro_torch.population import churn, hierarchy, state, stragglers
    from repro_torch.population.sampler import sample_cohort
    avail = torch.from_numpy(np.random.RandomState(0).rand(3, 5000) < 0.002)
    keys = rng.split(rng.PRNGKey(8), 3)
    want = sample_cohort(keys, avail, 16)
    got = sample_cohort(keys.to(dev), avail.to(dev), 16)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    arr, dep = churn.init_arrival_departure(rng.PRNGKey(1), 5000, 30, 0.4,
                                            9.0)
    av = churn.availability(arr, dep, 7, keys, torch.tensor([0.5, 0.9, 1.0]))
    av_dev = churn.availability(arr.to(dev), dep.to(dev), 7, keys.to(dev),
                                torch.tensor([0.5, 0.9, 1.0], device=dev))
    assert torch.equal(av_dev.cpu(), av)
    speed = stragglers.init_speed(rng.PRNGKey(2), 64, 0.5)
    assert torch.equal(stragglers.init_speed(rng.PRNGKey(2, dev), 64,
                                             0.5).cpu(), speed)
    assert torch.equal(stragglers.latencies(keys.to(dev),
                                            speed.to(dev)).cpu(),
                       stragglers.latencies(keys, speed))
    banks = state.init_banks(24, 5, 7, device="cpu", points=3)
    bdev = state.init_banks(24, 5, 7, device=dev, points=3)
    rs = np.random.RandomState(3)
    for _ in range(4):
        cohort = torch.from_numpy(np.sort(np.stack([
            rs.choice(90, 12, replace=False) for _ in range(3)]), axis=-1))
        vals = torch.from_numpy(rs.randn(3, 12, 7).astype(np.float32))
        banks = state.scatter_cohort(banks, cohort, vals)
        bdev = state.scatter_cohort(bdev, cohort.to(dev), vals.to(dev))
        assert torch.equal(bdev.deltas.cpu(), banks.deltas)
        assert torch.equal(bdev.owner.cpu(), banks.owner)
        assert torch.equal(state.gather_cohort(bdev, cohort.to(dev)).cpu(),
                           state.gather_cohort(banks, cohort))
    frames = torch.from_numpy(rs.randn(3, 64, 2050).astype(np.float32))
    sites = torch.from_numpy(rs.randint(0, 4, (3, 64)))
    sc = torch.tensor([1.0, 2.0, 0.5])
    for trim in (0.0, 0.25):
        want = hierarchy.site_mac_sum(frames, sites, 4, keys, 1.0, sc, sc,
                                      site_trim_frac=trim)
        got = hierarchy.site_mac_sum(frames.to(dev), sites.to(dev), 4,
                                     keys.to(dev), 1.0, sc.to(dev),
                                     sc.to(dev), site_trim_frac=trim)
        assert torch.equal(got.cpu(), want)


def _pool(m_total, b):
    from repro_torch.data import make_classification
    from repro_torch.data.partition import population_partition
    (xtr, ytr), (xte, yte) = make_classification(
        n_train=4000, n_test=300, dim=48, noise=2.0, seed=0)
    return xtr, ytr, xte, yte, population_partition(ytr, m=m_total, b=b,
                                                    kind="iid", seed=0)


def _pop_cfg(**kw):
    from repro_torch.configs.base import OTAConfig
    return OTAConfig(scheme="a_dsgd", s_frac=0.5, k_frac=0.25, p_avg=500.0,
                     total_steps=6, projection="blocked", block_size=64,
                     rademacher=True, use_kernel=True, amp_iters=6,
                     mean_removal_steps=2, **kw)


def test_population_full_cohort_is_run_compiled_on_card(dev):
    """K == M: run_population is run_compiled bitwise on the card, and the
    kernels launch once a round."""
    from repro_torch import population as tpop
    from repro_torch.data import federated_split, make_classification
    from repro_torch.experiments import engine
    (xtr, ytr), (xte, yte) = make_classification(
        n_train=800, n_test=300, dim=48, noise=2.0, seed=3)
    xd, yd = federated_split(xtr, ytr, m=25, b=32, iid=True, seed=0)
    for kw in ({}, dict(local="feddyn", local_epochs=2, dyn_alpha=0.2)):
        cfg = _pop_cfg(**kw)
        ops.reset_launches()
        pop = tpop.run_population(
            tpop.PopulationData.from_dense(xd, yd), xte, yte, cfg,
            tpop.PopulationConfig(m_total=25, k_cohort=25), steps=6,
            eval_every=1)
        assert ops.launch_counts()["amp_fused"] == 6
        one = engine.run_compiled(xd, yd, xte, yte, cfg, steps=6,
                                  eval_every=1)
        assert pop.all_losses.tolist() == one.all_losses.tolist()
        for k in one.params:
            assert torch.equal(pop.params[k], one.params[k])


def test_population_grid_equals_runs_on_card(dev):
    """An avail_rate x k_active grid over a sampled population (churn,
    stragglers and two sites on) equals each point's own run_population
    on the card, bitwise."""
    from repro_torch import population as tpop
    from repro_torch.experiments import run_population_sweep
    xtr, ytr, xte, yte, part = _pool(3000, 16)
    pdata = tpop.PopulationData.from_pool(xtr, ytr, part)
    cfg = _pop_cfg()
    pop = tpop.PopulationConfig(m_total=3000, k_cohort=64, capacity=512,
                                speed_sigma=0.5, straggler_deadline=3.0,
                                n_sites=2)
    res = run_population_sweep(pdata, (xte, yte), cfg, pop,
                               {"avail_rate": [0.5, 1.0],
                                "k_active": [32, 64]}, steps=6,
                               eval_every=2)
    for rec in res.records:
        one = tpop.run_population(pdata, xte, yte, cfg, dataclasses.replace(
            pop, avail_rate=rec["avail_rate"]), steps=6, eval_every=2) \
            if rec["k_active"] == 64 else None
        if one is not None:
            assert rec["accs"] == one.accs and rec["losses"] == one.losses
    # a k_active point is its own runner's run with the override
    from repro_torch.experiments import engine
    exp = tpop.PopulationExperiment(cfg=cfg, pop=pop, steps=6, eval_every=2)
    cp = tpop.CompiledPopulation(pdata, xte, yte, exp)
    own = cp.run({"k_active": 32.0, "avail_rate": 0.5},
                 engine.round_keys(6, 0, dev))
    rec = res.record(avail_rate=0.5, k_active=32)
    idx = engine.eval_indices(6, 2)
    assert rec["losses"] == own["loss"].cpu().numpy()[idx].tolist()


# ---------------------------------------------------------------------------
# the sharded slice drivers: the kernels at one rank's shapes, per rank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shard", [0, 1])
def test_ota_project_one_shard_block_bitwise(dev, shard):
    """One rank's projection in sharded_round at full width: 1 row x 1
    block, 4096 -> 1024, with the shard-folded seed; bitwise the plain
    version and the slice driver's plain chunked projection."""
    from repro_torch.core import distributed
    seed = int(ref.splitmix32(ref.as_u32(0) ^ ref.as_u32(shard)))
    x = torch.randn(1, 4096, generator=_gen(dev, 40 + shard), device=dev)
    x = torch.where(x.abs() > 1.2, x, 0.0)
    before = _launches("ota_project")
    y = ota_project.ota_project(x, seed, 1024)
    assert _launches("ota_project") == before + 1
    assert torch.equal(y, ref.ota_project_ref(x, seed, 1024))
    assert torch.equal(y, distributed.proj_forward(x, seed, 1024, 8))


@pytest.mark.parametrize("offset", [1, 7, 24])
def test_amp_fused_one_block_at_offset_bitwise(dev, offset):
    """shard_decode's one-block decode with the global block id: a noisy
    block and a padded all-zero block, bitwise the plain version."""
    from repro_torch.core.amp import amp_blocked_core
    seed = 12345
    gen = _gen(dev, offset)
    x = torch.zeros(1, 4096, device=dev)
    idx = torch.randperm(4096, generator=gen, device=dev)[:128]
    x[0, idx] = torch.randn(128, generator=gen, device=dev)
    A = ref.block_matrix_ref(seed, torch.tensor([offset], device=dev), 1024,
                             4096)
    y = ref.contract("isc,ic->is", A, x) + 0.01 * torch.randn(
        1, 1024, generator=gen, device=dev)
    for yb in (y, torch.zeros_like(y)):
        got = amp_fused.amp_decode_fused(yb, seed, 4096, iters=20,
                                         id_offset=offset)
        want = amp_blocked_core(yb, seed, 4096, 20, id_offset=offset)
        assert torch.equal(got, want)
    assert float((got - x).norm()) >= 0.0


def _sharded_inputs(dev, m, d_pad):
    gen = _gen(dev, m * 31)
    g = torch.randn(m, d_pad, generator=gen, device=dev) * 0.05
    g[:, 7850:] = 0.0
    return g, torch.zeros_like(g)


@pytest.mark.parametrize("shard_decode", [False, True])
def test_sharded_round_kernels_bitwise_plain_on_card(dev, shard_decode):
    """A 4 x 2 thread mesh at full width (d_pad 8192, one 4096 block per
    shard): with the kernels bitwise the plain run on the card, the
    shard_decode run bitwise the full decode, and each rank launching
    ef_sparsify, ota_project and amp_fused once (8 of each)."""
    from repro_torch import rng as trng
    from repro_torch.configs.base import ota_overrides
    from repro_torch.core import distributed
    from repro_torch.core.schemes import MACContext, get_scheme
    from repro_torch.sharding import Mesh, P, shard_map
    g, dl = _sharded_inputs(dev, 4, 8192)
    mesh = Mesh((4, 2), ("dev", "shard"))
    out = {}
    for uk, sd in ((True, shard_decode), (False, shard_decode),
                   (True, not shard_decode)):
        cfg = dataclasses.replace(ota_overrides("mnist_mlp"), use_kernel=uk,
                                  amp_iters=20, total_steps=20)
        sch = get_scheme(cfg, 7850, 4, device=dev)
        ctx = MACContext(m=4, device_axes=("dev",), shard_axes=("shard",),
                         d_pad=8192, use_kernel=uk, shard_decode=sd)

        def body(g, dl, sch=sch, ctx=ctx):
            ghat, nd, _ = distributed.sharded_round(
                sch, g.reshape(-1), dl.reshape(-1), 0,
                trng.PRNGKey(1000, device=dev), ctx)
            return ghat, nd.reshape(1, -1)

        ops.reset_launches()
        out[uk, sd] = shard_map(body, mesh, (P("dev", "shard"),) * 2,
                                (P("shard"), P("dev", "shard")))(g, dl)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert counts == ({"ef_sparsify": 8, "ota_project": 8,
                           "ota_project_t": 0, "amp_fused": 8} if uk else
                          {"ef_sparsify": 0, "ota_project": 0,
                           "ota_project_t": 0, "amp_fused": 0}), counts
    for a, b in zip(out[True, shard_decode], out[False, shard_decode]):
        assert torch.equal(a, b)
    for a, b in zip(out[True, shard_decode], out[True, not shard_decode]):
        assert torch.equal(a, b)
    assert torch.isfinite(out[True, shard_decode][0]).all()


def test_round_sharded_kernels_bitwise_plain_on_card(dev):
    """round_sharded on 4 rank threads at the slice's width (d = 7850, two
    blocks): one launch of each main-path kernel per rank, bitwise the
    plain run."""
    from repro_torch import rng as trng
    from repro_torch.configs.base import ota_overrides
    from repro_torch.core.schemes import MACContext, get_scheme, round_sharded
    from repro_torch.sharding import Mesh, P, shard_map
    g, dl = _sharded_inputs(dev, 4, 7850)
    out = {}
    for uk in (True, False):
        cfg = dataclasses.replace(ota_overrides("mnist_mlp"), use_kernel=uk,
                                  amp_iters=20, total_steps=20)
        sch = get_scheme(cfg, 7850, 4, device=dev)
        ctx = MACContext(m=4, device_axes=("dev",), use_kernel=uk)

        def body(g, dl, sch=sch, ctx=ctx):
            ghat, nd, _ = round_sharded(sch, g.reshape(-1), dl.reshape(-1),
                                        0, trng.PRNGKey(1000, device=dev),
                                        ctx)
            return ghat, nd.reshape(1, -1)

        ops.reset_launches()
        out[uk] = shard_map(body, Mesh((4,), ("dev",)), (P("dev"),) * 2,
                            (P(), P("dev")))(g, dl)
        torch.cuda.synchronize()
        n = 4 if uk else 0
        assert ops.launch_counts() == {"ef_sparsify": n, "ota_project": n,
                                       "ota_project_t": 0, "amp_fused": n}
    for a, b in zip(out[True], out[False]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the streamed federated LLM round: the kernels at a chunk's shapes, and a
# reduced model's round through the kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_blocks", [4, 1024])
def test_kernels_at_streamed_chunk_shapes_bitwise(dev, n_blocks):
    """A 2**14 and a 2**22 chunk of ``ota_overrides`` (c 4096, s 1024) for
    4 devices: ef_sparsify on 4 x chunk, ota_project on 4 x n_blocks x
    4096 -> 1024 and amp_fused on n_blocks blocks, each bitwise its plain
    version (the projection's plain products make A eight blocks at a
    time, as the scheme's plain path does on the card)."""
    from repro_torch.core.amp import amp_blocked_core
    from repro_torch.core.compression import sampled_topk_threshold
    from repro_torch.core.projection import BlockedProjector
    c, s, m = 4096, 1024, 4
    gen = _gen(dev, n_blocks)
    g = torch.randn(m, n_blocks * c, generator=gen, device=dev) * 0.01
    d = torch.randn(m, n_blocks * c, generator=gen, device=dev) * 0.003
    tau = sampled_topk_threshold(g + d, n_blocks * s // 2)
    before = (_launches("ef_sparsify"), _launches("ota_project"),
              _launches("amp_fused"))
    sp, nd = ef_sparsify.ef_sparsify(g, d, tau)
    assert all(torch.equal(a, b) for a, b in
               zip((sp, nd), ref.ef_sparsify_ref(g, d, tau)))
    proj = BlockedProjector(d=n_blocks * c, block_size=c, s_block=s, seed=0)
    xb = sp.reshape(m, n_blocks, c)
    y = ota_project.ota_project(xb, 0, s)
    assert torch.equal(y, proj.project_blocks(xb))
    yb = y.sum(0) + 0.01 * torch.randn(n_blocks, s, generator=gen,
                                       device=dev)
    got = amp_fused.amp_decode_fused(yb, 0, c, iters=20)
    assert torch.equal(got, amp_blocked_core(yb, 0, c, 20))
    assert (_launches("ef_sparsify"), _launches("ota_project"),
            _launches("amp_fused")) == tuple(b + 1 for b in before)


def test_fedllm_round_on_card_bitwise_plain(dev):
    """A reduced smollm ``CompiledFedLLM`` round (Rademacher blocks of 256,
    25 chunks): through the kernels bitwise its use_kernel=False run on
    the card, with exactly one launch of each main-path kernel per chunk
    and none in the plain run."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OTAConfig, TrainConfig
    from repro_torch.convert import tree_leaves
    from repro_torch.experiments.engine import round_keys
    from repro_torch.train.fedllm import CompiledFedLLM
    out = {}
    for uk in (True, False):
        fed = CompiledFedLLM(
            get_config("smollm_360m").reduced(),
            TrainConfig(compute_dtype="float32", warmup_steps=0),
            OTAConfig(projection="blocked", s_frac=0.25, k_frac=0.5,
                      block_size=256, rademacher=True, use_kernel=uk),
            m=3, batch=2, seq_len=8, device=dev)
        assert fed.n_chunks == 25
        ops.reset_launches()
        carry, outs = fed.run_segment({}, round_keys(1, 0, device=dev), None,
                                      fed.carry0(), 0)
        torch.cuda.synchronize()
        n = fed.n_chunks if uk else 0
        assert ops.launch_counts() == {"ef_sparsify": n, "ota_project": n,
                                       "ota_project_t": 0, "amp_fused": n}
        out[uk] = (carry, outs)
    (ck, ok), (cp, op) = out[True], out[False]
    assert torch.equal(ck[2], cp[2])
    for a, b in zip(tree_leaves(ck[0]), tree_leaves(cp[0])):
        assert torch.equal(a, b)
    assert torch.equal(ok["loss"], op["loss"])
    for k in ok["metrics"]:
        assert torch.equal(ok["metrics"][k], op["metrics"][k])
    assert torch.isfinite(ok["loss"]).all()


# ---------------------------------------------------------------------------
# the models on the card against the CPU port
# ---------------------------------------------------------------------------

#: the ten zoo archs (tests/test_torch_models.py holds the CPU port against
#: the reference at these bars)
MODEL_ARCHS = ("smollm_360m", "qwen3_8b", "yi_34b", "mistral_large_123b",
               "qwen2_vl_7b", "whisper_base", "granite_moe_1b_a400m",
               "granite_moe_3b_a800m", "rwkv6_3b", "zamba2_7b")
F32_LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
BF16_LOSS_RTOL = 1e-3
#: tests/test_torch_models.py's ``GRAD_GAPS``: the archs whose gradients
#: cancel below the absolute bar in places, with the count of entries that
#: may leave it (None: any) and each one's bound as a multiple of its
#: leaf's largest magnitude
GRAD_GAPS = {"rwkv6_3b": (8, 5e-6), "zamba2_7b": (None, 5e-5)}


def _model_batch(cfg, seed, B=2, L=12):
    """tests/test_torch_models.py's batch: tokens, and the vision or audio
    inputs of the configs that take them, from a numpy seed."""
    r = np.random.default_rng(seed)
    b = {"tokens": r.integers(0, cfg.vocab, (B, L)).astype(np.int32)}
    if cfg.mrope_sections is not None:
        P = cfg.n_vision_tokens
        b["extra"] = (0.02 * r.standard_normal((B, P, cfg.d_model))).astype(
            np.float32)
        b["positions"] = np.broadcast_to(
            np.arange(P + L)[None, :, None], (B, P + L, 3)).astype(np.int32)
    if cfg.encoder is not None:
        b["frames"] = (0.02 * r.standard_normal(
            (B, cfg.encoder.n_frames, cfg.encoder.d_model))).astype(
                np.float32)
    return b


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_model_on_card_matches_cpu(dev, arch):
    """The reduced config's seeded weights and one batch on the card and on
    the CPU: the float32 loss within 1e-5 relative and its gradient within
    rtol 1e-4 / atol 1e-6 (remat on; ``GRAD_GAPS`` for rwkv6 and zamba2),
    the bfloat16 loss within 1e-3 relative -- the CPU port's bars against
    the reference.  Prints the measured gaps."""
    from repro_torch import rng
    from repro_torch.configs import get_config
    from repro_torch.convert import to_torch, tree_leaves, tree_map
    from repro_torch.models import model as tmodel
    cfg = get_config(arch).reduced()
    params = tmodel.init_params(cfg, rng.PRNGKey(0, device="cpu"))
    batch = _model_batch(cfg, 1)

    def run(device, dtype):
        p = tree_map(lambda a: a.detach().clone().to(device).requires_grad_(
            dtype == torch.float32), params)
        loss, _ = tmodel.loss_fn(p, cfg, to_torch(batch, device),
                                 compute_dtype=dtype, remat=True)
        if dtype != torch.float32:
            return float(loss), None
        grads = torch.autograd.grad(loss, tree_leaves(p))
        return float(loss), [g.cpu() for g in grads]

    cpu_loss, cpu_grad = run("cpu", torch.float32)
    card_loss, card_grad = run(dev, torch.float32)
    cpu16, _ = run("cpu", torch.bfloat16)
    card16, _ = run(dev, torch.bfloat16)
    flat = [torch.cat([g.reshape(-1) for g in gs]).numpy()
            for gs in (card_grad, cpu_grad)]
    out = np.abs(flat[0] - flat[1]) > GRAD_ATOL + GRAD_RTOL * np.abs(flat[1])
    scale_err = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                    for a, b in zip(card_grad, cpu_grad))
    print(f"\nmodel on card vs cpu {arch}: f32 loss rel "
          f"{abs(card_loss - cpu_loss) / abs(cpu_loss):.3e}, grad max abs "
          f"{float(np.abs(flat[0] - flat[1]).max()):.3e}, outside the bar "
          f"{int(out.sum())} of {out.size}, max per leaf scale "
          f"{scale_err:.3e}, bf16 loss rel "
          f"{abs(card16 - cpu16) / abs(cpu16):.3e}")
    np.testing.assert_allclose(card_loss, cpu_loss, rtol=F32_LOSS_RTOL)
    if arch not in GRAD_GAPS:
        np.testing.assert_allclose(flat[0], flat[1], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    else:
        count, scale_atol = GRAD_GAPS[arch]
        assert count is None or out.sum() <= count, int(out.sum())
        for a, b in zip(card_grad, cpu_grad):
            np.testing.assert_allclose(
                a.numpy(), b.numpy(), rtol=GRAD_RTOL,
                atol=max(GRAD_ATOL, scale_atol * float(b.abs().max())))
    np.testing.assert_allclose(card16, cpu16, rtol=BF16_LOSS_RTOL)


#: the serve path's bars of tests/test_torch_serve.py, each of a tensor's
#: largest magnitude: float32; bfloat16 largest and mean gap
DECODE_F32_BAR = 1e-5
DECODE_BF16_BAR, DECODE_BF16_MEAN_BAR = 4e-2, 8e-3


def _decode_gap(card: torch.Tensor, cpu: torch.Tensor) -> tuple:
    if not cpu.is_floating_point():
        assert torch.equal(card.cpu(), cpu)
        return 0.0, 0.0
    a, b = card.cpu().float(), cpu.float()
    scale = float(b.abs().max().clamp_min(1e-30))
    d = (a - b).abs()
    return float(d.max()) / scale, float(d.mean()) / scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_decode_on_card_matches_cpu(dev, arch, dtype):
    """The reduced config's seeded weights: a 4-token prefill and 3 greedy
    decode steps (``make_serve_step``) on the card and on the CPU, fed the
    same tokens; the logits and every cache leaf after each call within
    the CPU port's bars against the reference, the leaves' dtypes equal.
    Prints the measured gaps."""
    from repro_torch import rng
    from repro_torch.configs import get_config
    from repro_torch.convert import tree_leaves, tree_map
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as tmodel
    from repro_torch.models import transformer
    from repro_torch.train.serve import make_serve_step
    tdt = getattr(torch, dtype)
    cfg = get_config(arch).reduced()
    params = tmodel.init_params(cfg, rng.PRNGKey(0, device="cpu"))
    r = np.random.default_rng(2)
    prompt = torch.from_numpy(r.integers(0, cfg.vocab, (2, 4)).astype(
        np.int32))
    frames = None
    if cfg.encoder is not None:
        frames = torch.from_numpy((0.02 * r.standard_normal(
            (2, cfg.encoder.n_frames, cfg.encoder.d_model))).astype(
                np.float32))
    sides = {}
    for name, device in (("cpu", "cpu"), ("card", dev)):
        s = make_serve_step(cfg, make_local_mesh(), 2, 7, compute_dtype=tdt,
                            cache_dtype=tdt, device=device)
        p = s.publish(tree_map(lambda a: a.to(device), params))
        enc = (() if frames is None else (transformer.encode_audio(
            p, cfg, frames.to(device, tdt)),))
        sides[name] = (s, p, enc, s.init_cache(tdt))
    worst = [0.0, 0.0]
    tok = None
    for i in range(4):
        outs = {}
        for name, (s, p, enc, cache) in sides.items():
            if i == 0:
                lg, cache = s.prefill_fn(p, cache, prompt.to(s.device), *enc)
            else:
                lg, cache = s.decode_fn(p, cache, tok.to(s.device), 3 + i,
                                        *enc)
            sides[name] = (s, p, enc, cache)
            outs[name] = (lg, cache)
        tok = torch.argmax(outs["cpu"][0][:, -1], -1)[:, None].to(torch.int32)
        pairs = [(outs["card"][0], outs["cpu"][0])] + list(zip(
            tree_leaves(outs["card"][1]), tree_leaves(outs["cpu"][1])))
        for a, b in pairs:
            assert a.dtype == b.dtype and a.shape == b.shape
            top, mean = _decode_gap(a, b)
            worst = [max(worst[0], top), max(worst[1], mean)]
    print(f"\ndecode on card vs cpu {arch} {dtype}: largest {worst[0]:.3e}, "
          f"mean {worst[1]:.3e} of each tensor's largest magnitude")
    if dtype == "float32":
        assert worst[0] <= DECODE_F32_BAR
    else:
        assert worst[0] <= DECODE_BF16_BAR and worst[1] <= DECODE_BF16_MEAN_BAR


# ---------------------------------------------------------------------------
# the sharded trainer
# ---------------------------------------------------------------------------

#: tests/test_torch_trainer_steps.py's bars: losses 1e-5 relative, every
#: metric of step 0 1e-5, the frame's alpha, tau and frame_power after it
#: 1e-3; params within lr x steps, at most TRAINER_FLIPS past 1e-4
TRAINER_LOSS_RTOL, TRAINER_FRAME_RTOL, TRAINER_FLIPS = 1e-5, 1e-3, 400


@pytest.mark.parametrize("layout", ["flat", "sliced"])
def test_trainer_on_card_matches_cpu(dev, layout):
    """smollm-360m reduced, 3 steps on the 4 x 2 thread mesh with the
    kernels, on the card and on the CPU port (which
    ``tests/test_torch_trainer_steps.py`` holds against the reference), the
    reference's test settings and batches.  Prints the measured gaps."""
    from repro_torch import rng
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OTAConfig, TrainConfig
    from repro_torch.convert import ravel
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.sharding import Mesh
    from repro_torch.train import trainer
    arch = get_config("smollm_360m").reduced()
    ota = OTAConfig(scheme="a_dsgd", projection="blocked", block_size=512,
                    s_frac=0.25, k_frac=0.5, rademacher=True, p_avg=500.0,
                    total_steps=50, amp_iters=10, mean_removal_steps=3,
                    use_kernel=True)
    tc = TrainConfig(optimizer="adam", lr=1e-3, warmup_steps=0,
                     total_steps=50, compute_dtype="float32", remat=True)
    make = (trainer.make_train_step_sliced if layout == "sliced"
            else trainer.make_train_step)
    stream = TokenStream(arch.vocab, 32, 8, seed=0)
    runs = {}
    for name, device in (("cpu", "cpu"), ("card", dev)):
        ts = make(arch, tc, ota, Mesh((4, 2), ("data", "model")),
                  device=device)
        params, opt_state, delta = ts.init_state(rng.PRNGKey(0))
        fn = ts.jitted({"tokens": None})
        mets = []
        for step in range(3):
            params, opt_state, delta, met = fn(
                params, opt_state, delta, stream.batch_at(step), step,
                rng.PRNGKey(step))
            mets.append({k: float(v) for k, v in met.items()})
        runs[name] = (ravel(params).cpu(), mets)
    worst = 0.0
    for step, (a, b) in enumerate(zip(runs["card"][1], runs["cpu"][1])):
        assert set(a) == set(b)
        for k in a:
            rel = abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
            worst = max(worst, rel)
            bar = (TRAINER_FRAME_RTOL if step and k in ("alpha", "tau",
                                                        "frame_power")
                   else TRAINER_LOSS_RTOL)
            assert rel <= bar, (step, k, a[k], b[k])
    diff = (runs["card"][0] - runs["cpu"][0]).abs()
    print(f"\ntrainer on card vs cpu {layout}: metrics {worst:.3e} "
          f"relative, params {float(diff.max()):.3e}, "
          f"{int((diff > 1e-4).sum())} past 1e-4")
    assert float(diff.max()) <= 1e-3 * 3
    assert int((diff > 1e-4).sum()) <= TRAINER_FLIPS
