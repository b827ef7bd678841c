"""The CUDA kernels' split float64 sums, emulated on the CPU.

``csrc/amp_fused.cu`` spreads one AMP block over a cluster of K CTAs,
``csrc/ota_project.cu`` splits one block's columns over a cluster and its
warps, and ``csrc/ota_project_t.cu`` splits one column tile's rows over a
cluster.  Each cuts a float64 sum into partials and adds them in a fixed
order, which changes only the order of float64 adds; ``amp_fused``'s
Rademacher products also add groups of 4 entries first, through tables of
signed partial sums (``_amp_tables``).  Here each product of
the plain versions is cut into exactly the slices that
``repro_torch.kernels.layout`` gives the kernels, the partials are added in
the kernels' order, and the float32 result must equal the unsplit plain
version bitwise.  The emulation lives in this file, not in the package.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.amp import _sqrt_f32, amp_blocked_core, soft_threshold
from repro_torch.kernels import layout, ref


def _ordered(parts):
    """Partials added in the given order, starting from 0.0 as the kernels do."""
    total = torch.zeros_like(parts[0])
    for p in parts:
        total = total + p
    return total


def _amp_split(yb, seed, c, iters, rademacher=True, threshold_mult=1.3):
    """amp_blocked_core's decode with every float64 sum cut as the kernel
    cuts it: the adjoint by the G row segments, the forward product by the K
    CTAs' column slices, ||z||^2 and the debias dots by the K row slices."""
    n_blocks, s = yb.shape
    k = layout.amp_cluster_size(s, c)
    g = layout.amp_row_segments(s, c)
    cols, rows = layout.bounds(c, k), layout.bounds(s, k)
    segs = layout.bounds(s, g)
    A = ref.block_matrix_ref(seed, torch.arange(n_blocks), s, c,
                             rademacher).double()

    def adjoint(z):
        zd = z.double()
        return _ordered([torch.einsum("isc,is->ic", A[:, lo:hi], zd[:, lo:hi])
                         for lo, hi in segs]).float()

    def forward(x):
        xd = x.double()
        return _ordered([torch.einsum("isc,ic->is", A[:, :, lo:hi],
                                      xd[:, lo:hi])
                         for lo, hi in cols]).float()

    def dot(a, b):
        prod = a.double() * b.double()
        return _ordered([prod[:, lo:hi].sum(-1, keepdim=True)
                         for lo, hi in rows])

    sqrt_s = _sqrt_f32(s)
    x = torch.zeros((n_blocks, c), dtype=torch.float32)
    z = yb
    for _ in range(iters):
        sigma = torch.sqrt(dot(z, z)).float() / sqrt_s
        x = soft_threshold(x + adjoint(z), threshold_mult * sigma)
        onsager = z * ((x != 0.0).sum(dim=-1, keepdim=True) / s)
        z = yb - forward(x) + onsager
    ax = forward(x)
    factor = dot(ax, yb) / torch.clamp(dot(ax, ax), min=1e-12)
    return x * torch.clamp(factor.float(), 1.0, 2.0), (k, g)


def _table_sum(terms, groups):
    """Sum over the last axis of ``terms`` as ``amp_fused``'s table lookups
    add it: each group's entries in order, then the groups ascending from
    0.0 (a short group's padded entries add +0.0, which changes nothing)."""
    acc = torch.zeros_like(terms[..., 0])
    for lo, hi in groups:
        group = terms[..., lo]
        for i in range(lo + 1, hi):
            group = group + terms[..., i]
        acc = acc + group
    return acc


def _amp_tables(yb, seed, c, iters, threshold_mult=1.3):
    """The Rademacher kernel's decode with its products summed in the
    kernel's order: +-1 signs times x or z in float64, a table group of
    ``layout.AMP_GROUP`` entries first, then the groups ascending within a
    CTA's column slice (forward) or a row segment (adjoint), then the K
    slices in rank order or the G segments in segment order, and the
    scale applied once before the rounding to float32.  ||z||^2 and the
    debias dots are cut as in :func:`_amp_split`."""
    n_blocks, s = yb.shape
    col_groups = layout.amp_column_groups(s, c)
    row_groups = layout.amp_row_groups(s, c)
    rows = layout.bounds(s, layout.amp_cluster_size(s, c))
    scale = ref.entry_scale(s)
    A = ref.block_matrix_ref(seed, torch.arange(n_blocks), s, c)
    signs = torch.where(A > 0, 1.0, -1.0).double()

    def adjoint(z):
        terms = (signs * z.double()[:, :, None]).transpose(1, 2)
        return (_ordered([_table_sum(terms, groups) for groups in row_groups])
                * scale).float()

    def forward(x):
        terms = signs * x.double()[:, None, :]
        return (_ordered([_table_sum(terms, groups) for groups in col_groups])
                * scale).float()

    def dot(a, b):
        prod = a.double() * b.double()
        return _ordered([prod[:, lo:hi].sum(-1, keepdim=True)
                         for lo, hi in rows])

    sqrt_s = _sqrt_f32(s)
    x = torch.zeros((n_blocks, c), dtype=torch.float32)
    z = yb
    for _ in range(iters):
        sigma = torch.sqrt(dot(z, z)).float() / sqrt_s
        x = soft_threshold(x + adjoint(z), threshold_mult * sigma)
        onsager = z * ((x != 0.0).sum(dim=-1, keepdim=True) / s)
        z = yb - forward(x) + onsager
    ax = forward(x)
    factor = dot(ax, yb) / torch.clamp(dot(ax, ax), min=1e-12)
    return x * torch.clamp(factor.float(), 1.0, 2.0)


def _noisy_block_sparse(n_blocks, c, s, seed, rademacher=True):
    rs = np.random.RandomState(seed)
    x = np.zeros((n_blocks, c), np.float32)
    for b in range(n_blocks):
        x[b, rs.permutation(c)[:s // 8]] = rs.randn(s // 8)
    y = ref.ota_project_ref(torch.from_numpy(x), 777, s, rademacher)
    return y + torch.from_numpy(0.01 * rs.randn(n_blocks, s).astype(np.float32))


@pytest.mark.parametrize("n_blocks,s,c,want_k", [
    (2, 1024, 4096, 16),   # the main path's decode
    (3, 100, 1000, 2),     # ragged: column slices of 500, words of 32 + 20
])
def test_amp_split_sums_bitwise(n_blocks, s, c, want_k):
    yb = _noisy_block_sparse(n_blocks, c, s, seed=s + c)
    split, (k, g) = _amp_split(yb, 777, c, iters=20)
    assert k == want_k and k > 1 and g >= 1
    plain = amp_blocked_core(yb, 777, c, iters=20, use_kernel=False)
    assert torch.equal(split, plain)
    assert int((plain != 0).sum()) > 0


@pytest.mark.parametrize("n_blocks,s,c,last_col_group,last_row_group", [
    (2, 1024, 4096, 4, 4),   # the main path's decode
    (3, 100, 1000, 4, 4),    # 500-column slices, a last word of 20 columns
    (3, 102, 1002, 1, 2),    # 501-column slices end in a part group and a
                             # 21-column word; a 102-row segment
    (512, 32, 64, 4, 4),     # one-CTA clusters, eight 4-row segments
])
def test_amp_table_sums_bitwise(n_blocks, s, c, last_col_group,
                                last_row_group):
    """The Rademacher kernel's sums from tables of signed partial sums, in
    its order, give the plain version's float32 result bitwise; both padded
    edges are exercised where the widths are no multiple of 4."""
    assert layout.amp_column_groups(s, c)[-1][-1][1] - \
        layout.amp_column_groups(s, c)[-1][-1][0] == last_col_group
    assert layout.amp_row_groups(s, c)[-1][-1][1] - \
        layout.amp_row_groups(s, c)[-1][-1][0] == last_row_group
    yb = _noisy_block_sparse(n_blocks, c, s, seed=s + c)
    tables = _amp_tables(yb, 777, c, iters=20)
    plain = amp_blocked_core(yb, 777, c, iters=20, use_kernel=False)
    assert torch.equal(tables, plain)
    assert int((plain != 0).sum()) > 0


@pytest.mark.parametrize("s,c", [(1024, 4096), (100, 1000), (102, 1002),
                                 (32, 64), (256, 1024), (2048, 4096),
                                 (7, 4099)])
def test_amp_groups_cover_in_order(s, c):
    """``amp_fused``'s table groups cover every column slice and row
    segment once, in order, from the slice's or segment's first entry, all
    of ``AMP_GROUP`` entries but a slice's or segment's last."""
    for parts, slices in ((layout.amp_column_groups(s, c),
                           layout.bounds(c, layout.amp_cluster_size(s, c))),
                          (layout.amp_row_groups(s, c),
                           layout.bounds(s, layout.amp_row_segments(s, c)))):
        assert len(parts) == len(slices)
        for groups, (lo, hi) in zip(parts, slices):
            assert groups[0][0] == lo and groups[-1][1] == hi
            assert all(b == a2 for (_, b), (a2, _) in zip(groups, groups[1:]))
            assert all(b - a == layout.AMP_GROUP for a, b in groups[:-1])
            assert 1 <= groups[-1][1] - groups[-1][0] <= layout.AMP_GROUP
            assert [a for a, _ in groups] == list(
                range(lo, hi, layout.AMP_GROUP))


def test_ota_split_sums_bitwise():
    """The forward kernel's slicing at the main path's 25 devices x 2
    blocks x 4096 -> 1024: warp shares in warp order, then the cluster's
    CTAs in rank order."""
    m, n_blocks, c, s = 25, 2, 4096, 1024
    x = torch.from_numpy(np.random.RandomState(0).randn(m, n_blocks, c)
                         .astype(np.float32))
    A = ref.block_matrix_ref(12345, torch.arange(n_blocks), s, c).double()
    xd = x.double()
    slices = layout.ota_column_slices(c)
    assert len(slices) == 8 and all(len(r) == layout.OTA_WARPS for r in slices)
    split = _ordered([
        _ordered([torch.einsum("bsc,mbc->mbs", A[:, :, lo:hi], xd[..., lo:hi])
                  for lo, hi in warps])
        for warps in slices]).float()
    assert torch.equal(split, ref.ota_project_ref(x, 12345, s))


def test_layout_slices_cover_in_order():
    for n, parts in [(4096, 16), (1000, 2), (1024, 16), (7, 3), (5, 8)]:
        b = layout.bounds(n, parts)
        assert b[0][0] == 0 and b[-1][1] == n
        assert all(hi == lo2 for (_, hi), (lo2, _) in zip(b, b[1:]))
        widths = {hi - lo for lo, hi in b}
        assert max(widths) - min(widths) <= 1
    for c in (64, 1000, 4096, 10007):
        flat = [w for r in layout.ota_column_slices(c) for w in r]
        assert flat[0][0] == 0 and flat[-1][1] == c
        assert all(hi == lo2 for (_, hi), (lo2, _) in zip(flat, flat[1:]))


@pytest.mark.parametrize("s,c,k", [(1024, 4096, 16), (256, 1024, 4),
                                   (100, 1000, 2), (128, 256, 1),
                                   (32, 64, 1), (4, 8192, 4)])
def test_amp_cluster_size(s, c, k):
    """K depends on the block's shape only; every CTA keeps >= 256 columns
    and >= 1 row, and the adjoint's G row segments fit the CTA's warps."""
    assert layout.amp_cluster_size(s, c) == k
    assert c // k >= layout.AMP_MIN_COLUMNS or k == 1
    g = layout.amp_row_segments(s, c)
    assert 1 <= g <= s and g * layout.amp_words(s, c) <= max(
        layout.AMP_WARPS, layout.amp_words(s, c))


@pytest.mark.parametrize("m,groups,sizes", [
    (1, 1, {1}), (3, 1, {3}), (8, 1, {8}), (25, 4, {6, 7}), (33, 5, {6, 7}),
    (64, 8, {8})])
def test_ota_device_groups_not_padded(m, groups, sizes):
    assert layout.ota_device_groups(m) == groups
    got = {hi - lo for lo, hi in layout.bounds(m, groups)}
    assert got == sizes and max(got) <= layout.OTA_MAX_DEVICES


def test_ota_grid_fills_the_card_at_the_main_shape():
    """At 25 devices x 2 blocks x 4096 -> 1024: at least 2 x 132 CTAs."""
    clusters, groups = layout.ota_cluster_size(4096), layout.ota_device_groups(25)
    tiles = -(-1024 // layout.OTA_TILE_ROWS)
    assert (clusters, groups, tiles) == (8, 4, 8)
    assert clusters * groups * 2 * tiles >= 2 * 132


def _rows_in_order(A, y):
    """sum_i A[:, i, :] * y[..., i] in float64, one row at a time in
    ascending order from 0.0, as a thread of the adjoint kernel adds its
    rows (a product of a float32 entry and a float32 value is exact in
    float64, so the kernel's fused multiply-add is this add)."""
    acc = torch.zeros(*y.shape[:-1], A.shape[-1], dtype=torch.float64)
    for i in range(A.shape[1]):
        acc = acc + A[:, i, :] * y[..., i, None]
    return acc


def _ota_t_split(y, seed, c, rademacher):
    """ota_project_t's product as the kernel computes it: per column tile,
    each row group of each CTA of the cluster sums its rows one at a time,
    the groups' partials are added in group order, the CTAs' in rank order,
    and a Rademacher sum of +-y is scaled once at the end."""
    n_blocks, s = y.shape[-2:]
    A = ref.block_matrix_ref(seed, torch.arange(n_blocks), s, c, rademacher)
    if rademacher:
        A = torch.where(A > 0, 1.0, -1.0)
    A, yd = A.double(), y.double()
    tiles = []
    for clo, chi in layout.ota_t_column_tiles(c):
        tiles.append(_ordered([
            _ordered([_rows_in_order(A[:, lo:hi, clo:chi], yd[..., lo:hi])
                      for lo, hi in groups])
            for groups in layout.ota_t_row_slices(s)]))
    out = torch.cat(tiles, dim=-1)
    if rademacher:
        out = out * float(ref.entry_scale(s))
    return out.float()


@pytest.mark.parametrize("rademacher", [True, False])
@pytest.mark.parametrize("m,n_blocks,s,c,want_cs", [
    (1, 2, 1024, 4096, 8),   # the unfused decode's adjoint
    (25, 2, 1024, 4096, 8),  # the main path's 25 devices
    (3, 3, 777, 1000, 4),    # ragged: CTAs of 194 and 195 rows, groups of
                             # 97 and 98, a 232-column tile
])
def test_ota_t_split_sums_bitwise(m, n_blocks, s, c, want_cs, rademacher):
    """The adjoint kernel's slicing: row slices per CTA of a cluster, column
    tiles of 256, partials in rank order; the float32 result equals the
    unsplit plain version bitwise."""
    assert layout.ota_t_cluster_size(s) == want_cs
    y = torch.from_numpy(np.random.RandomState(m + s).randn(m, n_blocks, s)
                         .astype(np.float32))
    split = _ota_t_split(y, 12345, c, rademacher)
    assert torch.equal(split, ref.ota_project_t_ref(y, 12345, c, rademacher))


def test_ota_t_grid_fills_the_card_at_the_path_shape():
    """At 1 vector x 2 blocks x 1024 -> 4096: at least 132 CTAs (one per
    SM), and 256 with clusters of 8."""
    x, blocks, groups = layout.ota_t_grid(1, 2, 1024, 4096)
    assert (x, blocks, groups) == (128, 2, 1)
    assert x * blocks * groups == 256 >= 132
    tiles = layout.ota_t_column_tiles(4096)
    assert len(tiles) == 16 and all(hi - lo == layout.OTA_T_TILE_COLS
                                    for lo, hi in tiles)


@pytest.mark.parametrize("s,c,cs", [(1024, 4096, 8), (777, 1000, 4),
                                    (256, 1024, 2), (90, 1000, 1),
                                    (16, 64, 1), (7, 10007, 1),
                                    (4096, 256, 8)])
def test_ota_t_cut_covers_in_order(s, c, cs):
    """Row slices (per CTA, then per row group) and column tiles are
    contiguous and cover the block once; every CTA of a split cluster keeps
    at least 128 rows."""
    slices = layout.ota_t_row_slices(s)
    assert len(slices) == layout.ota_t_cluster_size(s) == cs
    assert all(len(g) == layout.OTA_T_ROW_GROUPS for g in slices)
    rows = [part for groups in slices for part in groups]
    tiles = layout.ota_t_column_tiles(c)
    for parts, n in ((rows, s), (tiles, c)):
        assert parts[0][0] == 0 and parts[-1][1] == n
        assert all(hi == lo2 for (_, hi), (lo2, _) in zip(parts, parts[1:]))
    assert cs == 1 or min(g[-1][1] - g[0][0] for g in slices) >= \
        layout.OTA_T_MIN_ROWS
