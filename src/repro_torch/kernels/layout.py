"""How the CUDA kernels of ``amp_fused``, ``ota_project`` and
``ota_project_t`` cut their work.

Pure Python, no torch: the wrappers size their launches from these
functions, and the CPU tests of the kernels' rounding
(``tests/test_torch_split_sums.py``) cut the plain products the same way.
The kernels compute the same bounds with the same integer formula,
``floor(k * n / parts)`` (``cut`` in ``csrc/amp_fused.cu``,
``csrc/ota_project.cu`` and ``csrc/ota_project_t.cu``).
"""
from __future__ import annotations

#: threads of one ``amp_fused`` CTA, and its warps
AMP_THREADS = 512
AMP_WARPS = AMP_THREADS // 32
#: most CTAs in one ``amp_fused`` cluster (16 is Hopper's non-portable limit)
AMP_MAX_CLUSTER = 16
#: fewest columns an ``amp_fused`` CTA owns when the block is split
AMP_MIN_COLUMNS = 256
#: entries of A one ``amp_fused`` signed-sum table covers (a nibble of sign
#: bits): consecutive columns of a CTA's slice, or rows of a row segment
AMP_GROUP = 4

#: ``ota_project``: warps of a CTA, rows a thread owns, rows of a CTA's tile
OTA_WARPS = 4
OTA_ROWS_PER_THREAD = 4
OTA_TILE_ROWS = 32 * OTA_ROWS_PER_THREAD
#: most devices one ``ota_project`` CTA carries in registers
OTA_MAX_DEVICES = 8
#: most CTAs in one ``ota_project`` cluster (portable), and the fewest
#: columns each of them owns when the columns are split
OTA_MAX_CLUSTER = 8
OTA_MIN_COLUMNS = 512

#: ``ota_project_t``: a CTA is OTA_T_ROW_GROUPS groups of 128 threads; a
#: thread owns 2 columns (``t`` and ``t + 128`` of its tile) over its
#: group's share of the CTA's rows
OTA_T_COLUMN_THREADS = 128
OTA_T_ROW_GROUPS = 2
OTA_T_THREADS = OTA_T_COLUMN_THREADS * OTA_T_ROW_GROUPS
OTA_T_COLS_PER_THREAD = 2
OTA_T_TILE_COLS = OTA_T_COLUMN_THREADS * OTA_T_COLS_PER_THREAD
#: most CTAs in one ``ota_project_t`` cluster (portable), and the fewest
#: rows each of them sums when the rows are split
OTA_T_MAX_CLUSTER = 8
OTA_T_MIN_ROWS = 128

#: the grid's y limit: ``ota_project`` and ``ota_project_t`` put blocks on
#: y and loop over more of them
GRID_Y_MAX = 65535


def cut(n: int, parts: int, k: int) -> int:
    """Start of part ``k`` of ``n`` items cut into ``parts`` near-equal,
    contiguous parts; part ``k`` is ``[cut(n, parts, k), cut(n, parts, k + 1))``."""
    return k * n // parts


def bounds(n: int, parts: int) -> list[tuple[int, int]]:
    """The ``parts`` contiguous slices ``[lo, hi)`` of ``range(n)``, in order."""
    return [(cut(n, parts, k), cut(n, parts, k + 1)) for k in range(parts)]


def _pow2_at_most(limit: int, fits) -> int:
    k = limit
    while k > 1 and not fits(k):
        k //= 2
    return k


def amp_cluster_size(s: int, c: int) -> int:
    """CTAs K of the cluster that decodes one s x c block.

    The largest power of two up to 16 that leaves every CTA at least 256
    columns and one row.  A function of the block's shape only, never of
    the number of blocks, so a block decodes to the same bits in any range.
    """
    return _pow2_at_most(AMP_MAX_CLUSTER,
                         lambda k: k * AMP_MIN_COLUMNS <= c and k <= s)


def amp_words(s: int, c: int) -> int:
    """32-column words of the widest column slice of one ``amp_fused`` CTA."""
    k = amp_cluster_size(s, c)
    return (-(-c // k) + 31) // 32


def amp_row_segments(s: int, c: int) -> int:
    """Row segments G of the adjoint inside one CTA.

    A warp sums one 32-column word over one segment of the rows, in
    ascending row order; the G partials of a column are then added in
    segment order.  G spreads the CTA's words over its 16 warps.
    """
    return max(1, min(s, AMP_WARPS // amp_words(s, c)))


def amp_groups(lo: int, hi: int) -> list[tuple[int, int]]:
    """The groups ``[a, b)`` of ``amp_fused``'s signed-sum tables over the
    items ``[lo, hi)`` of one column slice or row segment: group ``q``
    starts at ``lo + AMP_GROUP * q``, and the last is short where
    ``AMP_GROUP`` does not divide ``hi - lo``.  The Rademacher products add
    a group's entries first, then the groups in this order."""
    return [(a, min(a + AMP_GROUP, hi)) for a in range(lo, hi, AMP_GROUP)]


def amp_column_groups(s: int, c: int) -> list[list[tuple[int, int]]]:
    """The forward product's groups: ``[rank] -> groups`` of the CTA's
    column slice ``bounds(c, K)[rank]``."""
    return [amp_groups(lo, hi)
            for lo, hi in bounds(c, amp_cluster_size(s, c))]


def amp_row_groups(s: int, c: int) -> list[list[tuple[int, int]]]:
    """The adjoint's groups: ``[segment] -> groups`` of row segment
    ``bounds(s, G)[segment]``."""
    return [amp_groups(lo, hi)
            for lo, hi in bounds(s, amp_row_segments(s, c))]


def ota_cluster_size(c: int) -> int:
    """CTAs of the cluster that splits one block's columns in ota_project:
    the largest power of two up to 8 that leaves each at least 512 columns."""
    return _pow2_at_most(OTA_MAX_CLUSTER, lambda k: k * OTA_MIN_COLUMNS <= c)


def ota_device_groups(m: int) -> int:
    """Groups of devices in ota_project: the fewest of at most 8 devices
    each, cut near-equal (25 devices: 6, 6, 6, 7), so no CTA adds zeros for
    a device that is not there."""
    return max(1, -(-m // OTA_MAX_DEVICES))


def ota_column_slices(c: int) -> list[list[tuple[int, int]]]:
    """Column slices of ota_project: ``[rank][warp] -> (lo, hi)``.

    CTA ``rank`` of a cluster owns the contiguous columns
    ``bounds(c, CS)[rank]``, and its warp ``w`` the contiguous share
    ``bounds(width, 4)[w]`` of them.  A thread sums its share in ascending
    column order; the warps' partials are added in warp order, then the
    ranks' partials in rank order.
    """
    out = []
    for lo, hi in bounds(c, ota_cluster_size(c)):
        out.append([(lo + a, lo + b) for a, b in bounds(hi - lo, OTA_WARPS)])
    return out


def ota_t_cluster_size(s: int) -> int:
    """CTAs of the cluster that splits one block's rows in ota_project_t:
    the largest power of two up to 8 that leaves each at least 128 rows.
    A function of s only, so a block's bits do not depend on how many
    blocks or devices a launch carries."""
    return _pow2_at_most(OTA_T_MAX_CLUSTER, lambda k: k * OTA_T_MIN_ROWS <= s)


def ota_t_row_slices(s: int) -> list[list[tuple[int, int]]]:
    """Row slices of ota_project_t: ``[rank][group] -> (lo, hi)``.

    CTA ``rank`` of a cluster owns the contiguous rows ``bounds(s, CS)[rank]``
    and its row group ``g`` the contiguous share ``bounds(height, 2)[g]`` of
    them.  A thread sums its share in ascending row order; the groups'
    partials are added in group order, then the ranks' in rank order.
    """
    out = []
    for lo, hi in bounds(s, ota_t_cluster_size(s)):
        out.append([(lo + a, lo + b)
                    for a, b in bounds(hi - lo, OTA_T_ROW_GROUPS)])
    return out


def ota_t_column_tiles(c: int) -> list[tuple[int, int]]:
    """Column tiles ``[lo, hi)`` of ota_project_t, one cluster each; the
    last is ragged where 256 does not divide ``c``."""
    return [(lo, min(lo + OTA_T_TILE_COLS, c))
            for lo in range(0, c, OTA_T_TILE_COLS)]


def ota_t_grid(m: int, n_blocks: int, s: int, c: int) -> tuple[int, int, int]:
    """Grid of ota_project_t: (clusters' CTAs over the column tiles, blocks
    up to the grid's y limit, device groups); past the limit a CTA takes
    blocks ``y``, ``y + GRID_Y_MAX``, ... in turn."""
    return (ota_t_cluster_size(s) * len(ota_t_column_tiles(c)),
            min(n_blocks, GRID_Y_MAX),
            ota_device_groups(m))
