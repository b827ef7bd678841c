"""Each kernel's work as a function of its shapes, and the least time an
H100 could take for it: a frozen copy of the port's own cost model, kept
with the benchmark so that a change to the program cannot change the
yardstick its kernels are read against.

Bytes: each input read once and each output written once, in float32.
Operations: the float32 multiply-adds of the products (two each) and the
hash's integer operations per entry of A, counted at the float32 rate,
which can only make the bound smaller, so it stays a lower bound.
"""
from __future__ import annotations

from typing import NamedTuple

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 FLOP/s
#: outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: integer operations per entry of A: one lowbias32 stage (9) + the column xor
HASH_OPS = 10
#: a Gaussian entry adds a second stage, the uniform maps and Box-Muller
GAUSS_EXTRA_OPS = 20


class Cost(NamedTuple):
    n_bytes: int
    n_ops: int


def _entry_ops(rademacher: bool) -> int:
    return HASH_OPS + (0 if rademacher else GAUSS_EXTRA_OPS)


def ef_sparsify(m: int, n: int) -> Cost:
    """``m`` rows of ``n``: g and delta in, g_sp and delta' out, one
    threshold a row; an add, a compare and a subtract an entry."""
    return Cost(4 * (4 * m * n + m), 3 * m * n)


def ota_project(m: int, n_blocks: int, c: int, s: int,
                rademacher: bool = True) -> Cost:
    """``y[m, b] = A_b x[m, b]`` for ``m`` vectors of ``n_blocks`` blocks of
    ``c`` -> ``s``: each entry of A made once and applied to every vector."""
    entries = n_blocks * s * c
    return Cost(4 * (m * n_blocks * c + m * n_blocks * s),
                entries * _entry_ops(rademacher) + 2 * m * entries)


def ota_project_t(m: int, n_blocks: int, s: int, c: int,
                  rademacher: bool = True) -> Cost:
    """``r[m, b] = A_b^T y[m, b]``: the forward product's work, y in and r
    out."""
    entries = n_blocks * s * c
    return Cost(4 * (m * n_blocks * s + m * n_blocks * c),
                entries * _entry_ops(rademacher) + 2 * m * entries)


def amp_fused(points: int, n_blocks: int, s: int, c: int, iters: int,
              rademacher: bool = True) -> Cost:
    """``iters`` AMP iterations and the debias of ``points`` x ``n_blocks``
    blocks: ``2 * iters + 1`` products with each block's A a point, A made
    once a block for all points."""
    entries = n_blocks * s * c
    return Cost(4 * points * n_blocks * (s + c),
                (2 * iters + 1) * 2 * points * entries
                + _entry_ops(rademacher) * entries)


def bound(n_bytes: float, n_ops: float):
    """(least time in ms, what bounds it) on the H100's published peaks."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")
