"""Plain PyTorch versions of the hash, the projection and the sparsifier.

These are the port's counterparts of the reference's ``repro/kernels/ref.py``
and the plain versions the CUDA kernels are held against.  The measurement
matrix A is generated from a counter-based integer hash of ``(seed, block,
row, col)``; the same hash is written out in ``csrc/hash.cuh``.

uint32 ``+`` and ``>>`` are not implemented for CPU tensors in torch, so the
hash works on int64 words masked to 32 bits.  Both multipliers are below
2**31, so the product of a 32-bit word with either stays below 2**63.

Entry distributions:
  * ``rademacher``:  +-1/sqrt(s_block)
  * gaussian:        N(0, 1/s_block) via Box-Muller from two hash draws
"""
from __future__ import annotations

import math
import threading

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_M1 = 0x21F0AAAD
_M2 = 0x735A2D97
_GOLDEN = 0x9E3779B9
_BOX_MULLER_SALT = 0xDEADBEEF


def as_u32(v, device=None) -> torch.Tensor:
    """An int64-held uint32 tensor from an int or a tensor."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64) & MASK32
    return torch.tensor(int(v) & MASK32, dtype=torch.int64, device=device)


def splitmix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 finalizer on int64-held uint32 words (wrapping arithmetic)."""
    x = (x + _GOLDEN) & MASK32
    x = x ^ (x >> 16)
    x = (x * _M1) & MASK32
    x = x ^ (x >> 15)
    x = (x * _M2) & MASK32
    x = x ^ (x >> 15)
    return x


def hash3(seed, block, row, col) -> torch.Tensor:
    """Chained hash of three coordinates (avoids 64-bit flat indices)."""
    device = next((v.device for v in (seed, block, row, col)
                   if isinstance(v, torch.Tensor)), None)
    h = splitmix32(as_u32(seed, device) ^ as_u32(block, device))
    h = splitmix32(h ^ as_u32(row, device))
    h = splitmix32(h ^ as_u32(col, device))
    return h


def entry_scale(s_block: int) -> float:
    """``f32(1/sqrt(s_block))``, computed in double as the reference does."""
    return float(np.float32(1.0 / np.sqrt(s_block)))


def _uniform01(h: torch.Tensor) -> torch.Tensor:
    # (h + 0.5) / 2^32 in (0, 1); h rounds to float32 first
    return (h.to(torch.float32) + 0.5) * (2.0 ** -32)


def block_matrix_ref(seed, block, s_block: int, c: int,
                     rademacher: bool = True, device=None) -> torch.Tensor:
    """Blocks A_b of shape ``(*block.shape, s_block, c)``.

    ``block`` is an int or an integer tensor of block ids; ``seed`` an int
    or an int64-held uint32 tensor.
    """
    if isinstance(block, torch.Tensor):
        device = block.device
    elif isinstance(seed, torch.Tensor):
        device = seed.device
    blk = as_u32(block, device)[..., None, None]
    rows = torch.arange(s_block, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(c, dtype=torch.int64, device=device)[None, :]
    h = hash3(seed, blk, rows, cols)
    scale = entry_scale(s_block)
    if rademacher:
        return (1.0 - 2.0 * (h >> 31).to(torch.float32)) * scale
    h2 = splitmix32(h ^ _BOX_MULLER_SALT)
    u1 = _uniform01(h)
    u2 = _uniform01(h2)
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
    return z * scale


#: the plain products on the CPU keep a few small A's, in float64 as
#: ``contract`` takes them, keyed by (seed, shape, entries): one A serves
#: every call (a streamed round's chunks share theirs), where hashing it
#: anew cost most of a plain decode's time.  On the card the plain
#: versions stay whole (hash and product), as the kernels are timed
#: against them
_PLAIN_A: dict = {}
_PLAIN_A_LOCK = threading.Lock()
_PLAIN_A_ENTRIES = 8
_PLAIN_A_MAX_BYTES = 64 << 20


def plain_blocks(seed, n_blocks: int, s_block: int, c: int,
                 rademacher: bool, device) -> torch.Tensor:
    """float64 A of blocks ``0 .. n_blocks - 1``: on the CPU made once and
    kept where it takes at most 64 MB and ``seed`` is a python int, made
    anew otherwise (on the card, a seed held in a tensor, a large A)."""
    ids = torch.arange(n_blocks, dtype=torch.int64, device=device)
    if (ids.device.type != "cpu" or isinstance(seed, torch.Tensor)
            or n_blocks * s_block * c * 8 > _PLAIN_A_MAX_BYTES):
        return block_matrix_ref(seed, ids, s_block, c, rademacher).double()
    key = (int(seed) & MASK32, n_blocks, s_block, c, bool(rademacher))
    with _PLAIN_A_LOCK:     # rank threads share the store
        A = _PLAIN_A.get(key)
    if A is None:
        A = block_matrix_ref(seed, ids, s_block, c, rademacher).double()
        with _PLAIN_A_LOCK:
            while len(_PLAIN_A) >= _PLAIN_A_ENTRIES:
                _PLAIN_A.pop(next(iter(_PLAIN_A)))
            _PLAIN_A[key] = A
    return A


def contract(eq: str, A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, A, v)`` with the products summed in float64.

    A float32 entry times a float32 value is exact in float64, so each long
    dot product of the blocked projection rounds once, to float32, at the
    end.  The CUDA kernels sum in float64 too, which keeps the two within an
    ulp of each other; AMP's soft threshold turns a larger gap near the
    threshold into a different support.
    """
    return torch.einsum(eq, A.double(), v.double()).float()


def ota_project_ref(x: torch.Tensor, seed, s_block: int,
                    rademacher: bool = True) -> torch.Tensor:
    """Forward projection. x: (..., n_blocks, c) -> (..., n_blocks, s_block)."""
    n_blocks, c = x.shape[-2:]
    A = plain_blocks(seed, n_blocks, s_block, c, rademacher, x.device)
    return contract("bsc,...bc->...bs", A, x)


def ota_project_t_ref(y: torch.Tensor, seed, c: int,
                      rademacher: bool = True) -> torch.Tensor:
    """Transpose projection. y: (..., n_blocks, s_block) -> (..., n_blocks, c)."""
    n_blocks, s_block = y.shape[-2:]
    A = plain_blocks(seed, n_blocks, s_block, c, rademacher, y.device)
    return contract("bsc,...bs->...bc", A, y)


def ef_sparsify_ref(g: torch.Tensor, delta: torch.Tensor, tau: torch.Tensor):
    """Fused error-feedback + threshold sparsification.

    g, delta: (..., n); tau: (...) -- one threshold per row.
    g_ec = g + delta ; keep entries with |g_ec| >= tau ; residual -> new delta.
    Returns (g_sp, new_delta).
    """
    g_ec = g + delta
    keep = g_ec.abs() >= torch.as_tensor(tau, device=g.device)[..., None]
    g_sp = torch.where(keep, g_ec, 0.0)
    return g_sp, g_ec - g_sp
