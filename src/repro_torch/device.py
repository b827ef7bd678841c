"""Device resolution and the fixed-order helpers shared by the port.

``device=None`` means the card (``torch.device("cuda")``).  Without one the
entry points raise instead of carrying on on the CPU; tests and other CPU
callers ask for ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import time

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on.

    Also pins float32 matrix products to full precision: TF32 keeps about
    three decimal digits, below the port's parity bars, so both TF32
    switches are turned off explicitly whenever a CUDA device is resolved.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch entry points run on a CUDA device by default and "
                "none is available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def clock(device) -> float:
    """The host's clock in seconds, read once ``device``'s queue has
    drained (torch returns before the card finishes)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def div_f32(t: torch.Tensor, n) -> torch.Tensor:
    """``t / n`` as a true float32 division on every device.

    On a CUDA tensor torch divides by a python scalar as a multiply by the
    scalar's float32 reciprocal, which misses the quotient by an ulp where
    ``1/n`` is inexact (``n = 25``, ``n = 100``).  A 0-dim divisor filled on
    the tensor's own device (no copy from the host, so no wait for the
    device's queue) keeps the true division that the CPU and the reference
    make.  A tensor ``n`` is divided by as it is.
    """
    if isinstance(n, torch.Tensor):
        return t / n
    return t / torch.full((), n, dtype=torch.float32, device=t.device)


def div_const(t: torch.Tensor, n) -> torch.Tensor:
    """``t / n`` for a python constant ``n`` as the reference's ``jit``
    compiles it: XLA's CPU backend multiplies by the float32 reciprocal
    ``f32(1) / f32(n)``, which misses the true quotient by an ulp where
    ``1/n`` is inexact (``n = 3``, ``5``, ``25``).  The product with a
    python float is the same float32 multiply on every device."""
    return t * float(np.float32(1.0) / np.float32(n))


def per_point(fn, *xs: torch.Tensor, rank: int):
    """``fn(*xs)`` once for each point of a leading point axis, stacked.

    ``xs`` carry ``rank`` dimensions per point; with exactly ``rank`` there
    is no point axis and ``fn`` runs once.  With one more, ``fn`` runs on
    a fresh copy of each point's slices and its results (a tensor or a
    tuple of tensors) are stacked along a new leading axis.  A sweep's grid
    runs its points as one batched round, and each point must round as its
    own run does.

    On the card two kinds of op change a point's bits when G points run as
    one batch (``tests/test_torch_cuda.py``, ``test_point_axis_*``): a
    product whose shape grows with G (cuBLAS picks another algorithm: the
    model's logits, the dense projection, the plain AMP decodes), and a
    sum along the rows of a ``(G * M, n)`` batch, which torch configures by
    its number of rows (``make_frame``'s and ``frame_power``'s, SBC's
    means, QSGD's norm: :func:`row_sum`).  Those run per point through
    here.  Sums across the device axis, the metrics' means over M entries
    and elementwise ops keep each point's bits and run batched.

    The copies matter too: a row sum's order depends on where its rows
    start (torch loads them in 16-byte vectors from the first aligned
    entry), a point's slice of a batch can start 8 bytes off, and the
    tensors of a point's own run start aligned.
    """
    lead = xs[0].dim() - rank
    if lead == 0:
        return fn(*xs)
    if lead != 1:
        raise ValueError(f"per_point: expected {rank} or {rank + 1} "
                         f"dimensions, got {tuple(xs[0].shape)}")
    outs = [fn(*(x[g].clone() for x in xs)) for g in range(xs[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(parts) for parts in zip(*outs))
    return torch.stack(outs)


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """``x.sum(-1)``; a ``(G, M, n)`` batch of G points sums each point's
    ``(M, n)`` rows on their own, in the order a lone point's call does."""
    if x.dim() == 3:
        return per_point(row_sum, x, rank=2)
    return x.sum(dim=-1)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt, as XLA computes it (through float64:
    torch's vectorised float32 sqrt on the CPU misses it by an ulp on some
    inputs)."""
    return torch.sqrt(x.double()).float()


#: XLA's CPU backend rewrites a reduction longer than this into windows of
#: this length, summed one after the other
XLA_REDUCE_WINDOW = 32


def xla_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """float32 sum along ``dim`` in the order XLA's CPU backend sums a
    reduction: one element after another from 0, and a dimension longer
    than 32 first in windows of 32, whose partial sums are then summed the
    same way.  XLA pads such a dimension to a multiple of 32 with zeros
    split between its ends, ``pad // 2`` in front and the rest behind (a
    ``reduce-window`` with ``pad=lo_hi``).  Elementwise adds only, so every
    row keeps its bits whatever batch it rides in."""
    x = x.movedim(dim, 0)
    n = x.shape[0]
    if n > XLA_REDUCE_WINDOW:
        w = XLA_REDUCE_WINDOW
        pad = -n % w
        if pad:
            lo = pad // 2
            x = torch.cat([x.new_zeros((lo, *x.shape[1:])), x,
                           x.new_zeros((pad - lo, *x.shape[1:]))])
        parts = xla_sum(x.reshape(-1, w, *x.shape[1:]), dim=1)
        return xla_sum(parts, dim=0)
    if n == 1:
        return x[0]             # XLA drops a reduction over one element
    acc = x[0] + 0.0
    for i in range(1, n):
        acc = acc + x[i]
    return acc


def lead(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A 0-dim or ``(G,)`` scalar shaped to broadcast along ``x``'s
    trailing axes (one value per point of a grid)."""
    return v.reshape(v.shape + (1,) * (x.dim() - v.dim()))


def take(v: torch.Tensor, idx: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The rows ``idx`` of ``v`` along its device axis ``dim`` (0 without a
    point axis, 1 with one), trailing axes kept: ``jnp.take(v, idx,
    axis=dim)``.  A ``(G, K)`` ``idx`` takes one cohort per point, from a
    ``v`` with or without the point axis."""
    if idx.dim() == 1:
        return v.index_select(dim, idx)
    if dim == 0:
        return v[idx]
    ix = idx.reshape(idx.shape + (1,) * (v.dim() - dim - 1))
    return torch.gather(v, dim, ix.expand(*idx.shape, *v.shape[dim + 1:]))
