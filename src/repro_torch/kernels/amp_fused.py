"""Fused single-launch AMP decode on the card.

Replaces the TPU kernel ``repro/kernels/amp_fused.py::amp_decode_fused_pallas``
(body ``_amp_kernel``).  Plain version: the ``use_kernel=False`` branch of
:func:`repro_torch.core.amp.amp_blocked_core`.

What bounds it on an H100: operations.  A decode of ``iters`` iterations
makes ``2 * iters + 1`` products with each block's A (the adjoint and the
forward product per iteration, then the debias), about
``2 * (2 * iters + 1) * s * c`` FLOPs per block, while only y in and x out
touch device memory.  The Pallas kernel keeps a chunk's A in VMEM; on
Hopper one block's A (16 MiB at 1024 x 4096) is far beyond the 227 KB of
one SM's shared memory.

So the CUDA kernel (``csrc/amp_fused.cu``) spreads each block over a
thread-block cluster of K CTAs on neighbouring SMs, which read each
other's shared memory (DSMEM): K = 16 at the main path's 1024 x 4096, a
function of the block's shape only (:func:`layout.amp_cluster_size`).
CTA k owns a slice of the columns (x, the adjoint, the threshold) and a
slice of the rows (the forward product's final sum, z' and y), and every
CTA keeps a whole copy of z.  Gaussian entries are made from the hash in
every product.  Rademacher entries are hashed once per decode and kept as
sign bits in shared memory, row-major and, where it fits, column-major (32
KB each per CTA at K = 16).  Before each product the CTA builds, per group
of 4 consecutive columns (forward) or rows (adjoint)
(:func:`layout.amp_groups`), a table of the 16 signed sums of x or z in
float64; a row or column then adds one table entry, indexed by a nibble of
its sign bits, per 4 entries of A.  What bounds an iteration there is the
shared-memory bandwidth of those lookups and the latency of the cluster's
exchanges; a CTA takes ~106 KB of shared memory and 64 registers at the
main shape, so two share an SM and one's exchanges overlap the other's
lookups.  Every block whose sign bits alone fitted a CTA still decodes:
where the tables do not all fit, they are built a chunk at a time, and
without the column-major copy the adjoint turns the bits around in
registers.  Every launch on that path adds 1 to the
``amp_fused.sign_tables`` counter beside ``launches.amp_fused``.  The partial sums cross CTAs in rank order, with
no atomics, so runs are bitwise repeatable and a sub-range decoded with
``id_offset`` equals the full decode's rows bitwise.  At the main path's
two blocks the decode runs on 32 SMs.

A sweep's grid decodes G points in one launch: ``yb`` of shape (G,
n_blocks, s_block), the same A for every point, the grid's y dimension the
point.  Nothing else in the kernel depends on the point, so each point's
rows are bitwise its own G = 1 decode; G = 4 at the main path's shape puts
8 clusters of 16 CTAs on the card at once where it holds that many
(:func:`max_active_clusters`).
"""
from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.kernels import build, cost, layout, ref


def amp_decode_fused(yb: torch.Tensor, seed, c: int, *, iters: int = 20,
                     threshold_mult: float = 1.3, debias: bool = True,
                     rademacher: bool = True, id_offset=0,
                     chunk_blocks: int = 8) -> torch.Tensor:
    """Decode yb: (n_blocks, s_block) -> xb: (n_blocks, c), or G points
    (G, n_blocks, s_block) -> (G, n_blocks, c), in one launch.

    ``seed`` and ``id_offset`` (global id of the first block of every
    point) are ints or int64-held uint32 tensors.  CPU tensors take the
    plain version, chunked by ``chunk_blocks`` and one point after the
    other; CUDA tensors launch the kernel; ``meta`` tensors get an output
    of the kernel's shape and their counts go to the active counter
    (:mod:`repro_torch.kernels.cost`).
    """
    if yb.device.type == "cpu":
        from repro_torch.core.amp import amp_blocked_core
        return amp_blocked_core(yb, seed, c, iters, chunk_blocks,
                                threshold_mult, debias, rademacher,
                                id_offset=id_offset, use_kernel=False)
    if yb.device.type == "meta":
        build.require_meta_f32("amp_decode_fused", yb=yb)
        points, n_blocks, s_block = _shape(yb)
        cost.record("amp_fused", cost.amp_fused(points, n_blocks, s_block, c,
                                                iters, rademacher))
        return yb.new_empty(*yb.shape[:-1], c)
    return _launch(yb, seed, c, iters, threshold_mult, debias, rademacher,
                   id_offset)


def _shape(yb: torch.Tensor):
    """``(points, n_blocks, s_block)`` of a 2- or 3-dimensional ``yb``."""
    if yb.dim() not in (2, 3):
        raise ValueError(f"amp_decode_fused: yb must be (n_blocks, s_block) "
                         f"or (G, n_blocks, s_block), got {tuple(yb.shape)}")
    n_blocks, s_block = yb.shape[-2:]
    return (yb.shape[0] if yb.dim() == 3 else 1), n_blocks, s_block


def _launch(yb: torch.Tensor, seed, c: int, iters: int, threshold_mult: float,
            debias: bool, rademacher: bool, id_offset) -> torch.Tensor:
    build.require_cuda_f32("amp_decode_fused", yb=yb)
    points, n_blocks, s_block = _shape(yb)
    lib = build.library()
    k = layout.amp_cluster_size(s_block, c)
    g = layout.amp_row_segments(s_block, c)
    smem = lib.amp_fused_smem_bytes(s_block, c, k, g, int(rademacher))
    if smem > 232448:
        raise ValueError(f"amp_decode_fused: a {s_block} x {c} block on "
                         f"{k} CTAs needs {smem} bytes of shared memory per "
                         f"CTA, above 227 KB")
    xb = torch.empty(*yb.shape[:-1], c, dtype=torch.float32,
                     device=yb.device)
    seed_dev = build.device_u32(seed, yb.device)
    offset_dev = build.device_u32(id_offset, yb.device)
    rc = lib.amp_fused_launch(
        yb.data_ptr(), seed_dev.data_ptr(), offset_dev.data_ptr(),
        xb.data_ptr(), n_blocks, points, s_block, c, k, g, int(iters),
        float(threshold_mult),
        int(debias), int(rademacher), ref.entry_scale(s_block),
        build.current_stream(yb.device))
    build.check(rc, "amp_decode_fused")
    tracing.count("launches.amp_fused")
    if rademacher:
        tracing.count("amp_fused.sign_tables")
    return xb


def max_active_clusters(s_block: int, c: int, rademacher: bool = True) -> int:
    """How many clusters decoding ``s_block x c`` blocks the card holds at
    once, as ``cudaOccupancyMaxActiveClusters`` reports it for this
    kernel's cluster size and shared memory."""
    k = layout.amp_cluster_size(s_block, c)
    g = layout.amp_row_segments(s_block, c)
    n = build.library().amp_fused_max_active_clusters(s_block, c, k, g,
                                                      int(rademacher))
    if n < 0:
        build.check(-n, "amp_fused_max_active_clusters")
    return n
