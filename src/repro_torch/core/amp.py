"""Approximate message passing (AMP) reconstruction at the PS (paper §IV, [31]).

Soft-threshold AMP for y = A x + z with x ~ k-sparse:

    r_t   = x_t + A^T z_t
    x_t+1 = soft(r_t, tau_t),   tau_t = mult * ||z_t|| / sqrt(s)
    z_t+1 = y - A x_t+1 + z_t * (||x_t+1||_0 / s)      (Onsager correction)

The blocked variant runs an independent AMP per projection block.  As in the
reference (``repro/core/amp.py``) there are three blocked routes, and they
round differently: the fused kernel (``use_kernel``), the chunked loop that
makes each chunk's A once (:func:`amp_blocked_core`), and launch-per-op
decoding through the projector (:func:`amp_decode_blocked`).
:func:`amp_decode` picks among them exactly as the reference does.

A sweep's grid decodes G points at once: :func:`amp_decode` and
:func:`amp_blocked_core` take a leading point axis.  The fused kernel
decodes all G points in one launch; every other route decodes each point
as a lone point does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import div_f32, per_point
from repro_torch.kernels import ops, ref


def soft_threshold(x: torch.Tensor, tau) -> torch.Tensor:
    return torch.sign(x) * torch.clamp(x.abs() - tau, min=0.0)


def _debias_factor(num, den):
    """Clamped LS rescale factor correcting the soft-threshold shrinkage."""
    return torch.clamp(num / torch.clamp(den, min=1e-12), 1.0, 2.0)


def _ls_rescale(x: torch.Tensor, ax: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Debias the soft-threshold shrinkage: scale x so A x best matches y."""
    return x * _debias_factor(torch.dot(ax, y), torch.dot(ax, ax))


def _sqrt_f32(n: int) -> float:
    """``sqrt(f32(n))`` rounded to float32, as a python scalar (no tensor
    copied to the device, so no wait for the device's queue)."""
    return float(np.sqrt(np.float32(n)))


def amp_decode_dense(y: torch.Tensor, A: torch.Tensor, iters: int = 20,
                     threshold_mult: float = 1.3,
                     debias: bool = True) -> torch.Tensor:
    """Recover x (d,) from y (s,) with the dense measurement matrix A (s,d)."""
    s, d = A.shape
    sqrt_s = _sqrt_f32(s)
    x = torch.zeros((d,), dtype=y.dtype, device=y.device)
    z = y
    for _ in range(iters):
        sigma_hat = div_f32(torch.linalg.norm(z), sqrt_s)
        r = x + A.T @ z
        x = soft_threshold(r, threshold_mult * sigma_hat)
        onsager = z * div_f32((x != 0.0).sum(), s)
        z = y - A @ x + onsager
    if debias:
        x = _ls_rescale(x, A @ x, y)
    return x


# The blocked routes sum every long reduction (the products with A, ||z||^2
# and the debias dots) in float64 and round it once to float32, as the fused
# CUDA kernel does; the rest is float32 op for op.  AMP's soft threshold is
# sensitive to one-ulp changes near the threshold, and this keeps the kernel
# and its plain version within the parity bar of each other.


def _dot64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.double() * b.double()).sum(dim=-1, keepdim=True)


def _amp_step(x, z, y, sqrt_s, s_block, threshold_mult, adjoint, forward):
    sigma_hat = div_f32(torch.sqrt(_dot64(z, z)).float(), sqrt_s)
    r = x + adjoint(z)
    x_new = soft_threshold(r, threshold_mult * sigma_hat)
    onsager = z * div_f32((x_new != 0.0).sum(dim=-1, keepdim=True), s_block)
    return x_new, y - forward(x_new) + onsager


def _debias_blocks(x, ax, y):
    factor = _dot64(ax, y) / torch.clamp(_dot64(ax, ax), min=1e-12)
    return x * torch.clamp(factor.float(), 1.0, 2.0)


def amp_decode_blocked(yb: torch.Tensor, projector, iters: int = 20,
                       threshold_mult: float = 1.3,
                       debias: bool = True) -> torch.Tensor:
    """Per-block AMP. yb: (n_blocks, s_block) -> flat (d,) estimate.

    All products go through the projector (on-the-fly A), so every
    application regenerates A -- 2*iters+1 generations per decode.  On a
    ``use_kernel`` projector and a CUDA tensor each iteration launches the
    adjoint kernel ``ota_project_t`` once and the forward kernel
    ``ota_project`` once, and the debias one more forward: ``iters`` and
    ``iters + 1`` launches per decode.  :func:`amp_decode` sends a
    ``use_kernel`` projector to the fused kernel instead, as the reference
    does; this launch-per-op route is called directly.
    """
    n_blocks, s_block = yb.shape
    sqrt_s = _sqrt_f32(s_block)
    x = torch.zeros((n_blocks, projector.block_size), dtype=yb.dtype,
                    device=yb.device)
    z = yb
    for _ in range(iters):
        x, z = _amp_step(x, z, yb, sqrt_s, s_block, threshold_mult,
                         projector.project_t_blocks, projector.project_blocks)
    if debias:
        x = _debias_blocks(x, projector.project_blocks(x), yb)
    return projector.from_blocks(x)


def amp_blocked_core(yb: torch.Tensor, seed, c: int, iters: int = 20,
                     chunk_blocks: int = 8, threshold_mult: float = 1.3,
                     debias: bool = True, rademacher: bool = True,
                     id_offset=0, use_kernel: bool = False) -> torch.Tensor:
    """Chunked per-block AMP with ONE A-generation per block per decode.

    yb: (n_blocks, s_block) -> xb: (n_blocks, c), or (G, n_blocks,
    s_block) -> (G, n_blocks, c) for G points; block ``b`` of every point
    has the global id ``id_offset + b``.  ``seed`` and ``id_offset``
    (global index of the first block) are ints or int64-held uint32
    tensors.

    ``use_kernel=False``: a loop over chunks of ``chunk_blocks`` blocks;
    each chunk's A is generated once and all AMP iterations for its blocks
    run against it.  This is the plain version of the fused kernel.
    ``use_kernel=True``: the fused single-launch kernel
    (kernels/amp_fused.py) on a CUDA tensor, this plain version on a CPU one.
    The plain version decodes G points one after the other.
    """
    if use_kernel:
        return ops.amp_decode_fused(yb, seed=seed, c=c, iters=iters,
                                    threshold_mult=threshold_mult,
                                    debias=debias, rademacher=rademacher,
                                    nb_tile=chunk_blocks,
                                    id_offset=id_offset)
    if yb.dim() == 3:
        return per_point(lambda y: amp_blocked_core(
            y, seed, c, iters, chunk_blocks, threshold_mult, debias,
            rademacher, id_offset), yb, rank=2)
    n_blocks, s_block = yb.shape
    sqrt_s = _sqrt_f32(s_block)
    offset = ref.as_u32(id_offset, yb.device)
    outs = []
    for b0 in range(0, n_blocks, chunk_blocks):
        y_c = yb[b0:b0 + chunk_blocks]
        ids = torch.arange(b0, b0 + y_c.shape[0], dtype=torch.int64,
                           device=yb.device) + offset
        A = ref.block_matrix_ref(seed, ids, s_block, c, rademacher)  # ONCE

        def adjoint(z, A=A):
            return ref.contract("isc,is->ic", A, z)

        def forward(x, A=A):
            return ref.contract("isc,ic->is", A, x)

        x = torch.zeros((y_c.shape[0], c), dtype=yb.dtype, device=yb.device)
        z = y_c
        for _ in range(iters):
            x, z = _amp_step(x, z, y_c, sqrt_s, s_block, threshold_mult,
                             adjoint, forward)
        if debias:
            x = _debias_blocks(x, forward(x), y_c)
        outs.append(x)
    return torch.cat(outs, dim=0)


def amp_decode_blocked_scan(yb: torch.Tensor, projector, iters: int = 20,
                            threshold_mult: float = 1.3,
                            debias: bool = True) -> torch.Tensor:
    """Chunked AMP sized from a :class:`BlockedProjector`."""
    xb = amp_blocked_core(yb, projector.seed, projector.block_size, iters,
                          projector.chunk_blocks, threshold_mult, debias,
                          projector.rademacher)
    return projector.from_blocks(xb)


def amp_decode(y_flat: torch.Tensor, projector, iters: int = 20,
               threshold_mult: float = 1.3) -> torch.Tensor:
    """Dispatch on projector type; y_flat has projector.out_dim entries,
    (out_dim,) -> (d,) or, for G points, (G, out_dim) -> (G, d)."""
    from repro_torch.core.projection import BlockedProjector, DenseProjector
    if isinstance(projector, DenseProjector):
        mat = projector.matrix(y_flat.device)
        return per_point(lambda y: amp_decode_dense(y, mat, iters,
                                                    threshold_mult),
                         y_flat, rank=1)
    if not isinstance(projector, BlockedProjector):
        raise TypeError(f"unknown projector {type(projector).__name__}")
    if projector.use_kernel:
        yb = y_flat.reshape(*y_flat.shape[:-1], projector.n_blocks,
                            projector.s_block)
        xb = amp_blocked_core(yb, projector.seed, projector.block_size,
                              iters, projector.chunk_blocks, threshold_mult,
                              rademacher=projector.rademacher,
                              use_kernel=True)
        return projector.from_blocks(xb)
    if y_flat.dim() == 2:
        return per_point(lambda y: amp_decode(y, projector, iters,
                                              threshold_mult),
                         y_flat, rank=1)
    yb = y_flat.reshape(projector.n_blocks, projector.s_block)
    if projector.n_blocks > projector.chunk_blocks:
        return amp_decode_blocked_scan(yb, projector, iters, threshold_mult)
    return amp_decode_blocked(yb, projector, iters, threshold_mult)
