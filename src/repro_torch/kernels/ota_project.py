"""Blocked compressive projection and its adjoint on the card, A generated
in the kernel.

The forward product replaces the TPU kernel
``repro/kernels/ota_project.py::ota_project_pallas`` (body ``_fwd_kernel``,
helpers ``_tile_A`` and ``_splitmix32``).  Plain version:
:func:`repro_torch.kernels.ref.ota_project_ref`.

What bounds it on an H100: operations.  ``y[m, b] = A_b x[m, b]`` moves
only x and y through device memory, while every entry of A_b (16 MiB per
block at the main path's 1024 x 4096) is made from about ten integer
operations of the hash and then takes one float64 multiply-add per device.
The CUDA kernel (``csrc/ota_project.cu``) never stores A.  It cuts the work
as :mod:`repro_torch.kernels.layout` says: a cluster of up to 8 CTAs splits
one block's columns for one 128-row tile and one group of at most 8
devices (25 devices: 6, 6, 6, 7, so no accumulator adds zeros), and each
thread holds a register tile of 4 rows x the group's devices.  Each entry
it makes feeds every device of the group, and each x value it loads from
shared memory feeds 4 rows, through one float64 FMA (the sign of a
Rademacher entry as +-1.0).  The CTAs' partials are added in rank order
through distributed shared memory.  At 25 devices x 2 blocks x 4096 -> 1024
the grid has 512 CTAs.

The adjoint replaces ``ota_project_t_pallas`` (body ``_t_kernel``) of the
same TPU module.  Plain version: :func:`repro_torch.kernels.ref.ota_project_t_ref`.
It is bound by integer operations: ``r[m, b] = A_b^T y[m, b]`` makes every
entry of A_b from the hash (about nine integer operations on an SM's 64
int32 lanes) and applies it to M devices, against only ``4 M (s_block + c)``
bytes per block.  The CUDA kernel (``csrc/ota_project_t.cu``) cuts the work
as :mod:`repro_torch.kernels.layout` says: a cluster of up to 8 CTAs splits
one 256-column tile's rows, each CTA's two row groups of 128 threads sum
their halves of its rows in ascending order in float64, and the partials
are added in group order, then in rank order through distributed shared
memory by the CTA that writes the column.  Each thread holds a register
tile of 2 columns x a device group of at most 8, so each staged row hash
feeds 2 entries and each entry every device of the group.  At the path's
1 vector x 2 blocks x 1024 -> 4096 the grid has 256 CTAs.  It runs
on the projector's adjoint (``BlockedProjector.project_t``) and so once per
iteration of the launch-per-op AMP decode (``amp_decode_blocked``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, cost, layout, ref

#: launches of the forward CUDA kernel since the last reset
launches = 0
#: launches of the adjoint CUDA kernel since the last reset
launches_t = 0


def ota_project(x: torch.Tensor, seed, s_block: int,
                rademacher: bool = True) -> torch.Tensor:
    """x: (..., n_blocks, c) -> (..., n_blocks, s_block).

    ``seed`` is an int or an int64-held uint32 tensor.  CPU tensors take the
    plain version; CUDA tensors launch the kernel; ``meta`` tensors get an
    output of the kernel's shape and their counts go to the active counter
    (:mod:`repro_torch.kernels.cost`).
    """
    if x.device.type == "cpu":
        return ref.ota_project_ref(x, seed, s_block, rademacher)
    if x.device.type == "meta":
        build.require_meta_f32("ota_project", x=x)
        m, n_blocks, c = _fwd_shape(x)
        cost.record("ota_project",
                    cost.ota_project(m, n_blocks, c, s_block, rademacher))
        return x.new_empty(*x.shape[:-1], s_block)
    return _launch(x, seed, s_block, rademacher)


def _fwd_shape(x: torch.Tensor):
    """``(m, n_blocks, c)`` of an ``(..., n_blocks, c)`` input."""
    if x.dim() < 2:
        raise ValueError(f"ota_project: x must be (..., n_blocks, c), got "
                         f"{tuple(x.shape)}")
    n_blocks, c = x.shape[-2:]
    return (x.numel() // (n_blocks * c) if n_blocks * c else 0), n_blocks, c


def _launch(x: torch.Tensor, seed, s_block: int,
            rademacher: bool) -> torch.Tensor:
    global launches
    build.require_cuda_f32("ota_project", x=x)
    m, n_blocks, c = _fwd_shape(x)
    y = torch.empty(*x.shape[:-1], s_block, dtype=torch.float32,
                    device=x.device)
    seed_dev = build.device_u32(seed, x.device)
    rc = build.library().ota_project_launch(
        x.data_ptr(), seed_dev.data_ptr(), y.data_ptr(), m, n_blocks, c,
        s_block, layout.ota_cluster_size(c), layout.ota_device_groups(m),
        int(rademacher), ref.entry_scale(s_block),
        build.current_stream(x.device))
    build.check(rc, "ota_project")
    with build.LAUNCH_LOCK:
        launches += 1
    return y


def ota_project_t(y: torch.Tensor, seed, c: int,
                  rademacher: bool = True) -> torch.Tensor:
    """y: (..., n_blocks, s_block) -> (..., n_blocks, c).

    ``seed`` is an int or an int64-held uint32 tensor.  CPU tensors take the
    plain version; CUDA tensors launch the kernel; ``meta`` tensors get an
    output of the kernel's shape and their counts go to the active counter.
    """
    if y.device.type == "cpu":
        return ref.ota_project_t_ref(y, seed, c, rademacher)
    if y.device.type == "meta":
        build.require_meta_f32("ota_project_t", y=y)
        m, n_blocks, s_block = _adj_shape(y, c)
        cost.record("ota_project_t",
                    cost.ota_project_t(m, n_blocks, s_block, c, rademacher))
        return y.new_empty(*y.shape[:-1], c)
    return _launch_t(y, seed, c, rademacher)


def _adj_shape(y: torch.Tensor, c: int):
    """``(m, n_blocks, s_block)`` of an ``(..., n_blocks, s_block)`` input."""
    if y.dim() < 2 or c <= 0:
        raise ValueError(f"ota_project_t: y must be (..., n_blocks, s_block) "
                         f"and c positive, got {tuple(y.shape)}, c={c}")
    n_blocks, s_block = y.shape[-2:]
    m = y.numel() // (n_blocks * s_block) if n_blocks * s_block else 0
    return m, n_blocks, s_block


def _launch_t(y: torch.Tensor, seed, c: int, rademacher: bool) -> torch.Tensor:
    global launches_t
    build.require_cuda_f32("ota_project_t", y=y)
    m, n_blocks, s_block = _adj_shape(y, c)
    r = torch.empty(*y.shape[:-1], c, dtype=torch.float32, device=y.device)
    seed_dev = build.device_u32(seed, y.device)
    rc = build.library().ota_project_t_launch(
        y.data_ptr(), seed_dev.data_ptr(), r.data_ptr(), m, n_blocks, s_block,
        c, layout.ota_t_cluster_size(s_block), layout.ota_device_groups(m),
        int(rademacher), ref.entry_scale(s_block),
        build.current_stream(y.device))
    build.check(rc, "ota_project_t")
    with build.LAUNCH_LOCK:
        launches_t += 1
    return r
