"""Blocked compressive projection and its adjoint on the card, A generated
in the kernel.

The forward product replaces the TPU kernel
``repro/kernels/ota_project.py::ota_project_pallas`` (body ``_fwd_kernel``,
helpers ``_tile_A`` and ``_splitmix32``).  Plain version:
:func:`repro_torch.kernels.ref.ota_project_ref`.

What bounds it on an H100: operations.  ``y[m, b] = A_b x[m, b]`` moves
only x and y through device memory, while every entry of A_b (16 MiB per
block at the main path's 1024 x 4096) is made from about ten integer
operations of the hash and then takes one multiply-add per device.  The
CUDA kernel (``csrc/ota_project.cu``) never stores A: a CTA makes each entry
of its 32-row tile once and applies it to all M devices' vectors, which
it stages in shared memory, so the hash is paid once per entry and not
once per device.

The adjoint replaces ``ota_project_t_pallas`` (body ``_t_kernel``) of the
same TPU module.  Plain version: :func:`repro_torch.kernels.ref.ota_project_t_ref`.
It is bound by operations too: ``r[m, b] = A_b^T y[m, b]`` makes every entry
of A_b from the hash and applies it to M devices, about
``entries * (HASH_OPS + 2 M)`` operations against ``4 M (s_block + c)``
bytes per block.  The CUDA kernel (``csrc/ota_project_t.cu``) gives each
thread one column of A_b and the CTA the row hashes and its devices' y,
staged in shared memory: each entry is made once per CTA, each thread sums
its column's rows in ascending order in float64 and rounds once, so the
result needs no reduction across threads and no atomics.  It runs on the
projector's adjoint (``BlockedProjector.project_t``) and so once per
iteration of the launch-per-op AMP decode (``amp_decode_blocked``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

#: launches of the forward CUDA kernel since the last reset
launches = 0
#: launches of the adjoint CUDA kernel since the last reset
launches_t = 0


def ota_project(x: torch.Tensor, seed, s_block: int,
                rademacher: bool = True) -> torch.Tensor:
    """x: (..., n_blocks, c) -> (..., n_blocks, s_block).

    ``seed`` is an int or an int64-held uint32 tensor.  CPU tensors take the
    plain version; CUDA tensors launch the kernel.
    """
    if x.device.type == "cpu":
        return ref.ota_project_ref(x, seed, s_block, rademacher)
    return _launch(x, seed, s_block, rademacher)


def _launch(x: torch.Tensor, seed, s_block: int,
            rademacher: bool) -> torch.Tensor:
    global launches
    build.require_cuda_f32("ota_project", x=x)
    if x.dim() < 2:
        raise ValueError(f"ota_project: x must be (..., n_blocks, c), got "
                         f"{tuple(x.shape)}")
    n_blocks, c = x.shape[-2:]
    m = x.numel() // (n_blocks * c) if n_blocks * c else 0
    y = torch.empty(*x.shape[:-1], s_block, dtype=torch.float32,
                    device=x.device)
    seed_dev = build.device_u32(seed, x.device)
    rc = build.library().ota_project_launch(
        x.data_ptr(), seed_dev.data_ptr(), y.data_ptr(), m, n_blocks, c,
        s_block, int(rademacher), ref.entry_scale(s_block),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "ota_project")
    launches += 1
    return y


def ota_project_t(y: torch.Tensor, seed, c: int,
                  rademacher: bool = True) -> torch.Tensor:
    """y: (..., n_blocks, s_block) -> (..., n_blocks, c).

    ``seed`` is an int or an int64-held uint32 tensor.  CPU tensors take the
    plain version; CUDA tensors launch the kernel.
    """
    if y.device.type == "cpu":
        return ref.ota_project_t_ref(y, seed, c, rademacher)
    return _launch_t(y, seed, c, rademacher)


def _launch_t(y: torch.Tensor, seed, c: int, rademacher: bool) -> torch.Tensor:
    global launches_t
    build.require_cuda_f32("ota_project_t", y=y)
    if y.dim() < 2 or c <= 0:
        raise ValueError(f"ota_project_t: y must be (..., n_blocks, s_block) "
                         f"and c positive, got {tuple(y.shape)}, c={c}")
    n_blocks, s_block = y.shape[-2:]
    m = y.numel() // (n_blocks * s_block) if n_blocks * s_block else 0
    r = torch.empty(*y.shape[:-1], c, dtype=torch.float32, device=y.device)
    seed_dev = build.device_u32(seed, y.device)
    rc = build.library().ota_project_t_launch(
        y.data_ptr(), seed_dev.data_ptr(), r.data_ptr(), m, n_blocks, s_block,
        c, int(rademacher), ref.entry_scale(s_block),
        torch.cuda.current_stream(y.device).cuda_stream)
    build.check(rc, "ota_project_t")
    launches_t += 1
    return r
