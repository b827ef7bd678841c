"""Public kernel ops: the port's counterpart of ``repro/kernels/ops.py``.

``use_kernel=True`` routes through the hand-written CUDA kernel for a CUDA
tensor and through the kernel's plain version for a CPU tensor; the choice
follows the tensor's device, and there is no fallback: on the card the
kernel launches or the call raises.  ``use_kernel=False`` keeps the
reference's meaning, the plain ops path, on any device.

``seed`` and ``id_offset`` are ints or int64-held uint32 tensors; the
kernels read them, and the threshold ``tau``, from device memory.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import amp_fused, ef_sparsify as _ef, ota_project as _otp
from repro_torch.kernels import ref


def ota_project(x: torch.Tensor, *, seed, s_block: int,
                rademacher: bool = True, use_kernel: bool = False):
    """Blocked forward projection. x: (..., n_blocks, c) -> (..., n_blocks, s_block)."""
    if use_kernel:
        return _otp.ota_project(x, seed, s_block, rademacher)
    return ref.ota_project_ref(x, seed, s_block, rademacher)


def ota_project_t(y: torch.Tensor, *, seed, c: int,
                  rademacher: bool = True, use_kernel: bool = False):
    """Blocked transpose projection. y: (..., n_blocks, s_block) -> (..., n_blocks, c)."""
    if use_kernel:
        return _otp.ota_project_t(y, seed, c, rademacher)
    return ref.ota_project_t_ref(y, seed, c, rademacher)


def amp_decode_fused(yb: torch.Tensor, *, seed, c: int, iters: int,
                     threshold_mult: float = 1.3, debias: bool = True,
                     rademacher: bool = True, nb_tile: int | None = None,
                     id_offset=0):
    """Single-launch fused AMP decode (kernels/amp_fused.py).

    ``nb_tile`` only chunks the plain version on the CPU; the CUDA kernel
    decodes one block per CTA.
    """
    return amp_fused.amp_decode_fused(
        yb, seed, c, iters=iters, threshold_mult=threshold_mult,
        debias=debias, rademacher=rademacher, id_offset=id_offset,
        chunk_blocks=nb_tile or 8)


def ef_sparsify(g: torch.Tensor, delta: torch.Tensor, tau, *,
                use_kernel: bool = False):
    """Fused error-feedback + threshold sparsify. Returns (g_sp, new_delta)."""
    if use_kernel:
        return _ef.ef_sparsify(g, delta, tau)
    return ref.ef_sparsify_ref(g, delta, tau)


def launch_counts() -> dict:
    """Launches of each CUDA kernel since the last :func:`reset_launches`."""
    return {"ef_sparsify": _ef.launches, "ota_project": _otp.launches,
            "ota_project_t": _otp.launches_t, "amp_fused": amp_fused.launches}


def reset_launches() -> None:
    _ef.launches = 0
    _otp.launches = 0
    _otp.launches_t = 0
    amp_fused.launches = 0
