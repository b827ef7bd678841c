"""Fused single-launch AMP decode on the card.

Replaces the TPU kernel ``repro/kernels/amp_fused.py::amp_decode_fused_pallas``
(body ``_amp_kernel``).  Plain version: the ``use_kernel=False`` branch of
:func:`repro_torch.core.amp.amp_blocked_core`.

What bounds it on an H100: operations.  A decode of ``iters`` iterations
makes ``2 * iters + 1`` products with each block's A (the adjoint and the
forward product per iteration, then the debias), about
``2 * (2 * iters + 1) * s * c`` FLOPs per block, plus the integer hash of
A's entries, while only y in and x out touch device memory.  The Pallas
kernel keeps a chunk's A in VMEM; on Hopper one block's A (16 MiB at
1024 x 4096) is far beyond the 227 KB of shared memory.  So the CUDA kernel
(``csrc/amp_fused.cu``) runs one CTA per block, keeps x, z, y and the row
hashes resident in shared memory for the whole decode, and regenerates A
from the hash in every product.  Its reductions are deterministic, so a
sub-range decoded with ``id_offset`` equals the full decode's rows bitwise.
At the main path's two blocks it occupies 2 of the card's 132 SMs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

#: launches of the CUDA kernel since the last reset
launches = 0


def amp_decode_fused(yb: torch.Tensor, seed, c: int, *, iters: int = 20,
                     threshold_mult: float = 1.3, debias: bool = True,
                     rademacher: bool = True, id_offset=0,
                     chunk_blocks: int = 8) -> torch.Tensor:
    """Decode yb: (n_blocks, s_block) -> xb: (n_blocks, c) in one launch.

    ``seed`` and ``id_offset`` (global id of the first block) are ints or
    int64-held uint32 tensors.  CPU tensors take the plain version, chunked
    by ``chunk_blocks``; CUDA tensors launch the kernel.
    """
    if yb.device.type == "cpu":
        from repro_torch.core.amp import amp_blocked_core
        return amp_blocked_core(yb, seed, c, iters, chunk_blocks,
                                threshold_mult, debias, rademacher,
                                id_offset=id_offset, use_kernel=False)
    return _launch(yb, seed, c, iters, threshold_mult, debias, rademacher,
                   id_offset)


def _launch(yb: torch.Tensor, seed, c: int, iters: int, threshold_mult: float,
            debias: bool, rademacher: bool, id_offset) -> torch.Tensor:
    global launches
    build.require_cuda_f32("amp_decode_fused", yb=yb)
    if yb.dim() != 2:
        raise ValueError(f"amp_decode_fused: yb must be (n_blocks, s_block), "
                         f"got {tuple(yb.shape)}")
    n_blocks, s_block = yb.shape
    lib = build.library()
    smem = lib.amp_fused_smem_bytes(s_block, c)
    if smem > 232448:
        raise ValueError(f"amp_decode_fused: a {s_block} x {c} block needs "
                         f"{smem} bytes of shared memory, above 227 KB")
    xb = torch.empty(n_blocks, c, dtype=torch.float32, device=yb.device)
    seed_dev = build.device_u32(seed, yb.device)
    offset_dev = build.device_u32(id_offset, yb.device)
    rc = lib.amp_fused_launch(
        yb.data_ptr(), seed_dev.data_ptr(), offset_dev.data_ptr(),
        xb.data_ptr(), n_blocks, s_block, c, int(iters), float(threshold_mult),
        int(debias), int(rademacher), ref.entry_scale(s_block),
        torch.cuda.current_stream(yb.device).cuda_stream)
    build.check(rc, "amp_decode_fused")
    launches += 1
    return xb
