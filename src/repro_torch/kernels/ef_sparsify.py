"""Fused error feedback + threshold sparsification on the card.

Replaces the TPU kernel ``repro/kernels/ef_sparsify.py::ef_sparsify_pallas``
(body ``_kernel``).  Plain version: :func:`repro_torch.kernels.ref.ef_sparsify_ref`.

What bounds it on an H100: bytes.  Per entry it reads ``g`` and ``delta``
and writes ``g_sp`` and ``delta'`` (16 bytes) against one add, one compare
and one subtract.  The CUDA kernel (``csrc/ef_sparsify.cu``) makes that one
pass over device memory for all M device rows in one launch, with a
threshold per row read from device memory (it comes from the on-device
quantile, so the host never waits for it), and masks the ragged tail of a
row instead of copying into a padded buffer.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

#: launches of the CUDA kernel since the last reset
launches = 0


def ef_sparsify(g: torch.Tensor, delta: torch.Tensor, tau: torch.Tensor):
    """g, delta: (..., n) float32; tau: (...) -- one threshold per row.

    Returns ``(g_sp, new_delta)``.  CPU tensors take the plain version; CUDA
    tensors launch the kernel.
    """
    if g.device.type == "cpu":
        return ref.ef_sparsify_ref(g, delta, tau)
    return _launch(g, delta, tau)


def _launch(g: torch.Tensor, delta: torch.Tensor, tau: torch.Tensor):
    global launches
    build.require_cuda_f32("ef_sparsify", g=g, delta=delta, tau=tau)
    if delta.shape != g.shape or tau.shape != g.shape[:-1]:
        raise ValueError(f"ef_sparsify: shapes g {tuple(g.shape)}, delta "
                         f"{tuple(delta.shape)}, tau {tuple(tau.shape)}")
    n = g.shape[-1]
    m = g.numel() // n if n else 0
    g_sp = torch.empty_like(g)
    new_delta = torch.empty_like(g)
    rc = build.library().ef_sparsify_launch(
        g.data_ptr(), delta.data_ptr(), tau.data_ptr(), g_sp.data_ptr(),
        new_delta.data_ptr(), m, n, torch.cuda.current_stream(g.device).cuda_stream)
    build.check(rc, "ef_sparsify")
    launches += 1
    return g_sp, new_delta
