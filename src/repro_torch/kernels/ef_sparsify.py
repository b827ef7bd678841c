"""Fused error feedback + threshold sparsification on the card.

Replaces the TPU kernel ``repro/kernels/ef_sparsify.py::ef_sparsify_pallas``
(body ``_kernel``).  Plain version: :func:`repro_torch.kernels.ref.ef_sparsify_ref`.

What bounds it on an H100: bytes.  Per entry it reads ``g`` and ``delta``
and writes ``g_sp`` and ``delta'`` (16 bytes) against one add, one compare
and one subtract.  The CUDA kernel (``csrc/ef_sparsify.cu``) makes that one
pass over device memory for all M device rows in one launch: the rows are
one flat array, each thread moves four floats per access, and takes each
entry's threshold from device memory by its row (the threshold comes from
the on-device quantile, so the host never waits for it).  The head and tail
of the flat range, where rows of odd length leave it off 16-byte alignment,
are masked single entries instead of a copy into a padded buffer.

At the main path's 25 x 7850 the kernel's work is about a microsecond, less
than the wrapper's host time, so the wrapper does no more host work than
the checks, two ``empty_like`` and the launch.
"""
from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.kernels import build, cost, ref


def ef_sparsify(g: torch.Tensor, delta: torch.Tensor, tau: torch.Tensor):
    """g, delta: (..., n) float32; tau: (...) -- one threshold per row.

    Returns ``(g_sp, new_delta)``.  CPU tensors take the plain version; CUDA
    tensors launch the kernel; ``meta`` tensors (a dry run's trace) get
    outputs of the kernel's shapes and their counts go to the active
    counter (:mod:`repro_torch.kernels.cost`).
    """
    if g.device.type == "cpu":
        return ref.ef_sparsify_ref(g, delta, tau)
    if g.device.type == "meta":
        return _trace(g, delta, tau)
    return _launch(g, delta, tau)


def _check_shapes(g, delta, tau):
    if delta.shape != g.shape or tau.shape != g.shape[:-1]:
        raise ValueError(f"ef_sparsify: shapes g {tuple(g.shape)}, delta "
                         f"{tuple(delta.shape)}, tau {tuple(tau.shape)}")


def _rows(g: torch.Tensor):
    n = g.shape[-1]
    return (g.numel() // n if n else 0), n


def _trace(g: torch.Tensor, delta: torch.Tensor, tau: torch.Tensor):
    build.require_meta_f32("ef_sparsify", g=g, delta=delta, tau=tau)
    _check_shapes(g, delta, tau)
    cost.record("ef_sparsify", cost.ef_sparsify(*_rows(g)))
    return torch.empty_like(g), torch.empty_like(g)


def _launch(g: torch.Tensor, delta: torch.Tensor, tau: torch.Tensor):
    build.require_cuda_f32("ef_sparsify", g=g, delta=delta, tau=tau)
    _check_shapes(g, delta, tau)
    m, n = _rows(g)
    g_sp = torch.empty_like(g)
    new_delta = torch.empty_like(g)
    rc = build.library().ef_sparsify_launch(
        g.data_ptr(), delta.data_ptr(), tau.data_ptr(), g_sp.data_ptr(),
        new_delta.data_ptr(), m, n, build.current_stream(g.device))
    build.check(rc, "ef_sparsify")
    tracing.count("launches.ef_sparsify")
    return g_sp, new_delta
