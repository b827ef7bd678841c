"""Compressive projection of sparsified gradients (paper §IV).

Two realisations, as in the reference's ``repro/core/projection.py``:

* ``DenseProjector`` -- the paper's A in R^{s_tilde x d}, entries
  N(0, 1/s_tilde), drawn once from ``normal(PRNGKey(seed), (s_tilde, d))``
  through the port's jax-exact RNG (PS and devices agree).  Paper scale.
* ``BlockedProjector`` -- block-diagonal A: the flattened gradient is split
  into ``n_blocks`` chunks of ``block_size``; each chunk has an independent
  (s_block x block_size) matrix generated on the fly from a counter hash
  (kernels/).  With ``use_kernel`` the forward product
  (:meth:`BlockedProjector.project`) and its adjoint
  (:meth:`BlockedProjector.project_t`) run in the CUDA kernels
  ``ota_project`` and ``ota_project_t`` on the card.

Every method takes a leading device axis: ``(..., d)`` in, ``(..., out)`` out.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import rng
from repro_torch.device import div_f32, resolve_device
from repro_torch.kernels import ops, ref


@dataclass(frozen=True)
class DenseProjector:
    d: int
    s_tilde: int
    seed: int = 0
    _cache: dict = field(default_factory=dict, init=False, repr=False,
                         compare=False)

    @property
    def out_dim(self) -> int:
        return self.s_tilde

    def matrix(self, device=None) -> torch.Tensor:
        """The shared measurement matrix, drawn once per device; ``None`` is
        the card, as at every entry point.

        ``normal(PRNGKey(seed), (s_tilde, d)) / sqrt(s_tilde)`` with a true
        float32 division, so the card's A is the CPU's bit for bit (the
        reference's bits where the RNG's are).
        """
        dev = resolve_device(device)
        mat = self._cache.get(dev)
        if mat is None:
            mat = div_f32(rng.normal(rng.PRNGKey(self.seed, device=dev),
                                     (self.s_tilde, self.d)),
                          float(np.sqrt(np.float32(self.s_tilde))))
            self._cache[dev] = mat
        return mat

    def project(self, v: torch.Tensor) -> torch.Tensor:
        return v @ self.matrix(v.device).T

    def project_t(self, r: torch.Tensor) -> torch.Tensor:
        return r @ self.matrix(r.device)

    def norm_bound(self) -> float:
        """sigma_max = sqrt(d/s_tilde) + 1 (paper App. A, Bai-Yin)."""
        return float(np.sqrt(np.float32(self.d / self.s_tilde)) + 1.0)


def _chunk_blocks_for(s_block: int, c: int, budget_bytes: int = 128 << 20) -> int:
    """How many blocks' A matrices fit the working-set budget at once."""
    return max(1, budget_bytes // max(s_block * c * 4, 1))


@dataclass(frozen=True)
class BlockedProjector:
    d: int
    block_size: int            # c
    s_block: int               # s_c  (per-block channel uses)
    seed: int = 0
    rademacher: bool = True
    use_kernel: bool = False

    @property
    def n_blocks(self) -> int:
        return -(-self.d // self.block_size)

    @property
    def chunk_blocks(self) -> int:
        return _chunk_blocks_for(self.s_block, self.block_size)

    @property
    def d_pad(self) -> int:
        return self.n_blocks * self.block_size

    @property
    def out_dim(self) -> int:
        return self.n_blocks * self.s_block

    # -- layout ------------------------------------------------------------
    def to_blocks(self, v: torch.Tensor) -> torch.Tensor:
        v = torch.nn.functional.pad(v, (0, self.d_pad - self.d))
        return v.reshape(*v.shape[:-1], self.n_blocks, self.block_size)

    def from_blocks(self, xb: torch.Tensor) -> torch.Tensor:
        return xb.reshape(*xb.shape[:-2], self.d_pad)[..., : self.d]

    # -- ops ----------------------------------------------------------------
    def project(self, v: torch.Tensor) -> torch.Tensor:
        """(..., d) -> (..., n_blocks * s_block) flat projected signal."""
        yb = self.project_blocks(self.to_blocks(v))
        return yb.reshape(*yb.shape[:-2], self.out_dim)

    def project_blocks(self, xb: torch.Tensor) -> torch.Tensor:
        if not self.use_kernel and xb.shape[-2] > self.chunk_blocks:
            return self._scan_op(xb, transpose=False)
        return ops.ota_project(xb.contiguous(), seed=self.seed,
                               s_block=self.s_block,
                               rademacher=self.rademacher,
                               use_kernel=self.use_kernel)

    def project_t(self, y_flat: torch.Tensor) -> torch.Tensor:
        yb = y_flat.reshape(*y_flat.shape[:-1], self.n_blocks, self.s_block)
        return self.from_blocks(self.project_t_blocks(yb))

    def project_t_blocks(self, yb: torch.Tensor) -> torch.Tensor:
        if not self.use_kernel and yb.shape[-2] > self.chunk_blocks:
            return self._scan_op(yb, transpose=True)
        return ops.ota_project_t(yb.contiguous(), seed=self.seed,
                                 c=self.block_size,
                                 rademacher=self.rademacher,
                                 use_kernel=self.use_kernel)

    def _scan_op(self, xb: torch.Tensor, transpose: bool) -> torch.Tensor:
        """Chunked loop: generate each A chunk on the fly and consume it.

        Bounds the A working set to ``chunk_blocks`` blocks, as the
        reference's ``lax.scan`` over chunks does.
        """
        outs = []
        for b0 in range(0, xb.shape[-2], self.chunk_blocks):
            ids = torch.arange(b0, min(b0 + self.chunk_blocks, xb.shape[-2]),
                               dtype=torch.int64, device=xb.device)
            A = ref.block_matrix_ref(self.seed, ids, self.s_block,
                                     self.block_size, self.rademacher)
            x_c = xb[..., b0:b0 + len(ids), :]
            eq = "isc,...is->...ic" if transpose else "isc,...ic->...is"
            outs.append(ref.contract(eq, A, x_c))
        return torch.cat(outs, dim=-2)

    def block_matrix(self, b: int, device=None) -> torch.Tensor:
        """Materialise one block (tests only)."""
        return ref.block_matrix_ref(self.seed, b, self.s_block,
                                    self.block_size, self.rademacher,
                                    device=device)

    def norm_bound(self) -> float:
        return math.sqrt(self.block_size / self.s_block) + 1.0


def make_projector(cfg, d: int):
    """Build the projector described by an OTAConfig for a d-dim gradient."""
    if cfg.projection == "dense":
        s = cfg.s_for(d)
        # analog frame reserves 2 channel uses (mean slot + scale slot)
        return DenseProjector(d=d, s_tilde=max(s - 2, 1), seed=cfg.seed)
    if cfg.projection == "blocked":
        c = cfg.block_size
        s_block = max(2, int(round(cfg.s_frac * c)))
        return BlockedProjector(d=d, block_size=c, s_block=s_block,
                                seed=cfg.seed, rademacher=cfg.rademacher,
                                use_kernel=cfg.use_kernel)
    raise ValueError(f"unknown projection {cfg.projection!r}")
