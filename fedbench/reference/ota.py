"""Plain reference of the A-DSGD aggregation over the Gaussian MAC (Amiri
and Gündüz): per device, error feedback and top-k sparsification, the
blocked pseudo-random projection and the power-scaled analog frame; the
sum of the frames plus AWGN; at the PS, normalisation and an approximate
message passing (AMP) decode per block.

Written from the scheme's equations; the measurement matrix of block ``b``
is ``A_b[i, j] = ±1/sqrt(s)``, its sign the top bit of the lowbias32 hash
chain of ``(seed, b, i, j)``.  Every product with A is a plain batched
matrix product over the blocks, summed in float64 and rounded once to
float32 (``precision="float64"``), or taken from TF32-rounded inputs with
float32 sums (``precision="tf32"``), the precision the correctness
control computes in.  The other reductions follow float32 as configured.
"""
from __future__ import annotations

import numpy as np
import torch

from fedbench.reference import rng

MASK32 = 0xFFFFFFFF
_GOLDEN, _M1, _M2 = 0x9E3779B9, 0x21F0AAAD, 0x735A2D97
#: blocks of A made at once: 64 blocks of 1024 x 4096 are 1 GiB in float32
BLOCK_GROUP = 64
#: chunks whose channel noise is drawn at once (16 x 2**20 draws)
NOISE_GROUP = 16


def splitmix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 on int64-held uint32 words; the first add makes a new
    tensor and the other steps write into it."""
    x = x + _GOLDEN
    x &= MASK32
    x ^= x >> 16
    x *= _M1
    x &= MASK32
    x ^= x >> 15
    x *= _M2
    x &= MASK32
    x ^= x >> 15
    return x


def block_matrices(seed: int, b0: int, n: int, s: int, c: int,
                   device) -> torch.Tensor:
    """Blocks ``b0 .. b0 + n - 1`` of A, ``(n, s, c)`` float32."""
    blk = torch.arange(b0, b0 + n, dtype=torch.int64, device=device)
    rows = torch.arange(s, dtype=torch.int64, device=device)
    cols = torch.arange(c, dtype=torch.int64, device=device)
    hb = splitmix32((seed & MASK32) ^ blk)
    hr = splitmix32(hb[:, None] ^ rows[None, :])
    h = splitmix32(hr[:, :, None] ^ cols[None, None, :])
    scale = float(np.float32(1.0 / np.sqrt(s)))
    return (h >> 31).to(torch.float32).mul_(-2.0).add_(1.0).mul_(scale)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest, ties to
    even: what a TF32 tensor core reads."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def product(v: torch.Tensor, A: torch.Tensor, precision: str,
            transpose: bool) -> torch.Tensor:
    """``v @ A^T`` (``transpose``) or ``v @ A`` per block: ``v`` is
    ``(n, rows, c)`` against ``A`` ``(n, s, c)``, or ``(n, rows, s)``."""
    if precision == "float64":
        a = A.double()
        out = v.double() @ (a.transpose(1, 2) if transpose else a)
        return out.float()
    if precision == "tf32":
        a = tf32(A)
        return tf32(v) @ (a.transpose(1, 2) if transpose else a)
    raise ValueError(f"unknown precision {precision!r}")


def quantile(a: torch.Tensor, q: float) -> torch.Tensor:
    """Linear-interpolation quantile of each row (numpy's default), the
    first product fused into the add."""
    n = a.shape[-1]
    srt = torch.sort(a, dim=-1).values
    h = np.float32(np.float32(q) * np.float32(n - 1))
    lo_i = int(np.clip(np.floor(h), 0, n - 1))
    hi_i = int(np.clip(np.ceil(h), 0, n - 1))
    w = np.float32(h - np.floor(h))
    out = rng.fma_f32(srt[..., lo_i], float(np.float32(1.0) - w),
                      srt[..., hi_i] * float(w))
    return torch.where(torch.isnan(a).any(dim=-1), float("nan"), out)


def threshold(v: torch.Tensor, k: int, n_samples: int = 1 << 16):
    """The k-th largest |v| of each row, estimated from a strided sample."""
    d = v.shape[-1]
    n = min(n_samples, d)
    stride = d // n
    sample = v.abs() if stride <= 1 else v[..., 0:n * stride:stride].abs()
    return quantile(sample, 1.0 - (k / d))


def sparsify(g: torch.Tensor, delta: torch.Tensor, k: int):
    """Error feedback and sparsification: ``g + delta`` keeps its entries
    at or above the row's threshold; the rest is the new error state."""
    tau = threshold(g + delta, k)
    ec = g + delta
    sp = torch.where(ec.abs() >= tau[..., None], ec, 0.0)
    return sp, ec - sp


def frame(g_tilde: torch.Tensor, p_t: torch.Tensor, mean_removal: bool):
    """The analog frame ``sqrt(a) [g~ - mu, mu, 1]`` of each device's
    projection, with ``a = P_t / (||g~||^2 - (s - 1) mu^2 + 1)``."""
    s = g_tilde.shape[-1]
    mu = float(mean_removal) * g_tilde.mean(dim=-1, keepdim=True)
    energy = (g_tilde * g_tilde).sum(dim=-1, keepdim=True) \
        - (s - 1) * mu * mu + 1.0
    alpha = p_t[..., None] / torch.clamp(energy, min=1e-12)
    ra = torch.sqrt(alpha)
    return torch.cat([ra * (g_tilde - mu), ra * mu, ra], dim=-1)


def noise(keys: torch.Tensor, n: int, sigma2: float) -> torch.Tensor:
    """AWGN of variance ``sigma2``, ``n`` entries for each key of a stack
    ``(k, 2)`` (each row the draw its key alone gives)."""
    return float(np.sqrt(np.float32(sigma2))) * rng.normal(keys, (n,))


def receive(frames: torch.Tensor, z: torch.Tensor,
            mean_removal: bool) -> torch.Tensor:
    """The MAC's sum of the frames plus the noise ``z``, and the PS's
    normalisation by the received scale slot."""
    y = frames.sum(dim=-2) + z
    body, mu_slot, scale_slot = y[:-2], y[-2:-1], y[-1:]
    scale = torch.where(scale_slot > 1e-3, scale_slot, 1.0)
    return (body + float(mean_removal) * mu_slot) / scale


def _dot64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.double() * b.double()).sum(dim=-1, keepdim=True)


def amp(y: torch.Tensor, A: torch.Tensor, iters: int, precision: str,
        threshold_mult: float = 1.3) -> torch.Tensor:
    """Soft-threshold AMP with the Onsager term and a clamped least-squares
    debias, one independent decode per block and row.

    ``y``: ``(n, rows, s)`` observations of ``n`` blocks of A ``(n, s,
    c)``; returns ``(n, rows, c)``.  The norms and the debias dots are
    summed in float64 and rounded once."""
    s = y.shape[-1]
    sqrt_s = float(np.sqrt(np.float32(s)))
    x = torch.zeros(y.shape[:-1] + (A.shape[-1],), dtype=torch.float32,
                    device=y.device)
    z = y
    for _ in range(iters):
        sigma = rng.div_f32(torch.sqrt(_dot64(z, z)).float(), sqrt_s)
        r = x + product(z, A, precision, transpose=False)
        x = torch.sign(r) * torch.clamp(r.abs() - threshold_mult * sigma,
                                        min=0.0)
        onsager = z * rng.div_f32((x != 0.0).sum(dim=-1, keepdim=True), s)
        z = y - product(x, A, precision, transpose=True) + onsager
    ax = product(x, A, precision, transpose=True)
    factor = _dot64(ax, y) / torch.clamp(_dot64(ax, ax), min=1e-12)
    return x * torch.clamp(factor.float(), 1.0, 2.0)
