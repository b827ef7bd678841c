"""Functional counter-based RNG: the port's counterpart of ``jax.random``.

Every draw of the reference is a pure function of a key (``PRNGKey(1000 +
t)`` per round, then fixed ``fold_in`` salts), so the port carries keys as
tensors, never ``torch.Generator`` state.  This module reproduces the bits
of jax's default threefry2x32 PRNG in the mode jax uses by default
(``jax_threefry_partitionable=True``; ``jax/_src/prng.py``):

* ``PRNGKey(seed)``      -> ``[0, seed mod 2**32]``
* ``fold_in(key, data)`` -> ``threefry2x32(key, [0, data])``
* ``split(key, n)``      -> row ``i`` = ``threefry2x32(key, (0, i))`` pair
* ``random_bits``        -> ``hi ^ lo`` of ``threefry2x32(key, (0, i))``
* ``uniform``            -> mantissa fill of the top 23 bits, scaled
* ``normal``             -> ``sqrt(2) * erf_inv(uniform(k, nextafter(-1, 0), 1))``

A key is an int64 tensor of shape ``(2,)`` holding two uint32 words.
uint32 ``+`` and ``>>`` are not implemented for CPU tensors in torch, so
all words are int64 masked to 32 bits; a product or shift of a 32-bit word
stays below 2**63.

Every function also takes a stack of keys, shape ``(..., 2)``, and gives
for each key the bits the same call on that key alone gives (``jax.vmap``
semantics): ``fold_in`` returns ``(..., 2)``, ``split`` ``(..., num, 2)``
and a draw of ``shape`` ``(..., *shape)``.  The words are integers, so the
stacked call is bitwise the per-key one, in one set of launches for all
keys.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 block cipher (20 rounds) on int64-held uint32 words.

    ``k1``/``k2`` are scalars (int or 0-d tensor); ``x1``/``x2`` are the two
    count words, any equal shapes.  Returns the two output words.
    """
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` (32-bit mode): the pair ``[0, seed]``."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def _cipher(key: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """threefry2x32 of each key in ``key (..., 2)`` on the count words
    ``(n,)``: two ``(..., n)`` words (``(n,)`` for a single key)."""
    return threefry2x32(key[..., 0:1], key[..., 1:2], x1, x2)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: a new key from ``key`` and a 32-bit salt."""
    zero = torch.zeros((1,), dtype=torch.int64, device=key.device)
    y1, y2 = _cipher(key, zero, zero + (int(data) & MASK32))
    return torch.cat([y1, y2], dim=-1)


def _counts(n: int, device) -> torch.Tensor:
    if n >= 1 << 32:
        raise NotImplementedError("more than 2**32 draws from one key")
    return torch.arange(n, dtype=torch.int64, device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., num, 2)`` keys."""
    lo = _counts(num, key.device)
    y1, y2 = _cipher(key, torch.zeros_like(lo), lo)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """32-bit ``jax.random.bits``, as int64 words in ``[0, 2**32)``, of shape
    ``(..., *shape)`` for keys ``(..., 2)``."""
    shape = _shape(shape)
    lo = _counts(math.prod(shape), key.device)
    y1, y2 = _cipher(key, torch.zeros_like(lo), lo)
    return (y1 ^ y2).reshape(*key.shape[:-1], *shape)


def _as_f32(words: torch.Tensor) -> torch.Tensor:
    """Reinterpret int64-held uint32 words as float32 bit patterns."""
    signed = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return signed.to(torch.int32).view(torch.float32)


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 fused multiply-add, as XLA contracts ``a*b + c``.

    The float32 product is exact in float64, so only the final sum rounds
    twice (float64, then float32); that differs from a true fma only when
    the float64 sum lands on a float32 tie, about once in 2**29 calls.
    """
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).float()


def uniform(key: torch.Tensor, shape: Shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 ``jax.random.uniform`` on ``[minval, maxval)``."""
    bits = random_bits(key, shape)
    floats = _as_f32((bits >> 9) | 0x3F800000) - 1.0
    # python scalars, not tensors made on the device: a host-to-device copy
    # would wait for the device's queue to drain
    lo = float(np.float32(minval))
    span = float(np.float32(np.float32(maxval) - np.float32(minval)))
    return torch.clamp(fma_f32(floats, span, lo), min=lo)


# XLA's float32 erf_inv (M. Giles, "Approximating the erfinv function"):
# the polynomial chlo.erf_inv lowers to, coefficients highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


# Cephes' rational log1p for |x| < sqrt(2) - 1, which XLA emits for float32
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _horner(coeffs, x: torch.Tensor) -> torch.Tensor:
    r = torch.full_like(x, float(np.float32(coeffs[0])))
    for c in coeffs[1:]:
        r = fma_f32(r, x, float(np.float32(c)))
    return r


# Cephes' logf polynomial as XLA's CPU backend emits it for float32 ``log``
# (``polynomial_approximations.cc``, ``GenerateVF32Log``), lowest degree last
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1 = float(np.float32(-2.12194440e-4))
_LOG_Q2 = float(np.float32(0.693359375))
_SQRT_HALF_F32 = float(np.float32(0.707106781186547524))
_MIN_NORMAL_F32 = float(np.finfo(np.float32).tiny)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log`` as XLA's CPU backend computes it, bit for bit.

    ``x = m * 2**e`` with ``m`` in ``[sqrt(1/2), sqrt(2))``; ``log(m)`` is
    ``t - t**2/2 + t**3 * P(t)`` for ``t = m - 1``, with P's nine
    coefficients in three interleaved Horner chains joined by ``t**3``,
    every ``a*b + c`` fused; then ``e * log(2)`` is added in two parts.
    Neither ``torch.log`` nor a float64 log rounded to float32 gives these
    bits.  Zero and subnormal inputs (which XLA flushes to zero) give
    ``-inf``, ``inf`` gives ``inf`` and a negative input NaN.
    """
    p = [float(np.float32(c)) for c in _LOG_P]
    v = torch.clamp(x, min=_MIN_NORMAL_F32)
    bits = v.view(torch.int32)
    e = ((bits >> 23) & 0xFF).to(torch.float32) - 126.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    low = m < _SQRT_HALF_F32
    e = e - low.to(torch.float32)
    t = (m - 1.0) + torch.where(low, m, 0.0)
    t2 = t * t
    t3 = t2 * t
    y0 = fma_f32(fma_f32(t, p[0], p[1]), t, p[2])
    y1 = fma_f32(fma_f32(t, p[3], p[4]), t, p[5])
    y2 = fma_f32(fma_f32(t, p[6], p[7]), t, p[8])
    y = fma_f32(fma_f32(y0, t3, y1), t3, y2)
    y = fma_f32(y, t3, _LOG_Q1 * e)
    out = ((t - 0.5 * t2) + y) + _LOG_Q2 * e
    finite = (x >= _MIN_NORMAL_F32) & (x < math.inf)
    flushed = torch.where((x > 0) & (x < _MIN_NORMAL_F32), 0.0, x)
    return torch.where(finite, out, torch.log(flushed))


def log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log1p`` following XLA's two branches, bit for bit.

    Below ``sqrt(2) - 1`` the Cephes rational approximation, evaluated with
    XLA's fused multiply-adds; above it ``log(1 + x)`` with XLA's own
    float32 ``log`` (:func:`log_f32`).
    """
    x2 = x * x
    small = (x * x2) * (_horner(_LOG1P_NUM, x) / _horner(_LOG1P_DEN, x))
    small = x + fma_f32(x2, -0.5, small)
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       log_f32(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, following XLA's polynomial.

    ``torch.erfinv`` uses another approximation and differs from XLA on
    most float32 inputs; this one follows XLA op for op, fused
    multiply-adds included.
    """
    w = -log1p(x * -x)
    lt = w < 5.0
    # float32 sqrt through float64, correctly rounded: torch's vectorised
    # float32 sqrt on the CPU is off by an ulp on about 0.5% of inputs
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).to(x.dtype)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma_f32(p, w, torch.where(lt, a, b).to(x.dtype))
    out = p * x
    return torch.where(x.abs() == 1.0, x * math.inf, out)


_NEXT_ABOVE_MINUS_ONE = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))


def normal(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """float32 ``jax.random.normal``."""
    u = uniform(key, shape, _NEXT_ABOVE_MINUS_ONE, 1.0)
    return _SQRT2_F32 * erf_inv(u)
