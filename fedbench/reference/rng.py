"""The RNG of the plain reference: jax's default threefry2x32, bit for bit.

A frozen copy of the draws the measured program makes from its seed
(``PRNGKey``, ``fold_in``, ``split``, the uniform, normal, truncated normal
and integer draws) with the float32 transcendental functions XLA uses for
them (``log1p``, ``erf_inv``, ``pow``).  It is copied rather than imported
so that a change to the program's RNG cannot change what the benchmark
holds it against.  Keys are int64 tensors of two uint32 words; uint32
arithmetic runs on int64 words masked to 32 bits.
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


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: a new key from ``key`` and a 32-bit salt.

    ``data`` is an ``int`` or an integer tensor of salts: a tensor of shape
    ``S`` folds every salt into every key in one set of launches and gives
    ``(..., *S, 2)``, the keys that ``fold_in`` of each salt alone gives
    (``jax.vmap(fold_in, (None, 0))``).
    """
    if isinstance(data, torch.Tensor):
        salts = data.to(device=key.device, dtype=torch.int64) & MASK32
        y1, y2 = _cipher(key, torch.zeros_like(salts).reshape(-1),
                         salts.reshape(-1))
        return torch.stack([y1, y2], dim=-1).reshape(
            *key.shape[:-1], *salts.shape, 2)
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


def _two_sum(a: torch.Tensor, b):
    """``(s, e)`` with ``s = fl(a + b)`` and ``a + b = s + e`` exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


#: a float64 on a float32 midpoint (a normal float32) has exactly bit 28
#: set among its low 29 mantissa bits
_F32_MIDPOINT_MASK, _F32_MIDPOINT_BITS = (1 << 29) - 1, 1 << 28


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 fused multiply-add ``a*b + c`` rounded once, as XLA contracts
    ``a*b + c`` on the CPU (and as ``__fmaf_rn`` computes it).

    The float32 product is exact in float64, so only the sum rounds.  The
    float64 sum ``s`` is exact but where it lands on the midpoint of two
    float32 values (its low 29 mantissa bits ``1 << 28``); there ``s``'s
    own rounding error (TwoSum, exact in float64) says on which side of
    the midpoint the true sum lies, and ``s`` moves one float64 ulp that
    way before it rounds to float32.  An exact midpoint keeps float32's
    ties-to-even.  Midpoints of float32 subnormals are not detected (XLA
    flushes those to zero).
    """
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    s, err = _two_sum(a.double() * b, c)
    tie = (s.view(torch.int64) & _F32_MIDPOINT_MASK) == _F32_MIDPOINT_BITS
    nudge = torch.nextafter(s, torch.copysign(torch.full_like(s, math.inf),
                                              err))
    return torch.where(tie & (err != 0), nudge, s).float()


def div_f32(t: torch.Tensor, n) -> torch.Tensor:
    """``t / n`` as a true float32 division on every device: a scalar ``n``
    is held in a 0-dim float32 tensor on ``t``'s device (a CUDA tensor
    divided by a python scalar is multiplied by its reciprocal)."""
    if isinstance(n, torch.Tensor):
        return t / n
    return t / torch.full((), n, dtype=torch.float32, device=t.device)


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


# input clamp, ``log2(e)``, ``log(2)`` in two parts, then the polynomial,
# lowest degree last
# glibc's powf (the FMA build that XLA's CPU backend calls for float32
# ``pow``): log2(x) from a 16-entry table of (1/c, log2(c)) and a degree-5
# polynomial, then exp2 from a 32-entry table of 2**(i/32) and a cubic, all
# in float64 with fused multiply-adds; the constants are glibc's, in C99 hex
_POWF_LOG2_TAB = (
    ("0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2"),
    ("0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2"),
    ("0x1.49539f0f010b0p+0", "-0x1.7418b0a1fb77bp-2"),
    ("0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2"),
    ("0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2"),
    ("0x1.25e227b0b8ea0p+0", "-0x1.97c1d1b3b7af0p-3"),
    ("0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3"),
    ("0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4"),
    ("0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5"),
    ("0x1.0000000000000p+0", 0.0),
    ("0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4"),
    ("0x1.ca4b31f026aa0p-1", "0x1.476a9543891bap-3"),
    ("0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3"),
    ("0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2"),
    ("0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2"),
    ("0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2"),
)
_POWF_LOG2_POLY = ("0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2",
                   "0x1.ec70a6ca7baddp-2", "-0x1.7154748bef6c8p-1",
                   "0x1.71547652ab82bp+0")
_POWF_EXP2_TAB = (
    0x3ff0000000000000, 0x3fefd9b0d3158574, 0x3fefb5586cf9890f,
    0x3fef9301d0125b51, 0x3fef72b83c7d517b, 0x3fef54873168b9aa,
    0x3fef387a6e756238, 0x3fef1e9df51fdee1, 0x3fef06fe0a31b715,
    0x3feef1a7373aa9cb, 0x3feedea64c123422, 0x3feece086061892d,
    0x3feebfdad5362a27, 0x3feeb42b569d4f82, 0x3feeab07dd485429,
    0x3feea47eb03a5585, 0x3feea09e667f3bcd, 0x3fee9f75e8ec5f74,
    0x3feea11473eb0187, 0x3feea589994cce13, 0x3feeace5422aa0db,
    0x3feeb737b0cdc5e5, 0x3feec49182a3f090, 0x3feed503b23e255d,
    0x3feee89f995ad3ad, 0x3feeff76f2fb5e47, 0x3fef199bdd85529c,
    0x3fef3720dcef9069, 0x3fef5818dcfba487, 0x3fef7c97337b9b5f,
    0x3fefa4afa2a490da, 0x3fefd0765b6e4540,
)
_POWF_EXP2_SHIFT = "0x1.8p+47"
_POWF_EXP2_POLY = ("0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3",
                   "0x1.62e42ff0c52d6p-1")
_POWF_OVERFLOW = 127.99999995700433


def _hex(v):
    return tuple(_hex(u) for u in v) if isinstance(v, tuple) else (
        float.fromhex(v) if isinstance(v, str) else float(v))


_POWF_LOG2_TAB, _POWF_LOG2_POLY, _POWF_EXP2_POLY = (
    _hex(_POWF_LOG2_TAB), _hex(_POWF_LOG2_POLY), _hex(_POWF_EXP2_POLY))
_POWF_EXP2_SHIFT = _hex(_POWF_EXP2_SHIFT)


def _split(a: torch.Tensor):
    """Veltkamp's split of a float64 into two halves of 26 bits."""
    t = a * 134217729.0  # 2**27 + 1
    hi = t - (t - a)
    return hi, a - hi


def _fma_f64(a: torch.Tensor, b, c) -> torch.Tensor:
    """float64 fused multiply-add ``a*b + c`` rounded once, on float64 ops
    alone (torch has no fma): Dekker's exact product, then the correctly
    rounded sum of its two parts and ``c`` by rounding to odd (Boldo and
    Melquiond, "Emulation of FMA and correctly rounded sums", 2008)."""
    b = torch.as_tensor(b, dtype=torch.float64, device=a.device)
    c = torch.as_tensor(c, dtype=torch.float64, device=a.device)
    ph = a * b
    ahi, alo = _split(a)
    bhi, blo = _split(b)
    pl = ((ahi * bhi - ph) + ahi * blo + alo * bhi) + alo * blo
    uh, ul = _two_sum(pl, c)
    th, tl = _two_sum(ph, uh)
    v, err = _two_sum(tl, ul)
    # round v to odd: an inexact sum with an even last bit moves one ulp
    # toward the exact sum
    even = (v.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(torch.float64)
    v = torch.where((err != 0) & even, torch.nextafter(v, toward), v)
    return th + v


def pow_f32(x: torch.Tensor, y) -> torch.Tensor:
    """float32 ``x ** y`` as XLA's CPU backend computes it, bit for bit.

    XLA calls glibc's ``powf`` with subnormals flushed to zero; this is that
    routine's main path on torch float64 ops, which round alike on every
    device, its fused multiply-adds emulated exactly (:func:`_fma_f64`).  Covered: normal finite ``x`` of either sign (a negative ``x``
    needs an integer ``y``, else NaN), ``x = 0``, ``x = 1`` and ``y = 0``;
    results below the smallest normal float32 flush to zero.  Infinite or
    NaN operands take ``torch.pow``'s IEEE answer.
    """
    y = torch.as_tensor(y, dtype=torch.float32, device=x.device)
    x, y = torch.broadcast_tensors(x, y)
    dev = x.device
    ix = x.view(torch.int32).to(torch.int64) & MASK32
    ax = ix & 0x7FFFFFFF
    yd = y.double()
    y_int = torch.floor(y) == y
    y_odd = y_int & (torch.fmod(torch.abs(yd), 2.0) == 1.0)
    neg = ix >= 0x80000000
    # log2(|x|) for a normal |x|: |x| = 2**k * z, z near the table's c
    tmp = ax - 0x3F330000
    i = (tmp >> 19) & 0xF
    top = tmp & 0xFF800000
    iz = (ax - top) & MASK32
    k = torch.where(top >= 1 << 31, top - (1 << 32), top) >> 23
    tab = torch.tensor(_POWF_LOG2_TAB, dtype=torch.float64, device=dev)
    invc, logc = tab[i, 0], tab[i, 1]
    z = iz.to(torch.int32).view(torch.float32).double()
    r = _fma_f64(z, invc, -1.0)
    a = _POWF_LOG2_POLY
    y0 = logc + k.double()
    r2 = r * r
    q = _fma_f64(r, a[4], y0)
    q = _fma_f64(r2, _fma_f64(r, a[2], a[3]), q)
    logx = _fma_f64(_fma_f64(r, a[0], a[1]), r2 * r2, q)
    ylogx = yd * logx
    # exp2(ylogx) = 2**(n/32) * 2**r, r in [-1/64, 1/64]
    kd = ylogx + _POWF_EXP2_SHIFT
    ki = kd.view(torch.int64)
    kd = kd - _POWF_EXP2_SHIFT
    r = ylogx - kd
    t = torch.tensor(_POWF_EXP2_TAB, dtype=torch.int64, device=dev)[ki & 31]
    s = (t + (ki << 47)).view(torch.float64)
    c = _POWF_EXP2_POLY
    e = _fma_f64(_fma_f64(r, c[0], c[1]), r * r, _fma_f64(r, c[2], 1.0))
    out = (e * s).float()
    out = torch.where(ylogx > _POWF_OVERFLOW, math.inf, out)
    # underflow (glibc's own branch below -150, the flush above it)
    out = torch.where((out.abs() < _MIN_NORMAL_F32) | (ylogx <= -150.0),
                      0.0, out)
    out = torch.where(neg & y_odd, -out, out)
    out = torch.where(neg & ~y_int, math.nan, out)
    # zero, one, y = 0 and the non-finite operands
    zero = ax == 0
    at_zero = torch.where(y > 0, torch.where(neg & y_odd, -0.0, 0.0),
                          math.inf)
    at_zero = torch.where(y < 0, torch.where(neg & y_odd, -math.inf,
                                             math.inf), at_zero)
    out = torch.where(zero, at_zero.to(torch.float32), out)
    special = ~torch.isfinite(x) | ~torch.isfinite(y)
    out = torch.where(special, torch.pow(x, y), out)
    return torch.where((y == 0) | (x == 1.0), 1.0, out)


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


def normal_over_sqrt2(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``erf_inv(u)``, the draw of ``jax.random.normal`` before its factor
    ``sqrt(2)``, which XLA moves onto a constant or traced scale that
    multiplies the draw (:func:`normal_scaled`)."""
    return erf_inv(uniform(key, shape, _NEXT_ABOVE_MINUS_ONE, 1.0))


def normal(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """float32 ``jax.random.normal``."""
    return _SQRT2_F32 * normal_over_sqrt2(key, shape)


def randint(key: torch.Tensor, shape: Shape, minval: int,
            maxval: int) -> torch.Tensor:
    """int32 ``jax.random.randint`` on ``[minval, maxval)``, bit for bit.

    jax splits the key in two, draws 32 random bits from each and reduces
    the pair by the span with a modular multiplier, in uint32 arithmetic
    that wraps: ``((hi % span) * mult + lo % span) % span`` with ``mult =
    (2**16 % span)**2 % span``, each product taken modulo 2**32.
    Integers only, so it is exact on every device.  ``minval`` and
    ``maxval`` are python ints within int32; ``maxval <= minval`` gives
    ``minval``.
    """
    shape = _shape(shape)
    k1, k2 = split(key, 2).unbind(-2)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    span = (maxval - minval) & MASK32 if maxval > minval else 1
    mult = ((((1 << 16) % span) ** 2) & MASK32) % span
    off = (((hi % span) * mult) & MASK32) + lo % span
    off = (off & MASK32) % span
    out = (minval + off) & MASK32
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


def truncated_normal(key: torch.Tensor, lower: float, upper: float,
                     shape: Shape) -> torch.Tensor:
    """float32 ``jax.random.truncated_normal(key, lower, upper, shape)``.

    ``sqrt(2) * erf_inv(u)`` for ``u`` uniform on ``[erf(lower / sqrt(2)),
    erf(upper / sqrt(2)))``, clipped to the open interval ``(lower,
    upper)``.  The two bounds of ``u`` are float32 scalars; XLA's ``erf``
    gives the correctly rounded value at ``±2 / sqrt(2)``, the bounds the
    models draw with, and the port takes them from a float64 ``erf``.
    """
    sqrt2 = np.float32(np.sqrt(2))
    a = np.float32(math.erf(float(np.float32(lower) / sqrt2)))
    b = np.float32(math.erf(float(np.float32(upper) / sqrt2)))
    u = uniform(key, shape, float(a), float(b))
    out = _SQRT2_F32 * erf_inv(u)
    lo = float(np.nextafter(np.float32(lower), np.float32(np.inf)))
    hi = float(np.nextafter(np.float32(upper), np.float32(-np.inf)))
    return torch.clamp(out, lo, hi)
