"""Channel-model subsystem: fading processes and CSI models.

The port of the reference's ``repro/core/fading.py``.  The two axes of the
channel compose:

* **fading process** -- how the complex gains ``h_m(t)`` evolve over rounds:
  ``static`` (one CN(0,1) draw per run), ``iid`` (a fresh draw every round)
  and ``gauss_markov`` (the stationary AR(1) process as a windowed moving
  average, a pure function of ``(fading_key, t)``);
* **CSI model** -- what a transmitter knows of its gain: ``perfect``,
  ``noisy`` (``h_hat = h + e``, ``e ~ CN(0, csi_err_var)``) or ``none``
  (blind transmitters, recovered by a K-antenna PS combiner).

Every draw is a pure function of the keys and the round, and the scalars
``rho``, ``csi_err_var`` and the truncation threshold enter as multiplies
or compares, so a sweep's grid carries them as ``(G,)`` per-point values:
each broadcasts against the devices as ``[..., None]``.

The reference runs these functions inside ``jit``, where XLA's CPU backend
fuses every ``a*b + c`` into one fused multiply-add and sums a reduction in
its own order; the port follows both (:func:`repro_torch.rng.fma_f32`,
:func:`repro_torch.device.xla_sum`), so the elementwise functions are
bitwise the reference's.
The sums and the two products (the Gauss-Markov weights against the
innovations, the blind combiner's) run as explicit fixed-order loops of
elementwise ops, so a grid point keeps its own run's bits on the card too.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.device import (  # noqa: F401 (sqrt_f32, xla_sum re-exported)
    XLA_REDUCE_WINDOW, sqrt_f32, xla_sum,
)

#: recognised fading processes / CSI models (validated by spec_from_cfg)
PROCESSES = ("static", "iid", "gauss_markov")
CSI_MODELS = ("perfect", "noisy", "none")

#: salt decorrelating the run-level fading stream from every other consumer
#: of OTAConfig.seed (projector seeds, data splits)
FADING_SEED_SALT = 0x0FAD

#: offset keeping ``step - i`` folds positive for any practical horizon
_STEP_OFFSET = 1 << 20

#: a CN(0, 1) draw's two parts are ``normal / sqrt(2)``; inside ``jit``
#: XLA divides by a constant as the product with its float32 reciprocal
_INV_SQRT2_F32 = float(np.float32(1.0) / np.sqrt(np.float32(2.0)))

_MIN_NORMAL_F32 = float(np.finfo(np.float32).tiny)

@dataclass(frozen=True)
class FadingSpec:
    """Static description of the channel model: which process and CSI
    branch run, the moving-average window and the PS antenna count."""

    process: str = "iid"  # static | iid | gauss_markov
    csi: str = "perfect"  # perfect | noisy | none
    window: int = 64  # gauss_markov MA window W
    ps_antennas: int = 32  # K receive antennas (blind PS combining)


def spec_from_cfg(cfg) -> FadingSpec:
    """Build the spec from an OTAConfig, validating the names."""
    if cfg.fading_process not in PROCESSES:
        raise ValueError(
            f"unknown fading_process {cfg.fading_process!r}; known: "
            f"{PROCESSES}")
    return FadingSpec(process=cfg.fading_process, window=cfg.fading_window,
                      ps_antennas=cfg.ps_antennas)


def fading_base_key(seed: int, device=None) -> torch.Tensor:
    """Run-level key anchoring the static / gauss_markov gain streams.

    Derived from ``OTAConfig.seed``, not from the round keys: a ``seed``
    sweep axis (which shifts the round keys) holds the fading sample path
    fixed across its points.
    """
    return rng.PRNGKey(seed ^ FADING_SEED_SALT, device=device)


def complex_normals(key: torch.Tensor, m: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(re, im) of m i.i.d. CN(0,1) draws, ``normal(key, (2, m)) /
    sqrt(2)`` as the reference's ``jit`` compiles it: one product of the
    draw's ``erf_inv`` with the folded constant (:func:`rng.normal_scaled`).
    Keys ``(..., 2)`` give ``(..., m)`` each."""
    z = rng.normal_scaled(key, (2, m), _INV_SQRT2_F32)
    return z[..., 0, :], z[..., 1, :]


def magnitude(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """|h| as the reference computes it: ``sqrt(re*re + im*im)`` with the
    sum fused into one multiply-add."""
    return sqrt_f32(rng.fma_f32(re, re, im * im))


def point_scalar(v, device) -> torch.Tensor:
    """A channel scalar (a float, or a 0-dim or ``(G,)`` float32 tensor) on
    ``device``, shaped to broadcast against a trailing device axis."""
    return torch.as_tensor(v, dtype=torch.float32, device=device)[..., None]


def gauss_markov_weights(rho, window: int) -> torch.Tensor:
    """The moving-average weights ``c_i = rho**i / sqrt(sum_j rho**(2j))``,
    ``(..., W)`` for a 0-dim or ``(G,)`` rho.

    As XLA's CPU backend compiles them: a window of up to 32 is one
    unrolled loop, in which LLVM turns ``pow(rho, 2)`` into ``rho * rho``
    and fuses each square into the running sum; a longer one squares first
    and sums in windows of 32, the padding split between the ends
    (:func:`repro_torch.device.xla_sum`).  Held bitwise for windows of up
    to 32 and for 33, 48, 64, 96 and 128.
    """
    rho = torch.as_tensor(rho, dtype=torch.float32)
    idx = torch.arange(window, dtype=torch.float32, device=rho.device)
    c = rng.pow_f32(rho[..., None], idx)
    if window <= XLA_REDUCE_WINDOW:
        if window > 2:
            c = torch.cat([c[..., :2], (rho * rho)[..., None], c[..., 3:]],
                          dim=-1)
        total = c[..., 0] * c[..., 0]
        for i in range(1, window):
            total = rng.fma_f32(c[..., i], c[..., i], total)
    else:
        total = xla_sum(c * c, dim=-1)
    w = c / sqrt_f32(total)[..., None]
    # XLA runs with subnormals flushed to zero
    return torch.where(w.abs() < _MIN_NORMAL_F32, 0.0, w)


def process_gains(spec: FadingSpec, fkey: torch.Tensor,
                  round_key: torch.Tensor, step: int, m: int, rho=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Complex gains (re, im), each ``(..., m)``, for one round.

    ``iid`` draws from the (salted) round key, ``static`` from the run-level
    ``fkey`` only.  ``gauss_markov`` is ``h_t = sum_i c_i w_{t-i}`` over the
    window, the innovations ``w_j`` drawn from ``fold_in(fkey, j)``: all W
    keys in one set of launches, and the weighted sum one term after another
    with fused multiply-adds, as XLA's dot loop runs it.  A ``(G,)`` rho
    gives ``(G, m)`` gains from the one set of innovations.
    """
    if spec.process == "iid":
        return complex_normals(round_key, m)
    if spec.process == "static":
        return complex_normals(fkey, m)
    w = spec.window
    if rho is None:
        rho = torch.tensor(0.9, dtype=torch.float32, device=fkey.device)
    c = gauss_markov_weights(rho, w)                       # (..., W)
    salts = (int(step) + _STEP_OFFSET
             - torch.arange(w, dtype=torch.int64, device=fkey.device))
    keys = rng.fold_in(fkey, salts)                       # (W, 2)
    draws = rng.normal_scaled(keys, (2, m), _INV_SQRT2_F32)  # (W, 2, m)
    h = _vector_dot(c, draws)
    return h[..., 0, :], h[..., 1, :]


#: XLA's CPU dot loop over the window runs as vectors of 8 lanes, two of
#: them from a window of 32 on
_DOT_LANE = 8


def _vector_dot(c: torch.Tensor, draws: torch.Tensor) -> torch.Tensor:
    """``tensordot(c, draws, 1)`` for weights ``(..., W)`` and draws
    ``(W, ...)`` in the order of XLA's vectorised dot loop: L partial sums
    (L = 16 from a window of 32 on, else 8), partial ``j`` taking terms
    ``j, j + L, ...`` with fused multiply-adds; then the two 8-lane halves
    added lane by lane and the 8 lanes summed as a halving tree; the last
    ``W mod L`` terms are added one by one after that.  Elementwise ops
    only."""
    w = c.shape[-1]
    lanes = 2 * _DOT_LANE if w >= 32 else _DOT_LANE
    lead = c.shape[:-1]
    cw = c.reshape(*lead, w, *([1] * (draws.dim() - 1)))
    full = w - w % lanes
    acc = None
    for i in range(0, full, lanes):
        ci, di = cw[..., i:i + lanes, :, :], draws[i:i + lanes]
        acc = ci * di if acc is None else rng.fma_f32(ci, di, acc)
    if acc is None:
        h = None
    else:
        v = acc
        if lanes > _DOT_LANE:
            v = acc[..., _DOT_LANE:, :, :] + acc[..., :_DOT_LANE, :, :]
        while v.shape[-3] > 1:
            n = v.shape[-3] // 2
            v = v[..., :n, :, :] + v[..., n:, :, :]
        h = v[..., 0, :, :]
    for i in range(full, w):
        term_c, term_d = cw[..., i, :, :], draws[i]
        h = term_c * term_d if h is None else rng.fma_f32(term_c, term_d, h)
    return h


def csi_estimate(re: torch.Tensor, im: torch.Tensor, key: torch.Tensor,
                 err_var) -> Tuple[torch.Tensor, torch.Tensor]:
    """Noisy CSI: ``h_hat = h + sqrt(err_var) * e``, ``e ~ CN(0, 1)``, each
    sum fused.  At ``err_var == 0`` the error is ``0 * e`` and ``h_hat`` is
    bitwise ``h``."""
    m = re.shape[-1]
    e_re, e_im = complex_normals(key, m)
    s = sqrt_f32(point_scalar(err_var, re.device))
    return rng.fma_f32(s, e_re, re), rng.fma_f32(s, e_im, im)


def misalignment_gain(re, im, est_re, est_im, err_var) -> torch.Tensor:
    """Effective real gain ``Re(h / h_hat)`` of estimate-driven inversion;
    exactly 1 where ``err_var == 0``."""
    num = rng.fma_f32(re, est_re, im * est_im)
    den = rng.fma_f32(est_re, est_re, est_im * est_im)
    g = num / torch.clamp(den, min=float(np.float32(1e-12)))
    return torch.where(point_scalar(err_var, re.device) > 0.0, g, torch.ones_like(g))


def blind_combiner_stats(re: torch.Tensor, im: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PS-side combining statistics for blind transmitters.

    ``re, im``: ``(..., m, K)`` per-device, per-antenna gains.  The PS
    combines against the superposed channel ``f_k = sum_m h_{m,k}``;
    returns ``gain (..., m) = Re(conj(f) h) / K`` and ``noise_scale (...)
    = sum_k |f_k|^2 / K**2``, each division by the constant a product with
    its float32 reciprocal, as the reference's ``jit`` compiles it.
    """
    k = re.shape[-1]
    f_re = xla_sum(re, dim=-2)                             # (..., K)
    f_im = xla_sum(im, dim=-2)
    gain = _gemv(im, f_im) + _gemv(re, f_re)
    gain = gain * float(np.float32(1.0) / np.float32(k))
    power_k = rng.fma_f32(f_im, f_im, f_re * f_re)
    noise_scale = xla_sum(power_k, dim=-1) * float(
        np.float32(1.0) / np.float32(k * k))
    return gain, noise_scale


#: lanes of XLA's CPU row-major matrix-vector product
_GEMV_LANES = 8


def _gemv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``a @ v`` for ``a (..., m, K)`` and ``v (..., K)`` in the order of
    XLA's CPU row-major GEMV: per row 8 lane sums over the column tiles of 8
    with fused multiply-adds, the lanes summed in adjacent pairs, then the
    remaining ``K mod 8`` columns one by one.  Elementwise ops only."""
    k = a.shape[-1]
    full = k - k % _GEMV_LANES
    vb = v[..., None, :]                                   # (..., 1, K)
    h = None
    if full:
        acc = None
        for j in range(0, full, _GEMV_LANES):
            aj, vj = a[..., j:j + _GEMV_LANES], vb[..., j:j + _GEMV_LANES]
            acc = aj * vj if acc is None else rng.fma_f32(aj, vj, acc)
        while acc.shape[-1] > 1:
            acc = acc[..., 0::2] + acc[..., 1::2]
        h = acc[..., 0] + 0.0
    for j in range(full, k):
        aj, vj = a[..., j], vb[..., j]
        h = aj * vj if h is None else rng.fma_f32(aj, vj, h)
    return h
