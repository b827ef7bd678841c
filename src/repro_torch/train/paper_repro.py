"""Paper-scale federated trainer (§VI): M devices, single-layer classifier,
d = 7850, aggregation over the simulated Gaussian MAC.

The port of the reference's ``repro/train/paper_repro.py``.
:func:`run_federated` is the looped driver: one round per Python
iteration, evaluations in between.  The round body, the reference's jitted
``step_fn``, is :func:`train_step`, so a caller can also step from state
converted from the JAX package (:mod:`repro_torch.convert`).  The model and
optimizer follow the paper: a single-layer softmax network trained with
Adam at the PS on the reconstructed gradient.

Everything runs on ``device`` (the card unless the caller passes
``device="cpu"``); round ``t`` draws from ``PRNGKey(1000 + t)``.

:func:`device_grads`, :func:`accuracy` and :func:`ce_loss` also take the
params of G points at once (every leaf with a leading point axis), as a
sweep's grid holds them.  Their products run per point: a batched cuBLAS
product may pick another algorithm than a lone point's and change its
bits.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import rng
from repro_torch.configs.base import OTAConfig
from repro_torch.convert import ravel, unravel
from repro_torch.core.schemes import Scheme, get_scheme, round_simulated
from repro_torch.device import per_point, resolve_device
from repro_torch.local.work import get_local, local_device_grads
from repro_torch.optim.optim import Optimizer
from repro_torch.rng import fma_f32


def init_linear(dim: int, n_classes: int, device=None) -> Dict[str, torch.Tensor]:
    """Zero weights and bias of the single-layer model on ``device`` (the
    card for ``None``, as at every entry point)."""
    dev = resolve_device(device)
    return {"w": torch.zeros((dim, n_classes), dtype=torch.float32,
                             device=dev),
            "b": torch.zeros((n_classes,), dtype=torch.float32, device=dev)}


def predict(params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"] + params["b"]


def _mean_f32(total: torch.Tensor, n: int) -> torch.Tensor:
    """``total * f32(1/n)``: how ``jnp.mean`` divides (a sum times the
    float32 reciprocal, not a division)."""
    return total.to(torch.float32) * float(np.float32(1.0 / n))


def _points(fn, params, *args):
    """``fn(params, *args)``, once per point when the params carry a
    leading point axis (``w`` of rank 3), the results stacked."""
    if params["w"].dim() == 2:
        return fn(params, *args)
    return per_point(lambda b, w: fn({"b": b, "w": w}, *args),
                     params["b"], params["w"], rank=1)


def ce_loss(params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean test cross-entropy.  The division rounds as ``jnp.mean`` does;
    the sum runs in torch's order, not XLA's, so the two differ by about an
    ulp of the loss (within 1e-6 at the tests' sizes)."""
    def one(p, x, y):
        logp = torch.log_softmax(predict(p, x), dim=-1)
        return _mean_f32(-logp.gather(-1, y[:, None]).sum(), y.shape[0])
    return _points(one, params, x, y)


def accuracy(params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Test accuracy, bitwise ``jnp.mean`` of the hits: count * f32(1/n)."""
    def one(p, x, y):
        hits = (predict(p, x).argmax(-1) == y).sum()
        return _mean_f32(hits, y.shape[0])
    return _points(one, params, x, y)


@dataclass
class FederatedRun:
    accs: List[float] = field(default_factory=list)
    losses: List[float] = field(default_factory=list)
    metrics: List[Dict[str, float]] = field(default_factory=list)
    #: final training state (the reference's run keeps none)
    params: Optional[Dict[str, torch.Tensor]] = None
    opt_state: Optional[dict] = None
    deltas: Optional[torch.Tensor] = None
    duals: Optional[torch.Tensor] = None


def _softmax_grads(xd: torch.Tensor, yd: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Flat gradients ``[b, w]`` of the mean cross-entropy from the logits'
    weights: ``w`` (dim, C) and ``b`` (C,) shared by every device, or
    ``(M, dim, C)`` and ``(M, C)``, one per device."""
    logits = torch.matmul(xd, w) + (b if b.dim() == 1 else b[:, None, :])
    resid = torch.softmax(logits, dim=-1)
    resid = resid - torch.nn.functional.one_hot(
        yd, logits.shape[-1]).to(resid.dtype)
    resid = resid / xd.shape[1]
    return ravel({"w": torch.matmul(xd.transpose(1, 2), resid),
                  "b": resid.sum(dim=1)}, batch_dims=1)


def flat_grad(params, xm: torch.Tensor, ym: torch.Tensor) -> torch.Tensor:
    """One device's flattened gradient ``[b, w]`` on its local batch."""
    return _softmax_grads(xm[None], ym[None], params["w"], params["b"])[0]


def flat_grad_fn(params):
    """``(w, xd, yd) -> (..., M, d)``: the flat gradient of each device at
    its own iterate, the per-epoch hook
    :func:`repro_torch.local.work.local_device_grads` drives.  ``w`` is
    ``(M, d)`` in ``ravel`` order, or ``(G, M, d)`` for G points (then one
    product per point, as :func:`device_grads`); ``xd`` is ``(M, B, dim)``,
    or ``(G, M, B, dim)`` with each point's own devices.  ``params`` only
    gives the leaves' shapes."""
    n_b = params["b"].shape[-1]

    def one(w, xd, yd):
        m = w.shape[0]
        return _softmax_grads(xd, yd, w[:, n_b:].reshape(
            m, xd.shape[-1], n_b), w[:, :n_b])

    def gf(w, xd, yd):
        if w.dim() == 2:
            return one(w, xd, yd)
        if xd.dim() == 4:
            return per_point(one, w, xd, yd, rank=2)
        return per_point(lambda v: one(v, xd, yd), w, rank=2)

    return gf


def flat_local_delta(params, xd: torch.Tensor, yd: torch.Tensor,
                     local_steps: int, local_lr: float) -> torch.Tensor:
    """J local SGD steps on every device; transmit ``(theta - theta_m^J) /
    (J * local_lr)`` as ``(M, d)`` rows.  Each step is one fused
    multiply-add, and the division by the constant ``J * local_lr`` the
    product with its float32 reciprocal, as the reference's ``jit``
    compiles them; the first step's gradient is the shared-weight
    product."""
    lr = float(np.float32(local_lr))
    gf = flat_grad_fn(params)
    w0 = ravel(params)
    w = w0.expand(xd.shape[0], w0.shape[0])
    for j in range(local_steps):
        g = device_grads(params, xd, yd, None)[0] if j == 0 else gf(w, xd, yd)
        w = fma_f32(g, -lr, w)
    recip = float(np.float32(1.0) / np.float32(local_lr * local_steps))
    return (w0 - w) * recip


def device_grads(params, xd: torch.Tensor, yd: torch.Tensor,
                 momenta: torch.Tensor, *, local_steps: int = 1,
                 local_lr: float = 0.1, momentum_correction: float = 0.0):
    """(M, d) per-device flat gradients of the mean cross-entropy, and the
    updated momenta.

    The gradient of the linear softmax model is closed-form: with the
    softmax residual ``r = (softmax(x w + b) - onehot(y)) / B``, it is
    ``x^T r`` for w and ``sum_b r`` for b, one batched product for all
    devices.  Flat layout as ``ravel_pytree``: ``[b, w]``.
    ``local_steps > 1`` is the legacy FedAvg device
    (:func:`flat_local_delta`).

    Params of G points give ``(G, M, d)`` gradients, each point's as its
    own call gives them; ``momenta`` then is ``(G, M, d)`` too, and ``xd``,
    ``yd`` may carry the points' own devices, ``(G, M, B, dim)``.
    """
    if params["w"].dim() == 3:
        kw = dict(local_steps=local_steps, local_lr=local_lr,
                  momentum_correction=momentum_correction)
        if xd.dim() == 4:
            # each point's own devices (a population grid's cohorts)
            def one(b, w, x, y, mom=None):
                return device_grads({"b": b, "w": w}, x, y, mom, **kw)
            data = (xd, yd)
        else:
            def one(b, w, mom=None):
                return device_grads({"b": b, "w": w}, xd, yd, mom, **kw)
            data = ()
        if momenta is None:
            return per_point(lambda *a: one(*a)[0], params["b"],
                             params["w"], *data, rank=1), None
        return per_point(lambda *a: one(*a[:-1], mom=a[-1]), params["b"],
                         params["w"], *data, momenta, rank=1)
    if local_steps > 1:
        grads = flat_local_delta(params, xd, yd, local_steps, local_lr)
    else:
        grads = _softmax_grads(xd, yd, params["w"], params["b"])
    if momentum_correction > 0:
        momenta = momentum_correction * momenta + grads
        grads = momenta
    return grads, momenta


def train_step(scheme: Scheme, opt: Optimizer, params, opt_state,
               deltas: torch.Tensor, momenta: torch.Tensor, xd: torch.Tensor,
               yd: torch.Tensor, t: int, key: torch.Tensor, *,
               momentum_correction: float = 0.0, local_steps: int = 1,
               local_lr: float = 0.1, grads=None):
    """One federated round: device gradients, the scheme's round over the
    simulated MAC, Adam at the PS.  Returns
    ``(params, opt_state, deltas, momenta, metrics)``.  ``grads`` given
    (a local algorithm's deltas) replace the device gradients."""
    if grads is None:
        grads, momenta = device_grads(
            params, xd, yd, momenta, local_steps=local_steps,
            local_lr=local_lr, momentum_correction=momentum_correction)
    ghat, deltas, met = round_simulated(scheme, grads, deltas, t, key)
    params, opt_state = opt.apply(params, unravel(ghat, params), opt_state)
    return params, opt_state, deltas, momenta, met


def run_federated(x_dev: np.ndarray, y_dev: np.ndarray,
                  x_test: np.ndarray, y_test: np.ndarray,
                  ota: OTAConfig, steps: int, lr: float = 1e-3,
                  eval_every: int = 10, seed: int = 0,
                  optimizer: str = "adam",
                  local_steps: int = 1, local_lr: float = 0.1,
                  momentum_correction: float = 0.0,
                  device=None) -> FederatedRun:
    """Train the paper's model with the given aggregation scheme.

    ``device=None`` runs on the card and raises ``RuntimeError`` without
    one.  Beyond the paper, as in the reference: ``local_steps > 1`` is
    FedAvg-style local SGD (each device transmits its model delta),
    ``momentum_correction > 0`` compresses the momentum, and ``ota.local``
    / ``ota.local_epochs`` select the registered local-compute algorithm
    (:mod:`repro_torch.local`); ``local_steps > 1`` with a non-identity
    algorithm raises ``ValueError``, as does a subband scheduler.
    ``seed`` only seeds the zero initialisation, as in the reference.
    """
    dev = resolve_device(device)
    m, _, dim = x_dev.shape
    n_classes = int(y_dev.max()) + 1
    params = init_linear(dim, n_classes, dev)
    d = ravel(params).shape[0]
    scheme = get_scheme(ota, d, m, device=dev)
    if ota.scheduler != "none":
        raise ValueError(
            "subband scheduling needs carried scheduler state; the looped "
            "driver has none -- use run_compiled for "
            f"scheduler={ota.scheduler!r}")
    lw = get_local(ota, local_lr, device=dev)
    if not lw.identity and local_steps > 1:
        raise ValueError(
            "local_steps > 1 (the legacy FedAvg path) conflicts with the "
            f"configured local algorithm {ota.local!r} at "
            f"local_epochs={ota.local_epochs}; use ota.local_epochs")
    gf = flat_grad_fn(params)
    opt = Optimizer(name=optimizer, lr=lr)
    opt_state = opt.init(params)
    deltas = torch.zeros((m, d), dtype=torch.float32, device=dev)
    momenta = torch.zeros((m, d), dtype=torch.float32, device=dev)
    duals = lw.init_dual(m, d)
    xd = torch.as_tensor(x_dev, dtype=torch.float32, device=dev)
    yd = torch.as_tensor(y_dev, device=dev).long()
    xt = torch.as_tensor(x_test, dtype=torch.float32, device=dev)
    yt = torch.as_tensor(y_test, device=dev).long()

    run = FederatedRun()
    for t in range(steps):
        grads = None
        if not lw.identity:
            grads, momenta, duals = local_device_grads(
                lw, gf, params, xd, yd, momenta, duals,
                momentum_correction=momentum_correction)
        params, opt_state, deltas, momenta, met = train_step(
            scheme, opt, params, opt_state, deltas, momenta, xd, yd, t,
            rng.PRNGKey(1000 + t, device=dev),
            momentum_correction=momentum_correction,
            local_steps=local_steps, local_lr=local_lr, grads=grads)
        if t % eval_every == 0 or t == steps - 1:
            run.accs.append(float(accuracy(params, xt, yt)))
            run.losses.append(float(ce_loss(params, xt, yt)))
            run.metrics.append({k: float(v) for k, v in met.items()})
    run.params, run.opt_state, run.deltas = params, opt_state, deltas
    run.duals = duals
    return run
