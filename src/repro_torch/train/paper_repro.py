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
from repro_torch.device import resolve_device
from repro_torch.optim.optim import Optimizer


def init_linear(dim: int, n_classes: int, device=None) -> Dict[str, torch.Tensor]:
    return {"w": torch.zeros((dim, n_classes), dtype=torch.float32,
                             device=device),
            "b": torch.zeros((n_classes,), dtype=torch.float32, device=device)}


def predict(params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"] + params["b"]


def _mean_f32(total: torch.Tensor, n: int) -> torch.Tensor:
    """``total * f32(1/n)``: how ``jnp.mean`` divides (a sum times the
    float32 reciprocal, not a division)."""
    return total.to(torch.float32) * float(np.float32(1.0 / n))


def ce_loss(params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean test cross-entropy.  The division rounds as ``jnp.mean`` does;
    the sum runs in torch's order, not XLA's, so the two differ by about an
    ulp of the loss (within 1e-6 at the tests' sizes)."""
    logp = torch.log_softmax(predict(params, x), dim=-1)
    return _mean_f32(-logp.gather(-1, y[:, None]).sum(), y.shape[0])


def accuracy(params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Test accuracy, bitwise ``jnp.mean`` of the hits: count * f32(1/n)."""
    hits = (predict(params, x).argmax(-1) == y).sum()
    return _mean_f32(hits, y.shape[0])


@dataclass
class FederatedRun:
    accs: List[float] = field(default_factory=list)
    losses: List[float] = field(default_factory=list)
    metrics: List[Dict[str, float]] = field(default_factory=list)
    #: final training state (the reference's run keeps none)
    params: Optional[Dict[str, torch.Tensor]] = None
    opt_state: Optional[dict] = None
    deltas: Optional[torch.Tensor] = None


def device_grads(params, xd: torch.Tensor, yd: torch.Tensor,
                 momenta: torch.Tensor, *, momentum_correction: float = 0.0):
    """(M, d) per-device flat gradients of the mean cross-entropy, and the
    updated momenta.

    The gradient of the linear softmax model is closed-form: with the
    softmax residual ``r = (softmax(x w + b) - onehot(y)) / B``, it is
    ``x^T r`` for w and ``sum_b r`` for b, one batched product for all
    devices.  Flat layout as ``ravel_pytree``: ``[b, w]``.
    """
    logits = torch.matmul(xd, params["w"]) + params["b"]        # (M, B, C)
    resid = torch.softmax(logits, dim=-1)
    resid = resid - torch.nn.functional.one_hot(
        yd, logits.shape[-1]).to(resid.dtype)
    resid = resid / xd.shape[1]
    grads = ravel({"w": torch.matmul(xd.transpose(1, 2), resid),
                   "b": resid.sum(dim=1)}, batch_dims=1)
    if momentum_correction > 0:
        momenta = momentum_correction * momenta + grads
        grads = momenta
    return grads, momenta


def train_step(scheme: Scheme, opt: Optimizer, params, opt_state,
               deltas: torch.Tensor, momenta: torch.Tensor, xd: torch.Tensor,
               yd: torch.Tensor, t: int, key: torch.Tensor, *,
               momentum_correction: float = 0.0):
    """One federated round: device gradients, the scheme's round over the
    simulated MAC, Adam at the PS.  Returns
    ``(params, opt_state, deltas, momenta, metrics)``."""
    grads, momenta = device_grads(params, xd, yd, momenta,
                                  momentum_correction=momentum_correction)
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
    one.  ``local_steps > 1`` (FedAvg-style local SGD) is not ported yet.
    ``seed`` only seeds the zero initialisation, as in the reference.
    """
    dev = resolve_device(device)
    if local_steps > 1:
        raise NotImplementedError("local_steps > 1 is not ported yet")
    m, _, dim = x_dev.shape
    n_classes = int(y_dev.max()) + 1
    params = init_linear(dim, n_classes, dev)
    d = ravel(params).shape[0]
    scheme = get_scheme(ota, d, m, device=dev)
    opt = Optimizer(name=optimizer, lr=lr)
    opt_state = opt.init(params)
    deltas = torch.zeros((m, d), dtype=torch.float32, device=dev)
    momenta = torch.zeros((m, d), dtype=torch.float32, device=dev)
    xd = torch.as_tensor(x_dev, dtype=torch.float32, device=dev)
    yd = torch.as_tensor(y_dev, device=dev).long()
    xt = torch.as_tensor(x_test, dtype=torch.float32, device=dev)
    yt = torch.as_tensor(y_test, device=dev).long()

    run = FederatedRun()
    for t in range(steps):
        params, opt_state, deltas, momenta, met = train_step(
            scheme, opt, params, opt_state, deltas, momenta, xd, yd, t,
            rng.PRNGKey(1000 + t, device=dev),
            momentum_correction=momentum_correction)
        if t % eval_every == 0 or t == steps - 1:
            run.accs.append(float(accuracy(params, xt, yt)))
            run.losses.append(float(ce_loss(params, xt, yt)))
            run.metrics.append({k: float(v) for k, v in met.items()})
    run.params, run.opt_state, run.deltas = params, opt_state, deltas
    return run
