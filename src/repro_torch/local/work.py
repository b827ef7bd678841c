"""Local-compute axis: what a device does between two uplink uses.

The port of the reference's ``repro/local/work.py``.  The paper's device
runs one SGD step per round and transmits its gradient; deployed systems
amortise each uplink over ``E`` local epochs, with drift correction under
non-IID shards (FedProx's proximal term, FedDyn's dynamic regulariser).  A
:class:`LocalWork` produces the per-device delta that feeds the scheme's
error feedback, sparsification and projection, so every scheme composes
with every algorithm.

Registered algorithms::

    sgd      E plain SGD steps, transmit the mean gradient (E=1, the
             default, is the one-gradient round: the engines keep
             ``device_grads`` for it)
    fedavg   FedAvg-E: E local epochs, transmit (w0 - wE) / (lr E)
    fedprox  FedAvg-E with the proximal term (mu/2)||w - w0||^2
    feddyn   FedAvg-E with a per-device dual (dynamic regulariser), carried
             by the dense engine and banked by the population engine

``local`` is static (program structure); ``local_epochs``, ``prox_mu`` and
``dyn_alpha`` (``LOCAL_OVERRIDE_ATTRS``) are 0-dim float32 tensors on the
run's device, ``(G,)`` for a sweep's grid, swapped on by
:meth:`LocalWork.with_overrides` as the scheme's scalars are.  The epoch
loop runs the static ``max_epochs`` steps (a grid's maximum) with the
cutoff ``e < local_epochs`` as ``torch.where``, so an epoch past a point's
count leaves its carry bitwise untouched.

Arithmetic as the reference's ``jit`` compiles it with the scalars traced
(a sweep's program): ``g + mu * (w - w0)``, the step ``w - lr * dvec`` and
the dual update ``dual - alpha * (w_end - w0)`` are one fused multiply-add
each (:func:`repro_torch.rng.fma_f32`), and ``delta_out`` divides by
``lr * n_eff``.  The reference's ``run_compiled``, where ``local_epochs``
is a constant, multiplies by the constant's float32 reciprocal instead;
the port divides in both callers, so a grid point equals its own run
(ROADMAP queue 3).
"""
from __future__ import annotations

import copy
from typing import Dict, Type

import numpy as np
import torch

from repro_torch.convert import ravel
from repro_torch.device import lead, resolve_device
from repro_torch.rng import fma_f32

LOCAL_REGISTRY: Dict[str, Type["LocalWork"]] = {}

#: LocalWork attributes that ride the batched override path (the sweep's
#: ``LOCAL_VMAP_AXES``)
LOCAL_OVERRIDE_ATTRS = ("local_epochs", "prox_mu", "dyn_alpha")


def register_local(name: str):
    """Class decorator: register a :class:`LocalWork` under ``name``."""

    def deco(cls):
        cls.name = name
        LOCAL_REGISTRY[name] = cls
        return cls

    return deco


def get_local(cfg, local_lr: float = 0.1, device=None) -> "LocalWork":
    """Resolve ``cfg.local`` against the registry; its scalars live on
    ``device`` (the card for ``None``)."""
    try:
        cls = LOCAL_REGISTRY[cfg.local]
    except KeyError:
        raise KeyError(
            f"unknown local algorithm {cfg.local!r}; "
            f"known: {sorted(LOCAL_REGISTRY)}"
        ) from None
    return cls(cfg, local_lr, device=device)


class LocalWork:
    """Contract for the device-side inner loop.

    Hooks on flat ``(..., M, d)`` rows (``w0`` is the round's global model
    broadcast to every device, ``w`` the local iterate):

    * :meth:`init_dual` -- per-device persistent dual state, or ``None``
    * :meth:`inner_grad` -- descent direction at ``w`` given the data
      gradient ``g`` (the driver applies ``w -= lr * inner_grad(...)``)
    * :meth:`delta_out` -- the transmitted pseudo-gradient after E epochs
    * :meth:`dual_out` -- the dual update after E epochs

    ``max_epochs`` is the static loop length (a sweep raises it to the
    grid's maximum); ``local_epochs`` the per-point epoch count, above
    ``max_epochs`` truncated.
    """

    name = "?"
    #: static: this algorithm carries a per-device dual vector
    has_dual = False

    def __init__(self, cfg, local_lr: float = 0.1, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.lr = float(local_lr)
        self.max_epochs = max(int(cfg.local_epochs), 1)
        for name in LOCAL_OVERRIDE_ATTRS:
            setattr(self, name, torch.tensor(np.float32(getattr(cfg, name)),
                                             device=self.device))

    @property
    def identity(self) -> bool:
        """Static: the one-gradient-per-round device, for which the engines
        keep their ``device_grads`` path."""
        return False

    def with_overrides(self, **attrs) -> "LocalWork":
        """Shallow copy with the batched knobs replaced (the sweep hook);
        each value becomes a float32 tensor on the run's device."""
        new = copy.copy(self)
        for name, value in attrs.items():
            if name not in LOCAL_OVERRIDE_ATTRS:
                raise AttributeError(
                    f"unknown local override {name!r}; traced knobs: "
                    f"{LOCAL_OVERRIDE_ATTRS}"
                )
            setattr(new, name, torch.as_tensor(value, dtype=torch.float32,
                                               device=self.device))
        return new

    def init_dual(self, m: int, d: int, points=None):
        """``(m, d)`` initial duals (``(points, m, d)`` for a grid), or
        ``None`` for dual-free algorithms."""
        if not self.has_dual:
            return None
        shape = (m, d) if points is None else (points, m, d)
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    # ----------------------------------------------------- per-epoch hooks
    def inner_grad(self, g, w, w0, dual):
        """Descent direction at the local iterate ``w``."""
        return g

    def delta_out(self, w0, w_end, g_sum, n_eff):
        """The transmitted pseudo-gradient: ``(w0 - wE) / (lr E)``."""
        return (w0 - w_end) / lead(n_eff * np.float32(self.lr), w0)

    def dual_out(self, dual, w0, w_end):
        """Updated dual after the epoch loop (dual-free: pass-through)."""
        return dual


@register_local("sgd")
class SGDLocal(LocalWork):
    """The paper's device, generalised: E plain SGD steps, transmit the
    mean of the local gradients.  At E=1 the mean is ``g / 1.0 == g``
    bitwise."""

    @property
    def identity(self) -> bool:
        return self.max_epochs == 1

    def delta_out(self, w0, w_end, g_sum, n_eff):
        return g_sum / lead(n_eff, g_sum)


@register_local("fedavg")
class FedAvgLocal(LocalWork):
    """FedAvg-E: E local epochs over the device shard, transmit the model
    delta in gradient units, ``(w0 - wE) / (lr E)``."""


@register_local("fedprox")
class FedProxLocal(LocalWork):
    """FedProx: each inner step descends ``f(w) + (mu/2) ||w - w0||^2``.
    At ``mu=0`` the added term is exactly zero, so fedprox(mu=0) ==
    fedavg."""

    def inner_grad(self, g, w, w0, dual):
        return fma_f32(w - w0, lead(self.prox_mu, g), g)


@register_local("feddyn")
class FedDynLocal(LocalWork):
    """FedDyn: dynamic regularisation with a per-device dual.

    Inner objective ``f(w) - <dual, w> + (alpha/2)||w - w0||^2``; after the
    epoch loop the dual absorbs the realised drift,
    ``dual' = dual - alpha (wE - w0)``.  A fresh (or evicted) device with
    ``dual = 0`` is the algorithm's own initial state, which is why the
    population engine can bank duals whose cold slots read zero.
    """

    has_dual = True

    def inner_grad(self, g, w, w0, dual):
        return fma_f32(w - w0, lead(self.dyn_alpha, g), g) - dual

    def dual_out(self, dual, w0, w_end):
        return fma_f32(w_end - w0, -lead(self.dyn_alpha, dual), dual)


def local_device_grads(lw: LocalWork, grad_fn, params, xd, yd, momenta,
                       duals=None, *, momentum_correction: float = 0.0):
    """``(M, d)`` transmitted deltas and the updated ``(momenta, duals)``.

    The multi-epoch generalisation of
    :func:`repro_torch.train.paper_repro.device_grads`; the engines call
    one or the other on the static :attr:`LocalWork.identity`.
    ``grad_fn(w, xd, yd)`` is the model's flat gradient at per-device
    iterates ``w (..., M, d)`` (:func:`repro_torch.train.paper_repro.
    flat_grad_fn`).  Epoch 0 runs at ``w0`` on every device, and its
    gradient is the shared-weight ``device_grads``, so an E=1 point rounds
    as the one-gradient round does.  Params of G points (a leading point
    axis on every leaf, and on ``momenta`` and ``duals``) give
    ``(G, M, d)`` deltas, each point's as its own call.
    """
    from repro_torch.train.paper_repro import device_grads

    w0 = ravel(params, batch_dims=params["w"].dim() - 2)
    m = xd.shape[-3]
    w0 = w0.unsqueeze(-2).expand(*w0.shape[:-1], m, w0.shape[-1])
    lr = float(np.float32(lw.lr))
    n_eff = torch.clamp(lw.local_epochs, min=1.0)
    w, g_sum = w0, torch.zeros_like(w0)
    for e in range(lw.max_epochs):
        g = (device_grads(params, xd, yd, None)[0] if e == 0
             else grad_fn(w, xd, yd))
        dvec = lw.inner_grad(g, w, w0, duals)
        live = lead(float(e) < lw.local_epochs, w)
        w = torch.where(live, fma_f32(dvec, -lr, w), w)
        g_sum = torch.where(live, g_sum + dvec, g_sum)
    deltas = lw.delta_out(w0, w, g_sum, n_eff)
    new_duals = lw.dual_out(duals, w0, w) if lw.has_dual else None
    if momentum_correction > 0:
        momenta = momentum_correction * momenta + deltas
        deltas = momenta
    return deltas, momenta, new_duals
