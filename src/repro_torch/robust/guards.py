"""Round guardrails inside the run: clamp, skip, back off, with no host.

The port of the reference's ``repro/robust/guards.py``.
:func:`guarded_step` wraps the PS-side optimizer step with three rails,
each decided on the device by selects on the carry (no ``.item()``, no
retry loop):

* **update-norm clamp** (``update_clip > 0``): the decoded update's L2 norm
  is capped before it reaches the optimizer;
* **finite check and skipped round** (``skip_nonfinite``): a non-finite
  update skips the round: params, optimizer state and every accumulator in
  ``extras`` are carried unchanged;
* **divergence detector and LR backoff** (``divergence_factor > 0``): if
  the post-step test loss exceeds ``divergence_factor`` times the last
  accepted loss (or is non-finite), the step is reverted and ``lr_scale``
  is multiplied by ``lr_backoff``; a cooldown then holds off further
  backoffs for ``cooldown`` rounds.

``lr_scale`` blends the applied step, ``p0 + lr_scale * (p1 - p0)``, since
Adam's update does not change when its gradient is scaled.  The blend is
built only when a guard is set.  Under ``jit`` the reference's XLA folds
``p1 - p0`` into the optimizer's negated step and contracts the rest into
one fused multiply-add (:func:`repro_torch.rng.fma_f32`, measured on the
CPU with jax 0.9.0); the port computes the same.

A sweep's grid carries one :class:`GuardState` per point: every field
``(G,)``, with params, optimizer state and extras carrying the point axis
in front (the optimizer's step count too, since a skipped point keeps its
own).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch import rng
from repro_torch.device import lead, sqrt_f32, xla_sum


@dataclass(frozen=True)
class GuardConfig:
    """Static guardrail configuration (0 disables a rail)."""
    update_clip: float = 0.0        # L2 cap on the decoded update (0 = off)
    skip_nonfinite: bool = True     # skip rounds with NaN/Inf updates
    divergence_factor: float = 0.0  # revert if loss > factor * last (0 = off)
    lr_backoff: float = 0.5         # lr_scale multiplier on divergence
    cooldown: int = 5               # rounds between successive backoffs


class GuardState(NamedTuple):
    """Guardrail state riding the carry: float32, 0-dim or ``(G,)``."""
    lr_scale: torch.Tensor          # current LR backoff multiplier
    cooldown: torch.Tensor          # rounds until the next backoff may fire
    prev_loss: torch.Tensor         # loss at the last accepted step
    skips: torch.Tensor             # cumulative skipped rounds
    backoffs: torch.Tensor          # cumulative LR backoffs


def init_guard_state(points=None, device=None) -> GuardState:
    """The initial state, 0-dim, or ``(points,)`` for a grid."""
    shape = () if points is None else (points,)

    def full(v):
        return torch.full(shape, v, dtype=torch.float32, device=device)
    return GuardState(lr_scale=full(1.0), cooldown=full(0.0),
                      prev_loss=full(float("inf")), skips=full(0.0),
                      backoffs=full(0.0))


def _select(ok: torch.Tensor, new: Any, old: Any) -> Any:
    """``new`` where ``ok``, else ``old``, leaf by leaf through dicts and
    tuples (a NamedTuple keeps its class)."""
    if isinstance(new, dict):
        return {k: _select(ok, v, old[k]) for k, v in new.items()}
    if isinstance(new, tuple):
        items = [_select(ok, n, o) for n, o in zip(new, old)]
        return type(new)(*items) if hasattr(new, "_fields") else tuple(items)
    return torch.where(lead(ok, new), new, old)


def guarded_step(guard: GuardConfig, gstate: GuardState, opt, params,
                 opt_state, ghat: torch.Tensor, unravel, extras: Any,
                 old_extras: Any, loss_fn):
    """One guarded PS update.  Returns ``(params, opt_state, extras,
    gstate, loss, guard_metrics)``.

    ``ghat`` is ``(d,)``, or ``(G, d)`` with a ``(G,)`` state; ``unravel``
    maps it onto the params' dict.  ``extras`` / ``old_extras`` are the
    round's remaining carry after and before the round: a skipped or
    reverted round restores ``old_extras`` whole, so error feedback cannot
    absorb an update that was never applied.  ``loss_fn(params)`` is the
    test loss the divergence rail compares.
    """
    if guard.update_clip > 0:
        nrm = sqrt_f32(xla_sum(ghat * ghat, dim=-1))
        clip = torch.full((), guard.update_clip, dtype=torch.float32,
                          device=ghat.device)
        ghat = ghat * torch.clamp(clip / torch.clamp(nrm, min=1e-30),
                                  max=1.0)[..., None]
    finite = torch.isfinite(ghat).all(dim=-1)
    # a non-finite update would corrupt Adam's moments even on a skipped
    # round: apply the optimizer to a zeroed stand-in and discard it
    ghat_safe = torch.where(finite[..., None], ghat, 0.0)
    steps, o1 = opt.steps(params, unravel(ghat_safe), opt_state)
    # the backoff blends the step: p0 + lr_scale * (p1 - p0), where XLA
    # folds p1 - p0 into -step and fuses the rest into one multiply-add
    p1 = {k: rng.fma_f32(lead(gstate.lr_scale, p), -steps[k], p)
          for k, p in params.items()}

    false = torch.zeros_like(finite)
    skip = ~finite if guard.skip_nonfinite else false
    if guard.divergence_factor > 0:
        loss1 = loss_fn(p1)
        diverged = ((~torch.isfinite(loss1))
                    | (loss1 > guard.divergence_factor * gstate.prev_loss))
        diverged = diverged & (gstate.cooldown <= 0.0) & ~skip
    else:
        loss1 = None
        diverged = false
    ok = ~(skip | diverged)
    params = _select(ok, p1, params)
    opt_state = _select(ok, o1, opt_state)
    extras = _select(ok, extras, old_extras)

    if loss1 is None:
        loss = loss_fn(params)
    else:
        # a reverted round reports the last accepted loss
        loss = torch.where(ok, loss1, gstate.prev_loss)
    new_gstate = GuardState(
        lr_scale=torch.where(diverged, gstate.lr_scale * guard.lr_backoff,
                             gstate.lr_scale),
        cooldown=torch.where(diverged, float(guard.cooldown),
                             torch.clamp(gstate.cooldown - 1.0, min=0.0)),
        prev_loss=torch.where(ok, loss, gstate.prev_loss),
        skips=gstate.skips + skip.to(torch.float32),
        backoffs=gstate.backoffs + diverged.to(torch.float32),
    )
    metrics = {"guard_lr_scale": new_gstate.lr_scale,
               "guard_skipped": skip.to(torch.float32),
               "guard_backoff": diverged.to(torch.float32)}
    return params, opt_state, extras, new_gstate, loss, metrics

