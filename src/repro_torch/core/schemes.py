"""Aggregation schemes over the simulated MAC: one encode/decode contract.

The port of the reference's ``repro/core/schemes.py`` for the paper's main
path.  Each scheme implements

    init_state(d)                        -- per-device error accumulator
    encode(g, state, step, keys, ctx)    -- device-side compression + frame
    decode(y, step, ctx)                 -- PS-side reconstruction
    channel_dim(d)                       -- channel uses per round

is registered under a name with :func:`register_scheme` and resolved from
an ``OTAConfig`` by :func:`get_scheme`.  The reference vmaps ``encode`` over
the devices; here the device axis is written out: ``encode`` takes ``(M, d)``
gradients and states, ``(M, 2)`` keys and a context whose ``p_factor`` is
``(M,)``, and returns the ``(M, s_tilde + 2)`` frames that ``jax.vmap`` of
the reference's ``encode`` returns.

Ported: ``ideal`` and ``a_dsgd`` (dense and blocked projection) with the
:func:`round_simulated` driver.  The channel, geometry, robustness,
scheduling and local-compute axes and the digital schemes are not ported
yet: a config that asks for one raises when its scheme is built, and never
runs the plain path silently.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import cached_property
from typing import Any, Dict, NamedTuple, Optional, Tuple, Type

import torch

from repro_torch import rng
from repro_torch.configs.base import OTAConfig
from repro_torch.core import channel, compression, power
from repro_torch.core.amp import amp_decode
from repro_torch.core.projection import DenseProjector, make_projector
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


@dataclass(frozen=True)
class MACContext:
    """Context threaded through encode/decode on the simulated MAC.

    ``p_factor`` is the per-device received-power scale (``(M,)`` inside a
    round, 1.0 on the AWGN MAC); ``use_kernel`` upgrades a blocked
    projector to the CUDA kernels.  The reference's topology fields (mesh
    axes, groups, slice-driver knobs) belong to drivers not ported yet.
    """
    m: int = 1
    p_factor: Any = 1.0
    use_kernel: bool = False

    def with_p_factor(self, p_factor) -> "MACContext":
        return dataclasses.replace(self, p_factor=p_factor)


class ChannelDraw(NamedTuple):
    """One round's channel realisation, as seen by a driver."""
    p_factor: torch.Tensor                       # (m,) received-power factor
    active: torch.Tensor                         # (m,) bool transmit set
    gain: Optional[torch.Tensor] = None          # (m,) frame amplitude
    noise_scale: Optional[torch.Tensor] = None   # scalar sigma^2 multiplier


SCHEME_REGISTRY: Dict[str, Type["Scheme"]] = {}

#: the five schemes evaluated in the paper's §VI figures
PAPER_SCHEMES = ("ideal", "a_dsgd", "d_dsgd", "signsgd", "qsgd")

#: schemes of the reference that the port does not run yet
NOT_PORTED_SCHEMES = ("d_dsgd", "signsgd", "qsgd", "a_dsgd_fading",
                      "a_dsgd_csi_err", "a_dsgd_blind")


def register_scheme(name: str):
    """Class decorator: register a Scheme subclass under ``name``."""
    def deco(cls: Type["Scheme"]) -> Type["Scheme"]:
        cls.name = name
        SCHEME_REGISTRY[name] = cls
        return cls
    return deco


def get_scheme(cfg: OTAConfig, d: int, m: int, device=None) -> "Scheme":
    """Resolve ``cfg.scheme`` through the registry and build the scheme.

    ``device=None`` is the card.  ``scheme="a_dsgd"`` with
    ``fading="rayleigh"`` resolves to ``a_dsgd_fading``, as in the reference.
    """
    name = cfg.scheme
    if name == "a_dsgd" and cfg.fading == "rayleigh":
        name = "a_dsgd_fading"
    if name in NOT_PORTED_SCHEMES:
        raise NotImplementedError(f"scheme {name!r} is not ported yet")
    try:
        cls = SCHEME_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown scheme {name!r}; registered: "
            f"{', '.join(sorted(SCHEME_REGISTRY))}") from None
    return cls(cfg, d, m, device=device)


def _unported_axes(cfg: OTAConfig) -> Tuple[str, ...]:
    """The configured axes the port cannot run yet."""
    bad = []
    if cfg.fading != "none":
        bad.append(f"fading={cfg.fading!r}")
    if cfg.geometry != "none":
        bad.append(f"geometry={cfg.geometry!r}")
    if (cfg.robust or cfg.byzantine_frac > 0 or cfg.fault_rate > 0
            or cfg.erasure_prob > 0):
        bad.append("robust")
    if cfg.scheduler != "none":
        bad.append(f"scheduler={cfg.scheduler!r}")
    if cfg.local != "sgd" or cfg.local_epochs != 1:
        bad.append(f"local={cfg.local!r}, local_epochs={cfg.local_epochs}")
    return tuple(bad)


class Scheme:
    """Base class: state/schedule plumbing and the generic hooks."""

    name: str = "?"
    analog: bool = False

    def __init__(self, cfg: OTAConfig, d: int, m: int, device=None):
        bad = _unported_axes(cfg)
        if bad:
            raise NotImplementedError(
                f"scheme {self.name!r}: not ported yet: {', '.join(bad)}")
        self.cfg = cfg
        self.d = d
        self.m = m
        self.device = resolve_device(device)
        self.p_sched = torch.tensor(
            power.schedule_array(cfg.total_steps, cfg.p_avg,
                                 cfg.power_schedule),
            dtype=torch.float32, device=self.device)

    def init_state(self, d: Optional[int] = None) -> torch.Tensor:
        """Per-device error accumulator Delta_m(0) = 0 (paper Alg. 1)."""
        return torch.zeros((self.d if d is None else d,),
                           dtype=getattr(torch, self.cfg.state_dtype),
                           device=self.device)

    def channel_dim(self, d: Optional[int] = None) -> int:
        raise NotImplementedError

    def p_t(self, step: int, p_factor=1.0) -> torch.Tensor:
        """P_t for this step, scaled by the received-power factor."""
        p = self.p_sched[min(int(step), self.p_sched.shape[0] - 1)]
        return p * p_factor

    def channel_draw(self, key: torch.Tensor, step, m: int) -> ChannelDraw:
        """One round's channel realisation: on the AWGN MAC every device
        transmits at full power (the fading and geometry draws, which use
        ``key``, are not ported yet)."""
        return ChannelDraw(
            torch.ones((m,), dtype=torch.float32, device=self.device),
            torch.ones((m,), dtype=torch.bool, device=self.device))

    def silent_state(self, g, state, new_state):
        """Error state of a non-participating device."""
        return new_state

    def encode(self, g: torch.Tensor, state: torch.Tensor, step: int,
               keys: torch.Tensor, ctx: Optional[MACContext] = None):
        """(M, d) gradients -> ``(frames, new_states, metrics)``."""
        raise NotImplementedError

    def decode(self, y: torch.Tensor, step: int,
               ctx: Optional[MACContext] = None) -> torch.Tensor:
        m = ctx.m if ctx is not None else self.m
        return y / m


@register_scheme("ideal")
class IdealScheme(Scheme):
    """y = sum_m g_m / M over an error-free link."""

    def channel_dim(self, d: Optional[int] = None) -> int:
        return self.d if d is None else d

    def encode(self, g, state, step, keys, ctx=None):
        return g.float(), state, {}


@register_scheme("a_dsgd")
class ADSGDScheme(Scheme):
    """Analog DSGD: the paper's over-the-air scheme (§IV, §IV-A)."""

    analog = True

    @cached_property
    def projector(self):
        return make_projector(self.cfg, self.d)

    @cached_property
    def k(self) -> int:
        if isinstance(self.projector, DenseProjector):
            return self.cfg.k_for(self.d)
        # blocked: k scales with the realised channel dimension
        return max(1, int(self.cfg.k_frac * self.projector.out_dim))

    def channel_dim(self, d: Optional[int] = None) -> int:
        if d is not None and d != self.d:
            raise ValueError(
                "an A-DSGD scheme's channel dimension is fixed by its "
                f"projector (built for d={self.d})")
        return self.projector.out_dim + 2

    def _use_kernel(self, ctx: Optional[MACContext]) -> bool:
        return bool(self.cfg.use_kernel) or (ctx is not None
                                             and ctx.use_kernel)

    def _projector_for(self, ctx: Optional[MACContext]):
        """The projector honouring the context's use_kernel override."""
        proj = self.projector
        if (ctx is not None and ctx.use_kernel
                and not isinstance(proj, DenseProjector)
                and not proj.use_kernel):
            proj = dataclasses.replace(proj, use_kernel=True)
        return proj

    def encode(self, g, state, step, keys, ctx=None):
        cfg = self.cfg
        g = g.float()
        st = state.float()
        p_t = self.p_t(step, ctx.p_factor if ctx is not None else 1.0)
        projector = self._projector_for(ctx)
        if isinstance(projector, DenseProjector):
            g_ec = g + st
            g_sp = compression.top_k_sparsify(g_ec, self.k)
            new_state = g_ec - g_sp
        else:
            tau = compression.sampled_topk_threshold(g + st, self.k, keys)
            g_sp, new_state = ops.ef_sparsify(
                g, st, tau, use_kernel=self._use_kernel(ctx))
        g_tilde = projector.project(g_sp)
        use_mr = step < cfg.mean_removal_steps
        frame, alpha = channel.make_frame(g_tilde, p_t, use_mr)
        metrics = {"alpha": alpha, "p_t": p_t,
                   "frame_power": channel.frame_power(frame)}
        return frame, new_state.to(state.dtype), metrics

    def decode(self, y, step, ctx=None):
        use_mr = step < self.cfg.mean_removal_steps
        y_body = channel.ps_normalize(y, use_mr)
        return amp_decode(y_body, self._projector_for(ctx),
                          self.cfg.amp_iters)

    def silent_state(self, g, state, new_state):
        # a device that could not transmit banks its whole update
        return (g + state).to(new_state.dtype)


# ---------------------------------------------------------------------------
# generic drivers
# ---------------------------------------------------------------------------


def channel_amp(draw: ChannelDraw, dtype=torch.float32) -> torch.Tensor:
    """Per-device amplitude of the received frame: the transmit mask, times
    the channel gain when the draw carries one."""
    active = draw.active.to(dtype)
    return active if draw.gain is None else draw.gain * active


def apply_channel_gain(frames: torch.Tensor, draw: ChannelDraw) -> torch.Tensor:
    """Silence inactive devices and apply the per-device channel gain to a
    stacked (m, s) frame batch."""
    return frames * channel_amp(draw, frames.dtype)[..., None]


def round_sigma2(scheme: Scheme, draw: ChannelDraw):
    """This round's AWGN variance: cfg.sigma2, times the draw's noise
    enhancement when it carries one."""
    if draw.noise_scale is None:
        return scheme.cfg.sigma2
    return scheme.cfg.sigma2 * draw.noise_scale


def encode_round(scheme: Scheme, grads: torch.Tensor, deltas: torch.Tensor,
                 step: int, key: torch.Tensor, ctx: MACContext):
    """The device/channel half of :func:`round_simulated`: per-device
    encode, channel gain, MAC superposition (+AWGN for analog schemes).

    RNG salts as in the reference: ``fold_in(key, 1)`` split into the
    device keys, ``fold_in(key, 2)`` the channel draw, ``fold_in(key, 0)``
    the AWGN.  Returns ``(y, new_deltas, metrics, draw)``.
    """
    m = grads.shape[0]
    dev_keys = rng.split(rng.fold_in(key, 1), m)
    draw = scheme.channel_draw(rng.fold_in(key, 2), step, m)
    frames, new_deltas, metrics = scheme.encode(
        grads, deltas, step, dev_keys, ctx.with_p_factor(draw.p_factor))
    if scheme.analog:
        frames = apply_channel_gain(frames, draw)
        new_deltas = torch.where(draw.active[:, None], new_deltas,
                                 scheme.silent_state(grads, deltas,
                                                     new_deltas))
        y = channel.mac_sum(frames, rng.fold_in(key, 0),
                            round_sigma2(scheme, draw))
    else:
        y = frames.sum(dim=0)
    return y, new_deltas, metrics, draw


def round_simulated(scheme: Scheme, grads: torch.Tensor, deltas: torch.Tensor,
                    step: int, key: torch.Tensor,
                    ctx: Optional[MACContext] = None):
    """M devices on one host. grads/deltas: (M, d). Returns
    ``(ghat, new_deltas, metrics)``."""
    if ctx is None:
        ctx = MACContext(m=scheme.m)
    y, new_deltas, metrics, draw = encode_round(scheme, grads, deltas,
                                                step, key, ctx)
    ghat = scheme.decode(y, step, ctx)
    metrics = {k: v.mean() for k, v in metrics.items()}
    metrics["active_frac"] = draw.active.float().mean()
    if draw.gain is not None:
        metrics["chan_gain"] = draw.gain.mean()
    if draw.noise_scale is not None:
        metrics["noise_scale"] = draw.noise_scale
    return ghat, new_deltas, metrics
