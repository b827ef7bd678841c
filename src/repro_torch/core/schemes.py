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

A sweep's grid writes the reference's second vmap out too: a leading point
axis G in front of the devices (``(G, M, d)`` gradients, ``(G, M, 2)`` keys,
one round key per point), with the per-point schedules swapped onto the
scheme by :meth:`Scheme.with_overrides` as ``(G, T)`` arrays.  Every point
of such a batched round equals its own run: the dense products and the sums
along each device's row run per point (:func:`repro_torch.device.per_point`
says why); the rest runs batched.

Ported: ``ideal``, ``a_dsgd`` (dense and blocked projection), the
digital baselines ``d_dsgd``, ``signsgd`` and ``qsgd``, and the fading
schemes ``a_dsgd_fading``, ``a_dsgd_csi_err`` and ``a_dsgd_blind`` over the
channel axes (fading processes, CSI models, the disk geometry); the
:func:`round_simulated` driver runs them all.  The channel scalars (``fading_threshold``,
``csi_err_var``, ``fading_rho``, ``cell_radius``, ``path_loss_exp``,
``n_subbands``) are 0-dim float32 tensors on the scheme's device, ``(G,)``
in a grid, and every use broadcasts them along the devices.  The robustness
scalars (``ROBUST_SCALARS``: the fault rates, the attack magnitude and the
defences' trim fraction and caps) are held the same way, and
:meth:`Scheme.fault_draw` deals a round's faults
(:mod:`repro_torch.robust.faults`); the fault path itself runs in the
engine's ``round_masked``.  :meth:`Scheme.cohort_channel_draw` and
:meth:`Scheme.cohort_fault_draw` give a sampled cohort its rows of the
full population's draws (:mod:`repro_torch.population`).
"""
from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass
from functools import cached_property
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from repro_torch import rng, sharding
from repro_torch.configs.base import OTAConfig
from repro_torch.core import (
    channel, compression, distributed, fading, geometry, power,
)
from repro_torch.core.amp import amp_decode
from repro_torch.core.projection import DenseProjector, make_projector
from repro_torch.device import (
    div_const, div_f32, per_point, resolve_device, take, xla_sum,
)
from repro_torch.kernels import ops, ref
from repro_torch.robust import faults
from repro_torch.robust.aggregators import _row_energy


@dataclass(frozen=True)
class MACContext:
    """Topology and channel context threaded through encode/decode.

    One context describes one placement of the MAC: which mesh axes act as
    OTA devices and which shard the d-vector (names of a
    :class:`repro_torch.sharding.Mesh`), how devices group into edge sites
    (index groups along the last device axis), and the per-device
    received-power factor ``p_factor`` (``(M,)`` inside a simulated round,
    1.0 on the AWGN MAC).  The slice driver's knobs follow, with the
    reference's defaults; ``frame_dtype`` is a torch dtype (or ``None``)
    for the analog body's psum, and ``use_kernel`` upgrades a blocked
    projector and the slice helpers to the CUDA kernels.
    """
    m: int = 1                                   # effective OTA device count
    device_axes: Tuple[str, ...] = ()            # mesh axes = MAC users
    shard_axes: Tuple[str, ...] = ()             # mesh axes sharding d
    groups: Optional[Tuple[Tuple[int, ...], ...]] = None   # edge-site groups
    fading: str = "none"                         # descriptive channel model
    csi: str = "perfect"                         # descriptive CSI model
    p_factor: Any = 1.0                          # received-power scale
    # slice-driver geometry and knobs
    d_pad: int = 0                               # global padded dimension
    p_scale: float = 1.0                         # power share of this frame
    key_salt: int = 0                            # decorrelates sub-frames
    sample_per_shard: int = 4096                 # threshold sample budget
    chunk_blocks: int = 8                        # A-matrix working set
    frame_dtype: Any = None                      # psum analog bodies narrow
    shard_decode: bool = False                   # split the PS AMP over rows
    use_kernel: bool = False                     # CUDA projection / AMP
    # hierarchical MAC: each edge-site group receives its own AWGN
    site_mac: bool = False
    site_noise_scale: Any = 1.0                  # per-site variance scale

    @property
    def group_size(self) -> int:
        return len(self.groups[0]) if self.groups else 1

    def with_p_factor(self, p_factor) -> "MACContext":
        return dataclasses.replace(self, p_factor=p_factor)


def axis_size(ax: str) -> int:
    """Size of a mesh axis of the calling rank (inside ``shard_map``)."""
    return sharding.axis_size(ax)


def shard_info(shard_axes: Sequence[str]):
    """``(shard_idx, n_shards)`` of the calling rank along ``shard_axes``:
    the row-major index over those axes as a 0-dim int64-held uint32 tensor
    on the host (seeds and keys fold it), and their total size."""
    n_shards = 1
    shard_idx = 0
    for ax in shard_axes:
        sz = axis_size(ax)
        shard_idx = shard_idx * sz + sharding.axis_index(ax)
        n_shards *= sz
    return ref.as_u32(shard_idx), n_shards


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
NOT_PORTED_SCHEMES: Tuple[str, ...] = ()

#: the channel-model scalars a scheme carries, one float32 each (a
#: sweep's ``SCALAR_VMAP_AXES``)
CHANNEL_SCALARS = ("csi_err_var", "fading_threshold", "fading_rho",
                   "cell_radius", "path_loss_exp", "n_subbands")

#: the robustness scalars a scheme carries, one float32 each (a sweep's
#: ``ROBUST_VMAP_AXES``): the fault rates and attack magnitude, and the
#: defences' parameters.  Their kinds (``byz_attack``, ``fault_kind``,
#: ``aggregator``, ``clip_power``) are static config fields
ROBUST_SCALARS = ("byzantine_frac", "fault_rate", "erasure_prob",
                  "byz_scale", "trim_frac", "norm_cap", "power_cap")


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


class Scheme:
    """Base class: state/schedule plumbing and the generic hooks."""

    name: str = "?"
    analog: bool = False
    #: descriptive CSI model of the scheme's channel
    csi: str = "perfect"

    def __init__(self, cfg: OTAConfig, d: int, m: int, device=None):
        self.cfg = cfg
        self.d = d
        self.m = m
        self.device = resolve_device(device)
        self._p_np = power.schedule_array(cfg.total_steps, cfg.p_avg,
                                          cfg.power_schedule)
        self.p_sched = torch.tensor(self._p_np, dtype=torch.float32,
                                    device=self.device)
        # the channel and robustness scalars enter the round as compares
        # and multiplies: a grid swaps (G,) stacks onto a copy through
        # with_overrides
        for name in CHANNEL_SCALARS + ROBUST_SCALARS:
            setattr(self, name, torch.tensor(
                np.float32(getattr(cfg, name)), device=self.device))
        #: run-level keys of the static / gauss_markov gains, of the device
        #: placement and of the Byzantine set: functions of cfg.seed, not
        #: of the round keys
        self.fading_key = fading.fading_base_key(cfg.seed, self.device)
        self.geometry_key = geometry.geometry_base_key(cfg.seed, self.device)
        self.fault_key = faults.fault_base_key(cfg.seed, self.device)

    def init_state(self, d: Optional[int] = None) -> torch.Tensor:
        """Per-device error accumulator Delta_m(0) = 0 (paper Alg. 1)."""
        return torch.zeros((self.d if d is None else d,),
                           dtype=getattr(torch, self.cfg.state_dtype),
                           device=self.device)

    def channel_dim(self, d: Optional[int] = None) -> int:
        raise NotImplementedError

    def with_overrides(self, **attrs) -> "Scheme":
        """Shallow copy with attributes replaced: the sweeps' hook.

        A grid swaps the schedule arrays (``p_sched``, and ``q_sched`` for
        the digital schemes) for ``(G, T)`` stacks of per-point schedules;
        everything shape-defining (projector, k, q_max) stays on the copy.
        """
        new = copy.copy(self)
        for name, value in attrs.items():
            if not hasattr(new, name):
                raise AttributeError(
                    f"scheme {self.name!r} has no attribute {name!r} to "
                    "override")
            setattr(new, name, value)
        return new

    def p_t(self, step: int, p_factor=1.0) -> torch.Tensor:
        """P_t for this step, scaled by the received-power factor.

        With a ``(G, T)`` schedule the result carries the point axis in
        front of the factor's device axis.
        """
        p = self.p_sched[..., min(int(step), self.p_sched.shape[-1] - 1)]
        if p.dim():
            p = p[..., None]
        return p * p_factor

    # ----------------------------------------------------- fading hooks
    @cached_property
    def fading_spec(self) -> fading.FadingSpec:
        """Static channel-model description (process, window, antennas),
        tagged with this scheme's CSI model."""
        return dataclasses.replace(fading.spec_from_cfg(self.cfg),
                                   csi=self.csi)

    def gains(self, key: torch.Tensor, step, m: int):
        """Complex gains (re, im) for this round under cfg.fading_process;
        ``(..., m)`` each for keys ``(..., 2)`` or a ``(G,)`` rho."""
        return fading.process_gains(self.fading_spec, self.fading_key, key,
                                    step, m, rho=self.fading_rho)

    def device_factors(self, key: torch.Tensor, m: int):
        """(received-power factor, participation mask) per device."""
        return (torch.ones((m,), dtype=torch.float32, device=self.device),
                torch.ones((m,), dtype=torch.bool, device=self.device))

    # --------------------------------------------------- geometry hooks
    @property
    def geometry_on(self) -> bool:
        """Static gate of the geometry composition: with ``"none"`` no
        geometry op runs."""
        return self.cfg.geometry != "none"

    @cached_property
    def geometry_spec(self) -> geometry.GeometrySpec:
        """Static cell-geometry description (placement model, antennas)."""
        return geometry.spec_from_cfg(self.cfg)

    def geometry_gains(self, m: int) -> torch.Tensor:
        """``(m,)`` run-constant large-scale gains of the device placement,
        ``(G, m)`` for a ``(G,)`` radius or path-loss exponent."""
        return geometry.large_scale_gains(
            self.geometry_key, m, self.cell_radius, self.path_loss_exp,
            self.geometry_spec)

    def small_scale_draw(self, key: torch.Tensor, step, m: int,
                         mask=None) -> ChannelDraw:
        """The small-scale (fading, CSI) part of the round's realisation;
        channel-aware schemes override this hook."""
        p_factor, active = self.device_factors(key, m)
        return ChannelDraw(p_factor, active)

    def channel_draw(self, key: torch.Tensor, step, m: int,
                     mask=None) -> ChannelDraw:
        """One round's channel realisation, the hook the rounds call.

        The scheme's :meth:`small_scale_draw` with the run-constant
        geometry gains composed onto its power factor when
        ``cfg.geometry`` is on.  ``key`` is the fading-salted round key
        (``fold_in(round_key, 2)``), ``(G, 2)`` for G points; ``mask``
        (``(..., m)`` bool) marks the devices that exist, which draws that
        couple devices (the blind PS combiner) must respect.
        """
        draw = self.small_scale_draw(key, step, m, mask=mask)
        if self.geometry_on:
            draw = draw._replace(
                p_factor=draw.p_factor * self.geometry_gains(m))
        return draw

    def cohort_channel_draw(self, key: torch.Tensor, step,
                            cohort: torch.Tensor, m_total: int,
                            mask=None) -> ChannelDraw:
        """The K-cohort's rows of the full-population channel realisation.

        :meth:`channel_draw` at the population size ``m_total`` from the
        same salted key, then the cohort's rows, so a K < M cohort sees
        the channels the full simulation deals those devices and a K == M
        cohort (``arange(M)``) the dense draw bitwise.  ``mask`` (K,) bool
        marks live cohort rows; it is scattered to the full population so
        that draws which couple devices (the blind PS combiner) see the
        true transmitter set.  A ``(G, K)`` cohort (and mask) with ``(G,
        2)`` keys gives each point its own rows.
        """
        full_mask = None
        if mask is not None:
            full_mask = torch.zeros((*cohort.shape[:-1], m_total),
                                    dtype=torch.bool, device=cohort.device)
            full_mask = full_mask.scatter(-1, cohort, mask)
        draw = self.channel_draw(key, step, m_total, mask=full_mask)

        def rows(v):
            return None if v is None else take(v, cohort, v.dim() - 1)
        return ChannelDraw(rows(draw.p_factor), rows(draw.active),
                           gain=rows(draw.gain),
                           noise_scale=draw.noise_scale)

    def silent_state(self, g, state, new_state):
        """Error state of a non-participating (deep-fade, dropout, or
        unscheduled) device."""
        return new_state

    # ----------------------------------------------------- fault hooks
    @property
    def robust_on(self) -> bool:
        """Static gate of the fault path: the robust master switch, or any
        nonzero configured fault rate (a swept rate axis rides
        ``robust=True``, which the sweep sets)."""
        cfg = self.cfg
        return bool(cfg.robust or cfg.byzantine_frac > 0
                    or cfg.fault_rate > 0 or cfg.erasure_prob > 0)

    def fault_draw(self, key: torch.Tensor, step,
                   m: int) -> faults.FaultDraw:
        """One round's fault realisation.  ``key`` is the fault-salted
        round key (``fold_in(round_key, faults.SALT_FAULT)``), ``(G, 2)``
        for G points; the rates are this scheme's tensors, so
        ``with_overrides`` batches them, and the Byzantine set draws from
        the run-level ``fault_key``."""
        return faults.fault_draw(self.fault_key, key, m,
                                 byzantine_frac=self.byzantine_frac,
                                 fault_rate=self.fault_rate,
                                 erasure_prob=self.erasure_prob,
                                 fault_kind=self.cfg.fault_kind)

    def cohort_fault_draw(self, key: torch.Tensor, step,
                          cohort: torch.Tensor,
                          m_total: int) -> faults.FaultDraw:
        """The K-cohort's rows of the full-population fault realisation,
        the fault analogue of :meth:`cohort_channel_draw`."""
        return faults.take_rows(self.fault_draw(key, step, m_total), cohort)

    def encode(self, g: torch.Tensor, state: torch.Tensor, step: int,
               keys: torch.Tensor, ctx: Optional[MACContext] = None):
        """(M, d) gradients -> ``(frames, new_states, metrics)``."""
        raise NotImplementedError

    def decode(self, y: torch.Tensor, step: int,
               ctx: Optional[MACContext] = None) -> torch.Tensor:
        m = ctx.m if ctx is not None else self.m
        if isinstance(m, torch.Tensor) and m.dim():
            m = m[..., None]        # one masked count per point
        # a true division: the engine divides by its masked count, a tensor,
        # and must agree with round_simulated bitwise on the card too
        return div_f32(y, m)

    # ------------------------------------------------------ slice hooks
    # Optional: schemes that run on gradient slices (the fully-sharded
    # driver, core/distributed.py) implement these.  The frame is a dict
    # with a "body" tensor (psum'd over the device axes, optionally in a
    # narrow dtype) and optional "slots" scalars (float32).
    def encode_slice(self, g_slice, state_slice, step, key, ctx: MACContext):
        raise NotImplementedError(
            f"scheme {self.name!r} does not support the sharded slice "
            "driver (needs a slice-local encode); use the simulated or "
            "round_sharded drivers")

    def decode_slice(self, y: Dict[str, torch.Tensor], step,
                     ctx: MACContext):
        raise NotImplementedError


@register_scheme("ideal")
class IdealScheme(Scheme):
    """y = sum_m g_m / M over an error-free link."""

    def channel_dim(self, d: Optional[int] = None) -> int:
        return self.d if d is None else d

    def encode(self, g, state, step, keys, ctx=None):
        return g.float(), state, {}

    # slice driver: the MAC psum is the aggregation
    def encode_slice(self, g_slice, state_slice, step, key, ctx):
        return ({"body": g_slice}, state_slice,
                {"p_t": torch.zeros((), device=g_slice.device)})

    def decode_slice(self, y, step, ctx):
        return div_const(y["body"], ctx.m)


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
        p_t = p_t.expand(g.shape[:-1])
        projector = self._projector_for(ctx)
        if isinstance(projector, DenseProjector):
            g_ec = g + st
            g_sp = compression.top_k_sparsify(g_ec, self.k)
            new_state = g_ec - g_sp
            g_tilde = per_point(projector.project, g_sp, rank=2)
        else:
            # rows are independent in the threshold (a sort), the sparsifier
            # and the projection: all points' devices in one launch each
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

    # ------------------------------------------------------ slice hooks
    # The fully-sharded pipeline: every rank owns a (d_pad / n_shards)
    # slice.  EF, thresholding, projection and the power scalars are
    # slice-local; cross-shard traffic is the threshold's sample gather and
    # scalar psums.  Each shard's A comes from a shard-folded seed, which
    # the PS side folds the same way.

    def _slice_seed(self, ctx: MACContext):
        """``(seed, shard_idx)``: ``splitmix32(cfg.seed ^ shard_idx)`` as a
        python int (the kernels copy it to the card once per value) and the
        shard's index."""
        shard_idx, _ = shard_info(ctx.shard_axes)
        seed = ref.splitmix32(ref.as_u32(self.cfg.seed) ^ shard_idx)
        return int(seed), shard_idx

    def encode_slice(self, g_slice, state_slice, step, key, ctx):
        cfg = self.cfg
        d_pad = ctx.d_pad
        d_local = g_slice.shape[0]

        # error feedback and the sampled global threshold: the threshold
        # from a strided sample of g + state, then the fused error
        # feedback (the ef_sparsify kernel with use_kernel, as ``encode``)
        st = state_slice.float()
        k = max(1, int(cfg.k_frac * cfg.s_frac * d_pad))
        stride = max(1, d_local // ctx.sample_per_shard)
        n_s = d_local // stride
        local_sample = (g_slice[0:n_s * stride:stride]
                        + st[0:n_s * stride:stride]).abs()
        all_samples = (sharding.all_gather(local_sample,
                                           ctx.shard_axes).reshape(-1)
                       if ctx.shard_axes else local_sample)
        tau = compression._quantile_linear(all_samples, 1.0 - k / d_pad)
        g_sp, new_state = ops.ef_sparsify(g_slice, st, tau,
                                          use_kernel=self._use_kernel(ctx))
        new_state = new_state.to(state_slice.dtype)

        # blocked projection with the shard-folded seed
        c = cfg.block_size
        s_block = max(2, int(round(cfg.s_frac * c)))
        seed, _ = self._slice_seed(ctx)
        yb = distributed.proj_forward(
            g_sp.reshape(d_local // c, c), seed, s_block, ctx.chunk_blocks,
            use_kernel=self._use_kernel(ctx))

        # power scaling (paper eq. 13/22), the scalars psum'd over shards;
        # ctx.p_factor is this device's received-power factor
        p_t = self.p_t(step, ctx.p_factor) * ctx.p_scale
        use_mr = float(step < cfg.mean_removal_steps)
        s_tilde = float((d_pad // c) * s_block)       # global channel dim
        y_sum, y_energy = _slice_sums(yb)
        mu = div_const(use_mr * distributed.psum_all(y_sum, ctx.shard_axes),
                       s_tilde)
        energy = distributed.psum_all(y_energy, ctx.shard_axes)
        energy_az = rng.fma_f32(-(s_tilde - 1.0) * mu, mu, energy) + 1.0
        alpha = p_t / torch.clamp(energy_az, min=1e-12)
        ra = torch.sqrt(alpha)
        frame = {"body": ra * (yb - mu), "slots": torch.stack([ra * mu, ra])}
        metrics = {"alpha": alpha, "p_t": p_t, "tau": tau,
                   "frame_power": alpha * energy_az}
        return frame, new_state, metrics

    def decode_slice(self, y, step, ctx):
        cfg = self.cfg
        body, slots = y["body"], y["slots"]
        use_mr = float(step < cfg.mean_removal_steps)
        # a noise-dominated scale slot falls back to 1.0, as in
        # channel.ps_normalize
        scale = torch.where(slots[1] > channel.SCALE_SLOT_FLOOR, slots[1],
                            1.0)
        y_norm = (body + use_mr * slots[0]) / scale
        seed, _ = self._slice_seed(ctx)
        use_kernel = self._use_kernel(ctx)
        c = cfg.block_size
        if ctx.shard_decode and ctx.device_axes:
            # y is the same on every device row after the psum: each row
            # decodes 1/rows of its blocks (padded to a multiple of the
            # rows) with their global ids, and the rows' results are
            # gathered
            n_rows, row_idx = 1, 0
            for ax in ctx.device_axes:
                sz = axis_size(ax)
                row_idx = row_idx * sz + sharding.axis_index(ax)
                n_rows *= sz
            nb = y_norm.shape[0]
            nb_pad = -(-nb // n_rows) * n_rows
            y_p = torch.cat([y_norm, y_norm.new_zeros(nb_pad - nb,
                                                      y_norm.shape[1])])
            per = nb_pad // n_rows
            y_mine = y_p[row_idx * per:(row_idx + 1) * per].contiguous()
            x_mine = distributed.amp_blocked(
                y_mine, seed, c, cfg.amp_iters, ctx.chunk_blocks,
                id_offset=row_idx * per, use_kernel=use_kernel)
            xg = sharding.all_gather(x_mine, ctx.device_axes, tiled=True)
            return xg[:nb].reshape(-1)
        return distributed.amp_blocked(
            y_norm, seed, c, cfg.amp_iters, ctx.chunk_blocks,
            use_kernel=use_kernel).reshape(-1)


# ---------------------------------------------------------------------------
# A-DSGD over fading MACs (follow-ups 1907.09769 / 1907.03909): truncated
# inversion under perfect / estimated CSI, and CSI-free blind transmission
# ---------------------------------------------------------------------------


@register_scheme("a_dsgd_fading")
class ADSGDFadingScheme(ADSGDScheme):
    """A-DSGD under Rayleigh fading with truncated channel inversion
    (perfect CSI): devices below the fade threshold stay silent and bank
    their whole update; the rest pre-invert, so the usable received power
    is ``P_t * h_m**2``.  The gain process comes from ``cfg.fading_process``.
    """

    def device_factors(self, key, m):
        h = channel.rayleigh_gains(key, m)
        return channel.truncated_inversion_power(h, self.fading_threshold)

    def small_scale_draw(self, key, step, m, mask=None):
        re, im = self.gains(key, step, m)
        h = fading.magnitude(re, im)
        p_factor, active = channel.truncated_inversion_power(
            h, self.fading_threshold)
        return ChannelDraw(p_factor, active)


@register_scheme("a_dsgd_csi_err")
class ADSGDCSIErrScheme(ADSGDFadingScheme):
    """Truncated inversion driven by a noisy CSI estimate ``h_hat = h + e``,
    ``e ~ CN(0, csi_err_var)``: the truncation and the power budget follow
    ``|h_hat|``, and the frame arrives scaled by ``Re(h / h_hat)``.  At
    ``csi_err_var == 0`` every quantity is bitwise
    :class:`ADSGDFadingScheme`'s."""

    csi = "noisy"

    def small_scale_draw(self, key, step, m, mask=None):
        re, im = self.gains(key, step, m)
        est_re, est_im = fading.csi_estimate(re, im, rng.fold_in(key, 3),
                                             self.csi_err_var)
        h_est = fading.magnitude(est_re, est_im)
        p_factor, active = channel.truncated_inversion_power(
            h_est, self.fading_threshold)
        gain = fading.misalignment_gain(re, im, est_re, est_im,
                                        self.csi_err_var)
        return ChannelDraw(p_factor, active, gain=gain)


@register_scheme("a_dsgd_blind")
class ADSGDBlindScheme(ADSGDScheme):
    """A-DSGD with blind transmitters (no CSI at the devices): every device
    sends its plain power-scaled frame, and the PS's K antennas combine the
    superposed observations (:func:`fading.blind_combiner_stats`).  Each
    frame carries a per-device gain and the AWGN variance is scaled by the
    combiner's noise enhancement; the decode is untouched."""

    csi = "none"

    def small_scale_draw(self, key, step, m, mask=None):
        k_ant = self.fading_spec.ps_antennas
        re, im = self.gains(key, step, m * k_ant)
        re = re.reshape(*re.shape[:-1], m, k_ant)
        im = im.reshape(*im.shape[:-1], m, k_ant)
        if mask is not None:
            # devices that do not exist must not enter the combiner
            live = mask.to(re.dtype)[..., None]
            re, im = re * live, im * live
        gain, noise_scale = fading.blind_combiner_stats(re, im)
        return ChannelDraw(
            torch.ones((m,), dtype=torch.float32, device=self.device),
            torch.ones((m,), dtype=torch.bool, device=self.device),
            gain=gain, noise_scale=noise_scale)


# ---------------------------------------------------------------------------
# digital baselines (paper §III, §VI): quantize to the MAC bit budget R_t
# ---------------------------------------------------------------------------


class _BitBudgetScheme(Scheme):
    """Shared plumbing for the digital schemes: the per-step budget q_t is
    precomputed on the host from the MAC capacity R_t (paper eq. 8/9)."""

    def __init__(self, cfg: OTAConfig, d: int, m: int, device=None):
        super().__init__(cfg, d, m, device=device)
        q_np = self.build_q_schedule(m, self._p_np)
        self.q_sched = torch.tensor(q_np, dtype=torch.int32,
                                    device=self.device)
        self.q_max = int(max(int(q_np.max()), 1))

    def build_q_schedule(self, m: int, p_np) -> np.ndarray:
        """Host-precomputed q_t array for an (m, P_t) pair: the one budget
        and cap rule, shared with the sweeps (which build each grid point's
        schedule with its effective device count)."""
        return compression.digital_q_schedule(
            self.d, self.cfg.s_for(self.d), m, p_np, self.cfg.sigma2,
            scheme=self.name, l_q=self.cfg.quant_bits,
            q_cap=min(self.d // 2, 1 << 16))

    def channel_dim(self, d: Optional[int] = None) -> int:
        return self.cfg.s_for(self.d if d is None else d)

    def q_t(self, step: int) -> torch.Tensor:
        """This step's budget: a 0-dim int32, or ``(G,)`` for G points."""
        return self.q_sched[..., min(int(step), self.q_sched.shape[-1] - 1)]

    def encode(self, g, state, step, keys, ctx=None):
        g = g.float()
        p_t = self.p_t(step, ctx.p_factor if ctx is not None else 1.0)
        q_t = self.q_t(step)
        # one budget per row: a point's q_t reaches each of its devices
        q_rows = q_t[..., None] if q_t.dim() else q_t
        v_q, new_state = self.compress(g, state, q_rows, keys)
        rows = g.shape[:-1]
        return v_q, new_state, {"q_t": q_rows.expand(rows),
                                "p_t": p_t.expand(rows)}

    def compress(self, g, state, q_t, keys):
        raise NotImplementedError


@register_scheme("d_dsgd")
class DDSGDScheme(_BitBudgetScheme):
    """Digital DSGD: error feedback + SBC quantization (paper §III)."""

    def compress(self, g, state, q_t, keys):
        g_ec = g + state.float()
        v_q = compression.sbc_quantize(g_ec, q_t, self.q_max)
        return v_q, (g_ec - v_q).to(state.dtype)

    def silent_state(self, g, state, new_state):
        # a D-DSGD device that failed mid-round banks its whole update
        # (error feedback over the digital link): a robust dropout, or a
        # device the scheduler left out
        return (g + state).to(new_state.dtype)


@register_scheme("signsgd")
class SignSGDScheme(_BitBudgetScheme):
    """SignSGD [16] adapted to the bit budget (paper eq. 43)."""

    def compress(self, g, state, q_t, keys):
        return compression.signsgd_compress(g, q_t, self.q_max), state


@register_scheme("qsgd")
class QSGDScheme(_BitBudgetScheme):
    """QSGD [2] adapted to the bit budget (paper eq. 44)."""

    def compress(self, g, state, q_t, keys):
        return compression.qsgd_compress(g, q_t, self.q_max,
                                         self.cfg.quant_bits, keys), state


def registered_schemes() -> Tuple[str, ...]:
    """Every registered scheme name (registration order), evaluated live."""
    return tuple(SCHEME_REGISTRY)


# ---------------------------------------------------------------------------
# generic drivers
# ---------------------------------------------------------------------------


def _slice_sums(yb: torch.Tensor):
    """``(sum(yb), sum(yb * yb))`` of a shard's projected blocks in XLA's
    CPU order for one block (:func:`repro_torch.device.xla_sum`, the
    squares as ``robust.aggregators._row_energy`` sums a row).  For
    several blocks XLA orders the 2-D reduction otherwise, which is not
    reproduced (ROADMAP queue 3)."""
    flat = yb.reshape(-1)
    return xla_sum(flat), _row_energy(flat)[0]


def metric_mean(v: torch.Tensor) -> torch.Tensor:
    """The mean over the device axis of one per-device metric, per point.

    Float metrics take torch's mean.  An integer metric (the digital
    schemes' q_t) averages as ``jnp.mean`` does: ``torch.mean`` rejects
    integers, and jnp gives float32 as the sum times ``f32(1/M)``.
    """
    if v.dtype.is_floating_point:
        return v.mean(dim=-1)
    return v.sum(dim=-1).to(torch.float32) * float(
        np.float32(1.0 / v.shape[-1]))


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
    return float(np.float32(scheme.cfg.sigma2)) * draw.noise_scale


def encode_round(scheme: Scheme, grads: torch.Tensor, deltas: torch.Tensor,
                 step: int, key: torch.Tensor, ctx: MACContext):
    """The device/channel half of :func:`round_simulated`: per-device
    encode, channel gain, MAC superposition (+AWGN for analog schemes).

    RNG salts as in the reference: ``fold_in(key, 1)`` split into the
    device keys, ``fold_in(key, 2)`` the channel draw, ``fold_in(key, 0)``
    the AWGN.  Returns ``(y, new_deltas, metrics, draw)``.
    """
    m = grads.shape[-2]
    dev_keys = rng.split(rng.fold_in(key, 1), m)
    draw = scheme.channel_draw(rng.fold_in(key, 2), step, m)
    frames, new_deltas, metrics = scheme.encode(
        grads, deltas, step, dev_keys, ctx.with_p_factor(draw.p_factor))
    if scheme.analog:
        frames = apply_channel_gain(frames, draw)
        new_deltas = torch.where(draw.active[..., None], new_deltas,
                                 scheme.silent_state(grads, deltas,
                                                     new_deltas))
        y = channel.mac_sum(frames, rng.fold_in(key, 0),
                            round_sigma2(scheme, draw))
    else:
        y = frames.sum(dim=-2)
    return y, new_deltas, metrics, draw


def round_simulated(scheme: Scheme, grads: torch.Tensor, deltas: torch.Tensor,
                    step: int, key: torch.Tensor,
                    ctx: Optional[MACContext] = None):
    """M devices on one host. grads/deltas: (M, d). Returns
    ``(ghat, new_deltas, metrics)``.

    G points at once: grads/deltas (G, M, d), one key per point (G, 2);
    ghat is (G, d) and every metric (G,)."""
    if ctx is None:
        ctx = MACContext(m=scheme.m)
    y, new_deltas, metrics, draw = encode_round(scheme, grads, deltas,
                                                step, key, ctx)
    ghat = scheme.decode(y, step, ctx)
    metrics = {k: metric_mean(v) for k, v in metrics.items()}
    # each point's own mean, whether the draw is shared or per point
    lead = ghat.shape[:-1]
    metrics["active_frac"] = draw.active.float().mean(dim=-1).expand(lead)
    if draw.gain is not None:
        metrics["chan_gain"] = draw.gain.mean(dim=-1).expand(lead)
    if draw.noise_scale is not None:
        metrics["noise_scale"] = draw.noise_scale.expand(lead)
    return ghat, new_deltas, metrics


def sharded_channel_draw(scheme: Scheme, key: torch.Tensor, step,
                         ctx: MACContext) -> ChannelDraw:
    """This rank's channel realisation inside ``shard_map``.

    Every rank evaluates the full-M draw from the shared round key (salt
    2, as :func:`round_simulated`) and takes its device row's entry: the
    realisation is common knowledge, which the correlated processes and
    the blind PS combiner (whose gain couples all devices) need.
    """
    dev_idx, _ = shard_info(ctx.device_axes)
    draw = scheme.channel_draw(rng.fold_in(key, 2), step, ctx.m)
    row = int(dev_idx)

    def pick(v):
        # jax's dynamic index clamps: with edge-site groups the draw has
        # one row per group (ctx.m), fewer than the device rows
        return None if v is None else v[min(row, v.shape[0] - 1)]
    return ChannelDraw(pick(draw.p_factor), pick(draw.active),
                       gain=pick(draw.gain), noise_scale=draw.noise_scale)


def round_sharded(scheme: Scheme, g_local: torch.Tensor,
                  delta_local: torch.Tensor, step: int, key: torch.Tensor,
                  ctx: MACContext):
    """One aggregation round inside ``shard_map``, one device per rank of
    ``ctx.device_axes``: ``g_local``, ``delta_local`` are this device's
    ``(d,)`` gradient and error state.  Returns ``(ghat, new_delta,
    metrics)``.

    ``ctx.groups``: optional index groups along the last device axis for
    the ideal intra-site average (an edge-site mapping); the MAC psum then
    runs over all devices and is divided by the group size.  RNG salts as
    in :func:`round_simulated`: ``fold_in(key, 1)`` the device's encode
    (one key: the port's ``encode`` takes this one row as a stack of one),
    ``fold_in(key, 2)`` the channel draw, ``fold_in(key, 0)`` the AWGN.
    """
    group_size = ctx.group_size
    if ctx.groups is not None:
        g_local = div_const(sharding.psum(g_local, ctx.device_axes[-1],
                                          groups=ctx.groups), group_size)
    p_factor = 1.0
    if scheme.analog:
        draw = sharded_channel_draw(scheme, key, step, ctx)
        p_factor = draw.p_factor[None]
    frames, new_deltas, metrics = scheme.encode(
        g_local[None], delta_local[None], step,
        rng.fold_in(key, 1)[None], ctx.with_p_factor(p_factor))
    frame, new_delta = frames[0], new_deltas[0]
    metrics = {k: v.reshape(-1)[0] for k, v in metrics.items()}
    if scheme.analog:
        frame = frame * channel_amp(draw, frame.dtype)
        new_delta = torch.where(draw.active, new_delta,
                                scheme.silent_state(g_local, delta_local,
                                                    new_delta))
    y = distributed.psum_all(frame, ctx.device_axes)
    if group_size > 1:
        y = div_const(y, group_size)
    if scheme.analog:
        mac_key = rng.fold_in(key, 0)
        sigma2 = round_sigma2(scheme, draw)
        if ctx.site_mac and ctx.groups is not None and len(ctx.groups) > 1:
            # each edge-site group's partial OTA sum carries its own
            # receiver noise, summed by the backhaul combine
            y = y + channel.site_awgn(mac_key, y.shape, sigma2,
                                      len(ctx.groups),
                                      site_noise_scale=ctx.site_noise_scale)
        else:
            y = y + channel.awgn(mac_key, y.shape, sigma2)
    ghat = scheme.decode(y, step, ctx)
    return ghat, new_delta, metrics
