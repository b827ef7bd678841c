"""The fully-sharded slice driver and its blocked projection and AMP.

The port of the reference's ``repro/core/distributed.py``.  Every rank of a
mesh (:mod:`repro_torch.sharding`) owns a ``d_pad / n_shards`` slice of its
device row's gradient.  :func:`sharded_round` pre-averages edge-site
groups, runs the scheme's ``encode_slice``, superposes the frame over the
device axes (the MAC psum), adds AWGN for analog schemes and hands the
observation to ``decode_slice``.  The scheme-specific pipeline (EF,
threshold, blocked projection, power scaling, per-block AMP for A-DSGD)
lives on the scheme classes in :mod:`repro_torch.core.schemes`; this
driver never branches on a scheme name.

Cross-shard traffic stays small: the top-k threshold gathers the shards'
strided |g| samples, and the frame's mean and energy are scalar psums.
Each shard's measurement matrices come from a shard-folded seed, which the
PS side folds the same way.

:func:`proj_forward` and :func:`amp_blocked` are the blocked projection and
AMP with a shard's seed: the plain chunked versions, or with ``use_kernel``
the ``ota_project`` and ``amp_fused`` CUDA kernels on a CUDA tensor.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import rng
from repro_torch.core import channel
from repro_torch.core.amp import amp_blocked_core
from repro_torch.device import div_const
from repro_torch.kernels import ops, ref
from repro_torch.sharding import psum


def proj_forward(xb: torch.Tensor, seed, s_block: int, chunk_blocks: int,
                 use_kernel: bool = False) -> torch.Tensor:
    """xb (n_blocks, c) -> (n_blocks, s_block), Rademacher A from ``seed``.

    ``use_kernel``: the ``ota_project`` kernel (its plain version on a CPU
    tensor).  Otherwise each chunk of ``chunk_blocks`` blocks makes its A
    once and takes the product, summed in float64 and rounded once as the
    plain projection sums (:func:`repro_torch.kernels.ref.contract`).
    """
    n_blocks, c = xb.shape
    if use_kernel:
        return ops.ota_project(xb, seed=seed, s_block=s_block,
                               rademacher=True, use_kernel=True)
    outs = []
    for b0 in range(0, n_blocks, chunk_blocks):
        x_c = xb[b0:b0 + chunk_blocks]
        ids = torch.arange(b0, b0 + x_c.shape[0], dtype=torch.int64,
                           device=xb.device)
        A = ref.block_matrix_ref(seed, ids, s_block, c, True)
        outs.append(ref.contract("isc,ic->is", A, x_c))
    return torch.cat(outs, dim=0)


def amp_blocked(yb: torch.Tensor, seed, c: int, iters: int,
                chunk_blocks: int, threshold_mult: float = 1.3,
                debias: bool = True, id_offset=0,
                use_kernel: bool = False) -> torch.Tensor:
    """Per-block AMP of ``yb`` (n_blocks, s_block) -> (n_blocks, c), block
    ``b`` with the global id ``id_offset + b``, so that a rank can decode a
    sub-range of the blocks with the encoder's ids.  With ``use_kernel`` the
    fused ``amp_fused`` kernel (:func:`repro_torch.core.amp.amp_blocked_core`)."""
    return amp_blocked_core(yb, seed, c, iters, chunk_blocks, threshold_mult,
                            debias, rademacher=True, id_offset=id_offset,
                            use_kernel=use_kernel)


def psum_all(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    for ax in axes:
        x = psum(x, ax)
    return x


def _mac_noise(keys: torch.Tensor, n: int, sigma2, n_sites: int,
               site_noise_scale) -> torch.Tensor:
    """``(len(keys), n)``: the receiver noise of each key, from one stacked
    draw.  Entry ``i`` of a draw depends only on its key and ``i`` (jax's
    partitionable threefry, then elementwise maps), so a shorter draw from
    a key is the head of this one: the slots' noise is the first entries of
    their key's row.  With ``n_sites > 1`` each edge site's partial sum
    carries its own noise, summed by the PS combine
    (:func:`repro_torch.core.channel.site_awgn`)."""
    if n_sites > 1:
        return channel.site_awgn(keys, (n,), sigma2, n_sites,
                                 site_noise_scale=site_noise_scale)
    return channel.awgn(keys, (n,), sigma2)


def sharded_round(scheme, g_slice: torch.Tensor, delta_slice: torch.Tensor,
                  step: int, key: torch.Tensor, ctx):
    """One aggregation round on this rank's gradient slice, inside
    :func:`repro_torch.sharding.shard_map` over ``ctx.device_axes`` and
    ``ctx.shard_axes``.  Returns ``(ghat_slice, new_delta, metrics)``.

    ``g_slice``, ``delta_slice``: ``(d_local,)``, this device row's shard of
    the ``ctx.d_pad``-vector.  The body of the frame is psum'd over the
    device axes (in ``ctx.frame_dtype`` for analog schemes), and the slots
    in float32; analog schemes then add AWGN keyed by the shard
    (``fold_in(key, shard_idx)``; the slots ``fold_in(key, n_shards + 7)``),
    one draw per edge site under ``ctx.site_mac``.
    """
    from repro_torch.core.schemes import (
        channel_amp, round_sigma2, shard_info, sharded_channel_draw,
    )
    if ctx.key_salt:
        key = rng.fold_in(key, ctx.key_salt)
    g_slice = g_slice.float()
    group_size = ctx.group_size
    if ctx.groups is not None:
        g_slice = div_const(psum(g_slice, ctx.device_axes[-1],
                                 groups=ctx.groups), group_size)

    if scheme.analog:
        # the same draw on every shard of a device row: the full-M draw
        # from the shared round key, indexed by the device row
        draw = sharded_channel_draw(scheme, key, step, ctx)
        ctx = ctx.with_p_factor(draw.p_factor)
    frame, new_delta, metrics = scheme.encode_slice(
        g_slice, delta_slice, step, key, ctx)
    if scheme.analog:
        amp = channel_amp(draw)
        frame = {k: (v * amp.to(v.dtype) if v is not None else None)
                 for k, v in frame.items()}
        new_delta = torch.where(draw.active, new_delta,
                                scheme.silent_state(g_slice, delta_slice,
                                                    new_delta))

    # the MAC: superposition over the device axes, then AWGN
    body = frame["body"]
    if ctx.frame_dtype is not None and scheme.analog:
        # only analog frames ride the narrow psum: their rounding hides
        # under the channel's noise; the ideal and digital sums stay exact
        body = body.to(ctx.frame_dtype)
    y_body = psum_all(body, ctx.device_axes).float()
    slots = frame.get("slots")
    y_slots = psum_all(slots, ctx.device_axes) if slots is not None else None
    if group_size > 1:
        y_body = div_const(y_body, group_size)
        if y_slots is not None:
            y_slots = div_const(y_slots, group_size)
    if scheme.analog:
        shard_idx, n_shards = shard_info(ctx.shard_axes)
        keys = [rng.fold_in(key, int(shard_idx))]
        if y_slots is not None:
            keys.append(rng.fold_in(key, n_shards + 7))
        n_sites = (len(ctx.groups)
                   if ctx.site_mac and ctx.groups is not None else 1)
        z = _mac_noise(torch.stack(keys), y_body.numel(),
                       round_sigma2(scheme, draw), n_sites,
                       ctx.site_noise_scale)
        y_body = y_body + z[0].reshape(y_body.shape)
        if y_slots is not None:
            y_slots = y_slots + z[1, :y_slots.numel()].reshape(y_slots.shape)

    ghat_slice = scheme.decode_slice({"body": y_body, "slots": y_slots},
                                     step, ctx)
    return ghat_slice, new_delta, metrics
