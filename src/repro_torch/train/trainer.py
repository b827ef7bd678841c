"""Distributed train step on a named mesh of rank threads.

The port of the reference's ``repro/train/trainer.py``.  The reference's
step has three phases: per-device gradients in a ``shard_map`` manual over
the OTA axes (GSPMD tensor-parallelises ``'model'`` inside it), the
scheme's aggregation on gradient slices in a ``shard_map`` manual over
every axis, and the optimizer under GSPMD.  The port's
:func:`repro_torch.sharding.shard_map` is manual over every axis of its
mesh and has no automatic sharding, so the phases run as follows.

Phase 1: each OTA device's whole gradient, once, with the params unsplit:
a ``shard_map`` over a mesh of the OTA axes alone, each rank on its slice
of the batch (the loss is the LOCAL batch mean; no cross-device
reduction happens implicitly).  ``'model'`` plays no part in the
function: under GSPMD it only orders the sums inside the tensor-parallel
products, and on one card splitting the model across rank threads saves
neither memory nor time.  The gradient is flattened into the OTA device's
row of a padded ``(M_1..M_k, d_pad)`` stack (the flat layout) or into its
row of each leaf's stack (the sliced layout).  ``global_loss`` is the
rank-order psum of the local losses over the OTA axes over their count;
``loss``, ``ppl`` and ``aux`` are OTA rank 0's, as the reference's ``P()``
out-spec takes them.

Phase 2: the scheme's pipeline on gradient *slices* on the full mesh, the
axes that are not OTA axes sharding the d-vector, through
:func:`repro_torch.core.distributed.sharded_round` under a
:class:`~repro_torch.core.schemes.MACContext` describing the placement.
Every bit that depends on ``'model'`` is the reference's: each rank's
``d_pad / n_shards`` slice, the shard-folded seeds, the per-shard AWGN
keys and the sampled top-k threshold gathered over shards.

Phase 3: unravel ĝ and apply the optimizer to the whole tree.

The error accumulator Delta is a ``(M_1..M_k, d_pad)`` tensor (the flat
layout) or ``{"sh": (M_1..M_k, model, d_sh_pad), "rep": (M_1..M_k,
d_rep_pad)}`` (the sliced layout).  ``param_sharding``, ``opt_sharding``
and ``delta_sharding`` hold the reference's
:class:`~repro_torch.sharding.specs.NamedSharding` trees as metadata: the
tensors live whole on the step's device.

``ota_axes=('data',)`` (or ``('pod', 'data')``) maps one edge device per
data coordinate; ``ota_axes=('pod',)`` is the hierarchical "edge site"
variant: intra-pod aggregation is the ideal mean (the pod's gradient over
its whole batch), the MAC runs across pods.

Only a mesh of rank threads runs the step: a process-group mesh
(:func:`repro_torch.sharding.init_process_mesh`) raises
``NotImplementedError`` (ROADMAP queue 1, item 6).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch import sharding
from repro_torch.configs.base import ArchConfig, OTAConfig, TrainConfig
from repro_torch.convert import tree_leaves, tree_map, unravel
from repro_torch.core import distributed
from repro_torch.core.schemes import MACContext, get_scheme
from repro_torch.device import clock, div_const, resolve_device
from repro_torch.models import model as model_lib
from repro_torch.optim.optim import make_optimizer
from repro_torch.sharding import Mesh, P, psum, shard_map
from repro_torch.sharding.specs import (
    NamedSharding, named_sharding_tree, param_specs,
)


def _pad_multiple(d: int, m: int) -> int:
    return -(-d // m) * m


@functools.lru_cache(maxsize=16)
def abstract_params(cfg: ArchConfig):
    """The model's param tree with shapes and dtypes only: the init run on
    torch's ``meta`` device, so nothing d-sized is materialised."""
    return model_lib.init_params(cfg, rng.PRNGKey(0, device="meta"))


def ravel_meta(aparams):
    """``(d, unravel)`` for an abstract param tree: the total parameter
    count and the flat-vector -> tree unraveller in ``ravel_pytree``'s leaf
    order (the contract the streamed fedllm driver and the flat trainer
    layout both rely on: every device and the PS agree on which gradient
    entry lands in which chunk).  ``unravel(flat)`` returns views into
    ``flat``."""
    d = int(sum(leaf.numel() for leaf in tree_leaves(aparams)))

    def unravel_flat(flat):
        return unravel(flat, aparams)

    return d, unravel_flat


@dataclasses.dataclass
class TrainStep:
    arch: ArchConfig
    train: TrainConfig
    ota: OTAConfig
    ota_axes: Tuple[str, ...]
    mesh: Any
    m_devices: int
    d: int
    d_pad: int
    delta_shape: Any
    delta_sharding: Any
    param_sharding: Any
    opt_sharding: Any
    batch_spec: Any
    device: Any = None
    donate: bool = True
    #: phase 1: ``(params, batch) -> (gstack, metrics)``, each OTA
    #: device's gradient in its row of the layout's stack
    grads_fn: Callable = None
    #: phase 2: ``(gstack, delta, step, key, out_delta) -> (ghat, metrics)``;
    #: writes the new error state into ``out_delta`` and ĝ (a param tree of
    #: views) over the stack
    aggregate_fn: Callable = None
    #: seconds of the last step's phases: ``grads``, ``aggregate``,
    #: ``update`` (the host's clock, read once the device has drained)
    split: Dict[str, float] = dataclasses.field(default_factory=dict)
    _jit_cache: Dict[Any, Any] = dataclasses.field(default_factory=dict)

    def jitted(self, batch_tree):
        """The step callable for batches with ``batch_tree``'s keys (the
        reference's name and cache; nothing compiles)."""
        sig = tuple(sorted(batch_tree.keys()))
        return self._jit_cache.setdefault(sig, self.step_fn)

    def step_fn(self, params, opt_state, delta, batch, step, key):
        """``(params, opt_state, delta, metrics)`` after one step; with
        ``donate`` the new error state is written over ``delta``."""
        dev = self.device
        step, key = int(step), key.to(dev)
        t0 = clock(dev)
        gstack, metrics = self.grads_fn(params, batch)
        t1 = clock(dev)
        new_delta = (delta if self.donate
                     else tree_map(torch.empty_like, delta))
        ghat, agg = self.aggregate_fn(gstack, delta, step, key, new_delta)
        metrics.update(agg)
        t2 = clock(dev)
        params, opt_state = make_optimizer(self.train).apply(params, ghat,
                                                             opt_state)
        del gstack, ghat
        t3 = clock(dev)
        self.split = {"grads": t1 - t0, "aggregate": t2 - t1,
                      "update": t3 - t2}
        return params, opt_state, new_delta, metrics

    def init_state(self, key):
        """``(params, opt_state, delta)`` on the step's device: the params
        of ``init_params(arch, key)``, the optimizer's zero state and a
        zero error accumulator in ``ota.state_dtype``."""
        params = model_lib.init_params(self.arch, key.to(self.device))
        opt_state = make_optimizer(self.train).init(params)
        dtype = getattr(torch, self.ota.state_dtype)
        if isinstance(self.delta_sharding, dict):            # sliced
            delta = {k: torch.zeros(s, dtype=dtype, device=self.device)
                     for k, s in zip(("sh", "rep"), self.delta_shape)}
        else:
            delta = torch.zeros(self.delta_shape, dtype=dtype,
                                device=self.device)
        return params, opt_state, delta


# ---------------------------------------------------------------------------
# shared pieces of the two layouts
# ---------------------------------------------------------------------------


def _placement(mesh: Mesh, ota_axes: Sequence[str]):
    """``(ota_axes, axis_sizes, m_manual, auto_axes)``."""
    if mesh.device_mesh is not None:
        raise NotImplementedError(
            "make_train_step on a process-group mesh: the step runs on a "
            "mesh of rank threads (ROADMAP queue 1, item 6)")
    ota_axes = tuple(ota_axes)
    axis_sizes = dict(zip(mesh.axis_names, mesh.shape))
    m_manual = math.prod(axis_sizes[a] for a in ota_axes)
    auto_axes = tuple(a for a in mesh.axis_names if a not in ota_axes)
    return ota_axes, axis_sizes, m_manual, auto_axes


def _groups(ota: OTAConfig, ota_axes, axis_sizes, m_manual):
    """``(groups, m_eff)``: the grouped psum runs over the LAST OTA axis
    only (a psum's groups are per axis); the requested group count is
    spread across the other OTA axes (e.g. pods)."""
    if not (ota.num_groups and ota.num_groups < m_manual):
        return None, m_manual
    m_last = axis_sizes[ota_axes[-1]]
    other = m_manual // m_last
    npg = max(1, ota.num_groups // other)
    gs = m_last // npg
    groups = tuple(tuple(g * gs + i for i in range(gs)) for g in range(npg))
    return groups, npg * other


def _entry(axes: Tuple[str, ...]):
    """One spec entry over ``axes``: ``None``, a name, or a tuple of names
    (jax's ``PartitionSpec`` writes a one-name tuple as the name)."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def _frame_dtype(ota: OTAConfig):
    return (getattr(torch, ota.frame_dtype) if ota.frame_dtype != "float32"
            else None)


def _opt_specs(opt, aparams, pspecs):
    return {k: (pspecs if k in ("m", "v") else P())
            for k in opt.init(aparams)}


def _writes(spec) -> bool:
    """Whether the calling rank writes its block of an output split by
    ``spec``: the rank at coordinate 0 of every mesh axis ``spec`` does not
    name, as ``shard_map`` assembles an output (``check_vma=False``)."""
    named = {ax for entry in spec if entry is not None
             for ax in ((entry,) if isinstance(entry, str) else entry)}
    mesh = sharding._me().mesh
    return all(sharding.axis_index(ax) == 0 for ax in mesh.axis_names
               if ax not in named)


def _keep_rank0(metrics: Dict[str, Any], out: Dict[str, Any]) -> tuple:
    """Rank 0's metrics into ``out``, as a ``P()`` out-spec takes a value;
    the body's (empty) outputs."""
    if _writes(P()):
        out.update({k: torch.as_tensor(v).detach()
                    for k, v in metrics.items()})
    return ()


def _grads_phase(arch, train_cfg, loss_chunk, ota_axes, dims, m_manual,
                 write_grads):
    """Phase 1 as a ``shard_map`` over a mesh of the OTA axes alone: each
    OTA rank's loss and gradient on its slice of the batch, written by
    ``write_grads(bufs, grads)`` into its row of the caller's buffers.

    Returns ``run(params, batch, bufs, buf_spec) -> metrics`` (OTA rank
    0's ``loss``, ``aux``, ``ppl`` and the mean ``global_loss``)."""
    ota_mesh = Mesh(dims, ota_axes)
    compute_dtype = getattr(torch, train_cfg.compute_dtype)
    batch_spec = P(_entry(ota_axes))

    def run(params, batch, bufs, buf_specs):
        names = sorted(batch)
        out: Dict[str, Any] = {}

        def body(*args):
            local = dict(zip(names, args[len(bufs):]))
            with torch.enable_grad():
                p = tree_map(lambda a: a.detach().requires_grad_(True),
                             params)
                total, metrics = model_lib.loss_fn(
                    p, arch, local, compute_dtype=compute_dtype,
                    remat=train_cfg.remat, loss_chunk=loss_chunk)
                grads = torch.autograd.grad(total, tree_leaves(p))
            write_grads(args[:len(bufs)], grads)
            del p, grads
            loss_g = total.detach()
            for ax in ota_axes:
                loss_g = psum(loss_g, ax)
            metrics["global_loss"] = div_const(loss_g, m_manual)
            return _keep_rank0(metrics, out)

        shard_map(body, ota_mesh,
                  in_specs=(*buf_specs, *([batch_spec] * len(names))),
                  out_specs=())(*bufs, *(batch[k] for k in names))
        return out

    return run


def _device_batch(batch, dev):
    """The batch's arrays (numpy from ``TokenStream``, or tensors) on
    ``dev``."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.array(v))).to(dev)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the flat layout
# ---------------------------------------------------------------------------


def make_train_step(arch: ArchConfig, train_cfg: TrainConfig, ota: OTAConfig,
                    mesh: Mesh, ota_axes: Sequence[str] = ("data",),
                    donate: bool = True, loss_chunk: int = 2048,
                    device=None) -> TrainStep:
    """The flat-layout train step of ``arch`` on ``mesh``, on ``device``
    (the card unless the caller names another).

    ``donate``: the step may write the new error accumulator into the
    input's storage (the reference donates params, optimizer state and
    delta); it never changes a result."""
    dev = resolve_device(device)
    ota_axes, axis_sizes, m_manual, auto_axes = _placement(mesh, ota_axes)
    model_size = axis_sizes.get("model", 1)
    n_shards = math.prod(axis_sizes[a] for a in auto_axes)

    aparams = abstract_params(arch)
    d, unravel_flat = ravel_meta(aparams)
    pad_unit = (ota.block_size * n_shards if ota.projection == "blocked"
                else max(n_shards, 1))
    d_pad = _pad_multiple(d, max(pad_unit, 1))

    groups, m_eff = _groups(ota, ota_axes, axis_sizes, m_manual)
    opt = make_optimizer(train_cfg)
    scheme = get_scheme(ota, d_pad, m_eff, device=dev)
    agg_ctx = MACContext(
        m=m_eff, device_axes=ota_axes, shard_axes=auto_axes, groups=groups,
        fading=ota.fading, csi=scheme.csi, d_pad=d_pad,
        frame_dtype=_frame_dtype(ota), shard_decode=ota.shard_decode,
        use_kernel=ota.use_kernel)

    dims = tuple(axis_sizes[a] for a in ota_axes)
    delta_shape = dims + (d_pad,)
    delta_spec = P(*ota_axes, _entry(auto_axes))
    row_spec = P(*ota_axes, None)
    pspecs = param_specs(aparams, model_size)
    batch_spec = P(_entry(ota_axes))

    def write_flat(bufs, grads):
        torch.cat([g.reshape(-1).float() for g in grads],
                  out=bufs[0].view(d_pad)[:d])

    grads_phase = _grads_phase(arch, train_cfg, loss_chunk, ota_axes, dims,
                               m_manual, write_flat)

    def grads_fn(params, batch):
        gstack = torch.zeros(delta_shape, dtype=torch.float32, device=dev)
        metrics = grads_phase(params, _device_batch(batch, dev), (gstack,),
                              (row_spec,))
        return gstack, metrics

    def aggregate_fn(gstack, delta, step, key, out_delta):
        metrics: Dict[str, Any] = {}

        def agg_body(g, dl, out):
            ghat, nd, met = distributed.sharded_round(
                scheme, g.reshape(-1), dl.reshape(-1), step, key, agg_ctx)
            out.view(-1).copy_(nd)
            g.view(-1).copy_(ghat)        # ĝ over this rank's slice
            return _keep_rank0(met, metrics)

        shard_map(agg_body, mesh,
                  in_specs=(delta_spec, delta_spec, delta_spec),
                  out_specs=())(gstack, delta, out_delta)
        # the OTA device row 0's ĝ (every row holds the same)
        ghat = gstack[(0,) * len(dims)]
        return unravel_flat(ghat[:d]), metrics

    return TrainStep(
        arch=arch, train=train_cfg, ota=ota, ota_axes=ota_axes, mesh=mesh,
        m_devices=m_eff, d=d, d_pad=d_pad, delta_shape=delta_shape,
        delta_sharding=NamedSharding(mesh, delta_spec),
        param_sharding=named_sharding_tree(mesh, pspecs),
        opt_sharding=named_sharding_tree(mesh, _opt_specs(opt, aparams,
                                                          pspecs)),
        batch_spec=batch_spec, device=dev, donate=donate, grads_fn=grads_fn,
        aggregate_fn=aggregate_fn)


# ---------------------------------------------------------------------------
# the sliced layout: slice-local leafwise aggregation
# ---------------------------------------------------------------------------
#
# The d-vector is the concatenation, for each model rank, of that rank's
# local pieces of the model-sharded leaves in leaf order (each piece the
# leaf's slice along its 'model' dimension, flattened).  The OTA pipeline
# needs no canonical element order: top-k is order-free and the
# block-diagonal projection indexes blocks by id.  Leaves replicated over
# 'model' (norm gains, non-divisible embeddings) go through a second,
# shard-replicated sub-frame with its own power share; both sub-frames
# together spend P_t.


def _classify_leaves(aparams, pspecs):
    """``[(leaf, spec, sharded)]`` in leaf order."""
    return [(leaf, spec, any(e == "model" for e in spec))
            for leaf, spec in zip(tree_leaves(aparams), tree_leaves(pspecs))]


def make_train_step_sliced(arch: ArchConfig, train_cfg: TrainConfig,
                           ota: OTAConfig, mesh: Mesh,
                           ota_axes: Sequence[str] = ("data",),
                           donate: bool = True, loss_chunk: int = 2048,
                           device=None) -> TrainStep:
    """The sliced-layout train step (``ota_axes`` cover every axis but
    ``'model'``), on ``device`` (the card unless the caller names
    another)."""
    dev = resolve_device(device)
    ota_axes, axis_sizes, m_manual, auto_axes = _placement(mesh, ota_axes)
    if auto_axes != ("model",):
        raise ValueError("sliced layout supports ota_axes covering all but "
                         "the model axis")
    model_size = axis_sizes["model"]

    aparams = abstract_params(arch)
    pspecs = param_specs(aparams, model_size)
    info = _classify_leaves(aparams, pspecs)
    c = ota.block_size
    # each model rank's share of the sharded leaves, and the replicated
    d_sh = sum(lf.numel() // model_size for lf, _, sh in info if sh)
    d_rep = sum(lf.numel() for lf, _, sh in info if not sh)
    d_sh_pad = _pad_multiple(max(d_sh, c), c)
    d_rep_pad = _pad_multiple(max(d_rep, c), c)
    d_total = d_sh * model_size + d_rep
    p_share_sh = (d_sh * model_size) / d_total
    d = sum(lf.numel() for lf, _, _ in info)

    groups, m_eff = _groups(ota, ota_axes, axis_sizes, m_manual)
    opt = make_optimizer(train_cfg)
    frame_dtype = _frame_dtype(ota)
    scheme = get_scheme(ota, d_sh_pad * model_size + d_rep_pad, m_eff,
                        device=dev)
    # two sub-frames: the model-sharded pieces and the replicated pieces,
    # each with its own power share (sum = P_t) and decorrelated RNG salt
    ctx_sh = MACContext(
        m=m_eff, device_axes=ota_axes, shard_axes=("model",), groups=groups,
        fading=ota.fading, csi=scheme.csi, d_pad=d_sh_pad * model_size,
        p_scale=p_share_sh, frame_dtype=frame_dtype,
        shard_decode=ota.shard_decode, use_kernel=ota.use_kernel)
    ctx_rep = MACContext(
        m=m_eff, device_axes=ota_axes, shard_axes=(), groups=groups,
        fading=ota.fading, csi=scheme.csi, d_pad=d_rep_pad,
        p_scale=1.0 - p_share_sh, key_salt=1789, frame_dtype=frame_dtype,
        shard_decode=ota.shard_decode, use_kernel=ota.use_kernel)

    ota_entry = _entry(ota_axes)
    stacked_specs = [P(ota_entry, *s) for _, s, _ in info]
    row_specs = [P(ota_entry, *([None] * lf.dim())) for lf, _, _ in info]
    delta_sh_spec = P(*ota_axes, "model", None)
    delta_rep_spec = P(*ota_axes, None)
    dims = tuple(axis_sizes[a] for a in ota_axes)
    delta_sh_shape = dims + (model_size, d_sh_pad)
    delta_rep_shape = dims + (d_rep_pad,)
    batch_spec = P(ota_entry)
    n_leaves = len(info)

    def write_leaves(bufs, grads):
        for buf, g in zip(bufs, grads):
            buf[0].copy_(g)

    grads_phase = _grads_phase(arch, train_cfg, loss_chunk, ota_axes, dims,
                               m_manual, write_leaves)

    def _flatten_group(leaves, n_pad):
        flat = torch.zeros(n_pad, dtype=torch.float32, device=dev)
        if leaves:
            n = sum(lf.numel() for lf in leaves)
            torch.cat([lf.reshape(-1) for lf in leaves], out=flat[:n])
        return flat

    def grads_fn(params, batch):
        gstack = [torch.zeros((m_manual, *lf.shape), dtype=torch.float32,
                              device=dev) for lf, _, _ in info]
        metrics = grads_phase(params, _device_batch(batch, dev), gstack,
                              row_specs)
        return gstack, metrics

    def aggregate_fn(gstack, delta, step, key, out_delta):
        metrics: Dict[str, Any] = {}

        def agg_body(*args):
            gl = args[:n_leaves]
            dl_sh, dl_rep, out_sh, out_rep = args[n_leaves:]
            g_sh = _flatten_group(
                [g[0] for g, (_, _, sh) in zip(gl, info) if sh], d_sh_pad)
            g_rep = _flatten_group(
                [g[0] for g, (_, _, sh) in zip(gl, info) if not sh],
                d_rep_pad)
            ghat_sh, nd_sh, met = distributed.sharded_round(
                scheme, g_sh, dl_sh.reshape(-1), step, key, ctx_sh)
            ghat_rep, nd_rep, _ = distributed.sharded_round(
                scheme, g_rep, dl_rep.reshape(-1), step, key, ctx_rep)
            out_sh.view(-1).copy_(nd_sh)
            if _writes(delta_rep_spec):
                out_rep.view(-1).copy_(nd_rep)
            # ĝ over the gradient tree's local pieces
            i_sh = i_rep = 0
            for g, (_, spec, sh) in zip(gl, info):
                n = g[0].numel()
                if sh:
                    g[0].copy_(ghat_sh[i_sh:i_sh + n].view(g[0].shape))
                    i_sh += n
                else:
                    if _writes(P(ota_entry, *spec)):
                        g[0].copy_(ghat_rep[i_rep:i_rep + n].view(
                            g[0].shape))
                    i_rep += n
            return _keep_rank0(met, metrics)

        shard_map(
            agg_body, mesh,
            in_specs=(*stacked_specs, delta_sh_spec, delta_rep_spec,
                      delta_sh_spec, delta_rep_spec),
            out_specs=())(*gstack, delta["sh"], delta["rep"],
                          out_delta["sh"], out_delta["rep"])
        # the OTA device row 0's ĝ leaves, in the params' tree
        rows = iter(g[0] for g in gstack)

        def build(node):
            if isinstance(node, dict):
                return {k: build(node[k]) for k in sorted(node)}
            return next(rows)

        return build(aparams), metrics

    return TrainStep(
        arch=arch, train=train_cfg, ota=ota, ota_axes=ota_axes, mesh=mesh,
        m_devices=m_eff, d=d, d_pad=d_sh_pad * model_size + d_rep_pad,
        delta_shape=(delta_sh_shape, delta_rep_shape),
        delta_sharding={"sh": NamedSharding(mesh, delta_sh_spec),
                        "rep": NamedSharding(mesh, delta_rep_spec)},
        param_sharding=named_sharding_tree(mesh, pspecs),
        opt_sharding=named_sharding_tree(mesh, _opt_specs(opt, aparams,
                                                          pspecs)),
        batch_spec=batch_spec, device=dev, donate=donate, grads_fn=grads_fn,
        aggregate_fn=aggregate_fn)
