"""Distributed train step on a named mesh of rank threads or processes.

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

On a process-group mesh (:func:`repro_torch.sharding.init_process_mesh`)
each rank is a process on its own device
(:func:`repro_torch.sharding.process_device`) and every tensor of the
error state and the gradient stack is only that rank's block.  Phase 1's
gradient is computed once per OTA device, by its rank at coordinate 0 of
the other axes, which scatters each of the others its block (a copy
through the host: two processes' products need not round alike); phase 2
runs each rank's ``sharded_round`` in its own process; ĝ is gathered over
the axes that are not OTA axes, and every process applies the same update
to its whole params and optimizer state.  Every process's caller gets OTA
rank 0's metrics.  The bits are the thread mesh's.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch import rng, tracing
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
    #: phase 1: ``(params, batch) -> (gstack, metrics, seconds)``, each
    #: OTA device's gradient in its row of the layout's stack; ``seconds``
    #: of the host-staged hand-off of its blocks (0 on a thread mesh)
    grads_fn: Callable = None
    #: phase 2: ``(gstack, delta, step, key, out_delta) -> (ghat, metrics,
    #: seconds)``; writes the new error state into ``out_delta`` and ĝ (a
    #: param tree of views) over the stack; ``seconds`` of ĝ's host-staged
    #: gather (0 on a thread mesh)
    aggregate_fn: Callable = None
    #: seconds of the last step's phases: ``grads``, ``aggregate``,
    #: ``update`` (the host's clock, read once the device has drained); on
    #: a process-group mesh also the host-staged hand-offs, ``scatter``
    #: (phase 1's gradient blocks) and ``gather`` (ĝ), each taken out of
    #: its phase
    split: Dict[str, float] = dataclasses.field(default_factory=dict)
    _jit_cache: Dict[Any, Any] = dataclasses.field(default_factory=dict)

    def jitted(self, batch_tree):
        """The step callable for batches with ``batch_tree``'s keys (the
        reference's name and cache; nothing compiles)."""
        sig = tuple(sorted(batch_tree.keys()))
        return self._jit_cache.setdefault(sig, self.step_fn)

    def step_fn(self, params, opt_state, delta, batch, step, key):
        """``(params, opt_state, delta, metrics)`` after one step; with
        ``donate`` the new error state is written over ``delta``.  The step
        is a ``round`` span of :mod:`repro_torch.tracing` (``t`` the step),
        its phases 1 and 2 the spans ``step.grads`` and ``step.aggregate``,
        all opened in the calling thread."""
        dev = self.device
        step, key = int(step), key.to(dev)
        with tracing.span("round", t=step):
            t0 = clock(dev)
            with tracing.span("step.grads"):
                gstack, metrics, scatter_s = self.grads_fn(params, batch)
            t1 = clock(dev)
            new_delta = (delta if self.donate
                         else tree_map(torch.empty_like, delta))
            with tracing.span("step.aggregate"):
                ghat, agg, gather_s = self.aggregate_fn(gstack, delta, step,
                                                        key, new_delta)
            metrics.update(agg)
            t2 = clock(dev)
            params, opt_state = make_optimizer(self.train).apply(
                params, ghat, opt_state)
            del gstack, ghat
            t3 = clock(dev)
        self.split = {"grads": t1 - t0 - scatter_s,
                      "aggregate": t2 - t1 - gather_s, "update": t3 - t2}
        if self.mesh.processes:
            self.split.update(scatter=scatter_s, gather=gather_s)
        return params, opt_state, new_delta, metrics

    def init_state(self, key):
        """``(params, opt_state, delta)`` on the step's device: the params
        of ``init_params(arch, key)``, the optimizer's zero state and a
        zero error accumulator in ``ota.state_dtype`` (on a process-group
        mesh, this rank's block of it)."""
        params = model_lib.init_params(self.arch, key.to(self.device))
        opt_state = make_optimizer(self.train).init(params)
        dtype = getattr(torch, self.ota.state_dtype)

        def zeros(shape, named):
            if self.mesh.processes:
                shape = sharding.block_shape(self.mesh, shape, named.spec)
            return torch.zeros(shape, dtype=dtype, device=self.device)

        if isinstance(self.delta_sharding, dict):            # sliced
            delta = {k: zeros(s, self.delta_sharding[k])
                     for k, s in zip(("sh", "rep"), self.delta_shape)}
        else:
            delta = zeros(self.delta_shape, self.delta_sharding)
        return params, opt_state, delta


# ---------------------------------------------------------------------------
# shared pieces of the two layouts
# ---------------------------------------------------------------------------


def _placement(mesh: Mesh, ota_axes: Sequence[str], device):
    """``(ota_axes, axis_sizes, m_manual, auto_axes, device)``: the step's
    device, or on a process-group mesh this rank's."""
    dev = (sharding.process_device(device) if mesh.processes
           else resolve_device(device))
    ota_axes = tuple(ota_axes)
    axis_sizes = dict(zip(mesh.axis_names, mesh.shape))
    m_manual = math.prod(axis_sizes[a] for a in ota_axes)
    auto_axes = tuple(a for a in mesh.axis_names if a not in ota_axes)
    return ota_axes, axis_sizes, m_manual, auto_axes, dev


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


def _keep_rank0(metrics: Dict[str, Any], out: Dict[str, Any], dev) -> tuple:
    """Rank 0's metrics into ``out`` on every caller, as a ``P()`` out-spec
    takes a value (each process of a process-group mesh gets them from
    rank 0 through the host, on ``dev``); the body's (empty) outputs."""
    if sharding._me().mesh.processes:
        out.update(sharding.from_rank0(metrics, dev))
    elif _writes(P()):
        out.update({k: torch.as_tensor(v).detach()
                    for k, v in metrics.items()})
    return ()


def _strip(spec, axes) -> P:
    """``spec`` with every entry that names one of ``axes`` unsplit: a
    block's spec within the row of one OTA device."""
    def named(entry):
        return entry is not None and any(
            ax in axes for ax in ((entry,) if isinstance(entry, str)
                                  else entry))
    return P(*(None if named(e) else e for e in spec))


def _row_shape(mesh: Mesh, block, spec, ota_axes) -> Tuple[int, ...]:
    """The shape of one OTA device's row of the tensor whose block on a
    rank is ``block``, split by ``spec``."""
    shape = list(block.shape)
    for dim, entry in enumerate(_strip(spec, ota_axes)):
        if entry is not None:
            shape[dim] *= math.prod(
                mesh.axis_size(ax) for ax in sharding._axes(entry))
    return tuple(shape)


def _grads_phase(arch, train_cfg, loss_chunk, mesh, ota_axes, dims,
                 m_manual, write_grads, dev):
    """Phase 1: each OTA rank's loss and gradient on its slice of the
    batch, written by ``write_grads(rows, grads)`` into that OTA device's
    row of the buffers.

    Returns ``run(params, batch, bufs, buf_specs) -> (metrics, seconds)``
    (OTA rank 0's ``loss``, ``aux``, ``ppl`` and the mean
    ``global_loss``).  On a mesh of rank threads it is a ``shard_map`` over
    a mesh of the OTA axes alone, ``bufs`` the whole stacks and
    ``buf_specs`` their row specs, and ``seconds`` is 0.  On a
    process-group mesh ``bufs`` are this rank's blocks and ``buf_specs``
    their specs on the whole mesh: the rank at coordinate 0 of the other
    axes computes the row and scatters each member of its group its
    blocks, flattened into one message; ``seconds`` is that hand-off's (on
    a receiving rank, its wait for the row as well)."""
    compute_dtype = getattr(torch, train_cfg.compute_dtype)
    batch_spec = P(_entry(ota_axes))
    auto_axes = tuple(a for a in mesh.axis_names if a not in ota_axes)

    def loss_and_grads(params, local):
        with torch.enable_grad():
            p = tree_map(lambda a: a.detach().requires_grad_(True), params)
            total, metrics = model_lib.loss_fn(
                p, arch, local, compute_dtype=compute_dtype,
                remat=train_cfg.remat, loss_chunk=loss_chunk)
            grads = torch.autograd.grad(total, tree_leaves(p))
        return total.detach(), metrics, grads

    def global_loss(metrics, loss):
        """The mean of the local losses over the OTA axes (after the
        gradient is written and dropped: a rank waits here)."""
        for ax in ota_axes:
            loss = psum(loss, ax)
        metrics["global_loss"] = div_const(loss, m_manual)

    def run_threads(params, batch, bufs, buf_specs):
        names = sorted(batch)
        out: Dict[str, Any] = {}

        def body(*args):
            local = dict(zip(names, args[len(bufs):]))
            loss, metrics, grads = loss_and_grads(params, local)
            write_grads(args[:len(bufs)], grads)
            del grads
            global_loss(metrics, loss)
            return _keep_rank0(metrics, out, dev)

        shard_map(body, Mesh(dims, ota_axes),
                  in_specs=(*buf_specs, *([batch_spec] * len(names))),
                  out_specs=())(*bufs, *(batch[k] for k in names))
        return out, 0.0

    def run_processes(params, batch, bufs, buf_specs):
        with sharding.process_rank(mesh) as coords:
            members = mesh.members(mesh.rank(coords), auto_axes)
            metrics = parts = None
            if members[0] == mesh.rank(coords):
                local = {k: sharding.local_block(mesh, v, batch_spec, coords)
                         for k, v in batch.items()}
                loss, metrics, grads = loss_and_grads(params, local)
                rows = [torch.zeros(_row_shape(mesh, b, spec, ota_axes),
                                    dtype=b.dtype, device=dev)
                        for b, spec in zip(bufs, buf_specs)]
                write_grads(rows, grads)
                del grads
                global_loss(metrics, loss)
                parts = []
                for r in members:
                    blocks = [sharding.local_block(
                        mesh, row, _strip(spec, ota_axes), mesh.coords(r))
                        .reshape(-1) for row, spec in zip(rows, buf_specs)]
                    parts.append(blocks[0] if len(blocks) == 1
                                 else torch.cat(blocks))
                del rows
            t0 = clock(dev)
            flat = (bufs[0].view(-1) if len(bufs) == 1 else torch.empty(
                sum(b.numel() for b in bufs), dtype=bufs[0].dtype,
                device=dev))
            sharding.scatter(parts, auto_axes, flat)
            del parts
            if len(bufs) > 1:
                for b, piece in zip(bufs, flat.split(
                        [b.numel() for b in bufs])):
                    b.view(-1).copy_(piece)
            seconds = clock(dev) - t0
            return sharding.from_rank0(metrics, dev), seconds

    return run_processes if mesh.processes else run_threads


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
    delta); it never changes a result.  On a process-group mesh the step
    runs this process's rank, on ``device`` or the rank's card."""
    ota_axes, axis_sizes, m_manual, auto_axes, dev = _placement(
        mesh, ota_axes, device)
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

    grads_phase = _grads_phase(arch, train_cfg, loss_chunk, mesh, ota_axes,
                               dims, m_manual, write_flat, dev)

    def grads_fn(params, batch):
        if mesh.processes:                  # this rank's block
            gstack = torch.zeros(
                sharding.block_shape(mesh, delta_shape, delta_spec),
                dtype=torch.float32, device=dev)
            spec = delta_spec
        else:
            gstack = torch.zeros(delta_shape, dtype=torch.float32,
                                 device=dev)
            spec = row_spec
        metrics, seconds = grads_phase(params, _device_batch(batch, dev),
                                       (gstack,), (spec,))
        return gstack, metrics, seconds

    def aggregate_fn(gstack, delta, step, key, out_delta):
        metrics: Dict[str, Any] = {}

        def agg_body(g, dl, out):
            ghat, nd, met = distributed.sharded_round(
                scheme, g.reshape(-1), dl.reshape(-1), step, key, agg_ctx)
            out.view(-1).copy_(nd)
            g.view(-1).copy_(ghat)        # ĝ over this rank's slice
            return _keep_rank0(met, metrics, dev)

        shard_map(agg_body, mesh,
                  in_specs=(delta_spec, delta_spec, delta_spec),
                  out_specs=(), held=True)(gstack, delta, out_delta)
        if not mesh.processes:
            # the OTA device row 0's ĝ (every row holds the same)
            return unravel_flat(gstack[(0,) * len(dims)][:d]), metrics, 0.0
        t0 = clock(dev)
        with sharding.process_rank(mesh):
            # ĝ over the whole d: the slices of this rank's OTA row
            ghat = sharding.all_gather(gstack.view(-1), auto_axes,
                                       tiled=True)
        return unravel_flat(ghat[:d]), metrics, clock(dev) - t0

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
    another; on a process-group mesh, the rank's card)."""
    ota_axes, axis_sizes, m_manual, auto_axes, dev = _placement(
        mesh, ota_axes, device)
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

    grads_phase = _grads_phase(arch, train_cfg, loss_chunk, mesh, ota_axes,
                               dims, m_manual, write_leaves, dev)

    def _flatten_group(leaves, n_pad):
        flat = torch.zeros(n_pad, dtype=torch.float32, device=dev)
        if leaves:
            n = sum(lf.numel() for lf in leaves)
            torch.cat([lf.reshape(-1) for lf in leaves], out=flat[:n])
        return flat

    def grads_fn(params, batch):
        shapes = [(m_manual, *lf.shape) for lf, _, _ in info]
        if mesh.processes:                  # this rank's blocks
            shapes = [sharding.block_shape(mesh, shape, spec)
                      for shape, spec in zip(shapes, stacked_specs)]
        gstack = [torch.zeros(shape, dtype=torch.float32, device=dev)
                  for shape in shapes]
        metrics, seconds = grads_phase(
            params, _device_batch(batch, dev), gstack,
            stacked_specs if mesh.processes else row_specs)
        return gstack, metrics, seconds

    def round_leaves(gl, dl_sh, dl_rep, out_sh, out_rep, step, key):
        """The two sub-frames' rounds on a rank's gradient pieces; the new
        error state into ``out_sh`` and, where this rank writes it,
        ``out_rep``.  ``(ĝ of the sharded pieces, of the replicated,
        metrics)``."""
        g_sh = _flatten_group(
            [g[0] for g, (_, _, sh) in zip(gl, info) if sh], d_sh_pad)
        g_rep = _flatten_group(
            [g[0] for g, (_, _, sh) in zip(gl, info) if not sh], d_rep_pad)
        ghat_sh, nd_sh, met = distributed.sharded_round(
            scheme, g_sh, dl_sh.reshape(-1), step, key, ctx_sh)
        ghat_rep, nd_rep, _ = distributed.sharded_round(
            scheme, g_rep, dl_rep.reshape(-1), step, key, ctx_rep)
        out_sh.view(-1).copy_(nd_sh)
        if mesh.processes or _writes(delta_rep_spec):
            out_rep.view(-1).copy_(nd_rep)
        return ghat_sh, ghat_rep, met

    def gathered_leaves(gstack):
        """ĝ's leaves from every model rank's pieces of this process's OTA
        row (a process-group mesh): a sharded leaf's pieces joined along
        its ``'model'`` dimension, a replicated leaf model rank 0's."""
        with sharding.process_rank(mesh):
            pieces = sharding.all_gather(
                torch.cat([g[0].reshape(-1) for g in gstack]), "model")
        leaves, i = [], 0
        for g, (_, spec, sh) in zip(gstack, info):
            shape, n = g.shape[1:], g[0].numel()
            views = [piece[i:i + n].view(shape) for piece in pieces]
            leaves.append(torch.cat(views, dim=list(spec).index("model"))
                          if sh else views[0])
            i += n
        return leaves

    def aggregate_fn(gstack, delta, step, key, out_delta):
        metrics: Dict[str, Any] = {}

        def agg_body(*args):
            gl = args[:n_leaves]
            ghat_sh, ghat_rep, met = round_leaves(gl, *args[n_leaves:],
                                                  step, key)
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
            return _keep_rank0(met, metrics, dev)

        shard_map(
            agg_body, mesh,
            in_specs=(*stacked_specs, delta_sh_spec, delta_rep_spec,
                      delta_sh_spec, delta_rep_spec),
            out_specs=(), held=True)(*gstack, delta["sh"], delta["rep"],
                                     out_delta["sh"], out_delta["rep"])
        seconds = 0.0
        if mesh.processes:
            t0 = clock(dev)
            leaves = gathered_leaves(gstack)
            seconds = clock(dev) - t0
        else:
            # the OTA device row 0's ĝ leaves
            leaves = [g[0] for g in gstack]
        # in the params' tree
        rows = iter(leaves)

        def build(node):
            if isinstance(node, dict):
                return {k: build(node[k]) for k in sorted(node)}
            return next(rows)

        return build(aparams), metrics, seconds

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
