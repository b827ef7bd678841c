"""Dry run: trace every (arch x shape x mesh) step of the port on torch's
``meta`` device and count what each device of the production mesh would
do, for :mod:`repro_torch.benchmarks.roofline`.

The port of the reference's ``repro/launch/dryrun.py``.  The reference
lowers and compiles each step for 256 or 512 forced host devices and reads
XLA's cost and memory analyses; the port runs its own train, prefill and
decode steps on ``meta`` tensors, which carry shapes and dtypes and no
data, under a counter (:class:`Counter`), so nothing d-sized is allocated
on any device and no card is needed.  Each record has the reference's
keys, so one roofline reads both trees' records:

* ``flops``: the matrix products' FLOPs (``torch.utils.flop_counter``'s
  rules) plus the kernels' operations (:mod:`repro_torch.kernels.cost`),
  every loop step counted (XLA's ``cost_analysis`` counts a scan's body
  once; the roofline uses the analytic model for both);
* ``bytes_accessed``: each op's inputs read once and outputs written once,
  plus the kernels' bytes: an unfused upper bound (views and allocations
  move nothing);
* ``collective_bytes``: the output bytes of each collective the port's
  transport makes, by the reference's HLO kinds (a ``psum`` over each axis
  is an ``all-reduce``, an ``all_gather`` an ``all-gather``; the kinds the
  port never issues stay 0);
* ``mem_per_device``: ``argument_bytes`` and ``output_bytes`` from each
  leaf's shard shape under the step's spec trees, the layout the
  reference compiles; ``temp_bytes`` the peak of the bytes the traced step
  held live at once.

Those four are the busiest device's.  The step's rank threads map onto
the production mesh's devices by their coordinates (phase 1's OTA rank
``d`` onto device ``(d, 0)``; the work outside any rank, such as phase 3's
optimizer over the whole tree, onto device 0), and each field is the
largest over the devices.  ``thread_mesh`` has the same counts summed over
every rank, as the port's mesh of rank threads runs them all on one card,
and ``kernels`` each kernel's traced calls and their counts.
``compile_seconds`` holds the trace's seconds (nothing compiles).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm_360m --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import threading
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import rng, sharding
from repro_torch.configs import (
    ARCH_IDS, INPUT_SHAPES, ArchConfig, ShapeConfig, TrainConfig,
    active_param_count, approx_param_count, get_config, ota_overrides,
)
from repro_torch.convert import tree_leaves
from repro_torch.kernels import cost
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer
from repro_torch.optim.optim import make_optimizer
from repro_torch.sharding import P
from repro_torch.train import serve as serve_lib
from repro_torch.train import trainer as trainer_lib

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

# shapes whose decode needs a sliding window (sub-quadratic rule)
LONG_WINDOW = 8192
SKIPS = {
    # (arch, shape): reason -- recorded, not silently dropped
    ("whisper_base", "long_500k"):
        "enc-dec with <=448-token decoder context; 500k decode is void",
}

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

META = torch.device("meta")


def decode_window_for(arch: ArchConfig, shape: ShapeConfig) -> Optional[int]:
    if shape.name != "long_500k":
        return None
    if arch.family in ("ssm",):
        return None                       # no KV cache at all
    return LONG_WINDOW                    # dense/moe/vlm/hybrid: SWA variant


def input_specs(arch: ArchConfig, shape: ShapeConfig,
                train_cfg: Optional[TrainConfig] = None
                ) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins for every model input of this shape."""
    B, L = shape.global_batch, shape.seq_len

    def sds(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device=META)

    if shape.kind == "train" or shape.kind == "prefill":
        n_text = L - (arch.n_vision_tokens if arch.family == "vlm" else 0)
        batch = {"tokens": sds((B, n_text), torch.int32)}
        if arch.family == "vlm":
            batch["extra"] = sds((B, arch.n_vision_tokens, arch.d_model),
                                 torch.bfloat16)
            batch["positions"] = sds((B, L, 3), torch.int32)
        if arch.encoder is not None:
            e = arch.encoder
            batch["frames"] = sds((B, e.n_frames, e.d_model), torch.bfloat16)
        return batch
    # decode: one new token + cache handled separately
    return {"tokens": sds((B, 1), torch.int32)}


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

# ops that move no bytes: allocations (views are told apart by ``is_view``)
_NO_TRAFFIC = {torch.ops.aten.empty, torch.ops.aten.empty_strided,
               torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided,
               torch.ops.aten.empty_like, torch.ops.aten.detach,
               torch.ops.aten.alias, torch.ops.aten.lift_fresh}


def _tensors(x):
    """The tensors in an op's arguments or outputs (nested lists, tuples
    and dicts)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class _Device:
    """One device's counts."""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVE_KINDS, 0.0))
    live: int = 0
    peak: int = 0


class _Mode(TorchDispatchMode):
    """Counts each op of one thread into one device's counts."""

    def __init__(self, counter: "Counter", key):
        super().__init__()
        self.counter, self.key = counter, key

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return self.counter._dispatch(self.key, func, args, kwargs or {})


_PLAIN = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.layout, torch.memory_format)


def _describe(a):
    """A hashable description of an op's argument by its metadata, or
    ``None`` where the op's outputs may depend on more than that."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "meta":
            return None
        return (tuple(a.shape), a.stride(), a.dtype)
    if isinstance(a, (list, tuple)):
        parts = tuple(_describe(x) for x in a)
        return None if None in parts else ("seq", parts)
    if isinstance(a, _PLAIN):
        return (type(a), a)
    return None


def _out_spec(out):
    if isinstance(out, torch.Tensor):
        return ((tuple(out.shape), out.stride(), out.dtype)
                if out.device.type == "meta" else None)
    if isinstance(out, (list, tuple)):
        parts = [_out_spec(x) for x in out]
        return None if None in parts else (type(out), parts)
    return None


def _storages(tree) -> set:
    return {id(t.untyped_storage()) for t in _tensors(tree)}


def _shares_storage(args, out) -> bool:
    return bool(_storages(args) & _storages(out))


def _from_spec(spec):
    if isinstance(spec[0], tuple):
        shape, stride, dtype = spec
        return torch.empty_strided(shape, stride, dtype=dtype, device=META)
    kind, parts = spec
    return kind(_from_spec(p) for p in parts)


class Counter:
    """Counts a traced step's work per device of ``mesh`` (the production
    mesh the step is laid out on).

    Use ``with counter:`` around the step: the calling thread's ops count
    for device 0, and each rank thread of :func:`repro_torch.sharding.
    shard_map` for the device at its coordinates (0 on the axes its mesh
    lacks).  A tensor made off ``meta`` is noted in ``off_meta``, but for
    the host's 0-dim integers (the shard-folded seeds and shard indices,
    which the port keeps on the host by design), which ``host_scalars``
    counts."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.devices: Dict[tuple, _Device] = {}
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.off_meta: list = []
        self.host_scalars = 0
        self.cache: Dict[Any, Any] = {}
        self._pure: Dict[Any, bool] = {}
        self.live = self.peak = 0
        self.lock = threading.Lock()
        self._stack: list = []
        #: what the storages this count saw carry (not the counter: a
        #: cached abstract param outlives it)
        self.token = object()

    # -- entering ---------------------------------------------------------

    def device_key(self, sub_mesh=None, rank: int = 0) -> tuple:
        if sub_mesh is None:
            return (0,) * len(self.mesh.shape)
        coords = dict(zip(sub_mesh.axis_names, sub_mesh.coords(rank)))
        return tuple(coords.get(ax, 0) for ax in self.mesh.axis_names)

    def _thread_context(self, key) -> contextlib.ExitStack:
        """The calling thread's ops, kernel calls and collectives counted
        for device ``key``, and its rank threads for theirs."""
        stack = contextlib.ExitStack()
        stack.enter_context(cost.counting(
            lambda name, c: self._kernel(key, name, c)))
        stack.enter_context(sharding.observe_collectives(
            lambda kind, out: self._collective(key, kind, out)))
        stack.enter_context(sharding.rank_context(self._rank_context))
        stack.enter_context(_Mode(self, key))
        return stack

    @contextlib.contextmanager
    def _rank_context(self, sub_mesh, rank):
        with self._thread_context(self.device_key(sub_mesh, rank)):
            yield

    def __enter__(self):
        self._stack.append(self._thread_context(self.device_key()))
        return self

    def __exit__(self, *exc):
        self._stack.pop().close()

    # -- counting ---------------------------------------------------------

    def _dev(self, key) -> _Device:
        dev = self.devices.get(key)
        if dev is None:
            dev = self.devices[key] = _Device()
        return dev

    def _cacheable(self, func) -> bool:
        """Whether ``func`` makes fresh outputs whose metadata follows from
        its arguments' alone: no view, no write into an argument."""
        ok = self._pure.get(func)
        if ok is None:
            schema = func._schema
            ok = self._pure[func] = not (
                func.is_view or schema.is_mutable
                or any(r.alias_info is not None for r in schema.returns))
        return ok

    def _dispatch(self, key, func, args, kwargs):
        """Run ``func`` (or make its outputs from an earlier call on the
        same metadata: a meta op's outputs follow from its arguments'
        shapes, strides and dtypes, and each rank repeats the others'
        ops) and count it for device ``key``."""
        sig = None
        if self._cacheable(func):
            sig = _describe((args, tuple(sorted(kwargs.items()))))
        hit = self.cache.get((func, sig)) if sig is not None else None
        if hit is None:
            out = func(*args, **kwargs)
            work = self._work(func, args, kwargs, out)
            if sig is not None:
                spec = _out_spec(out)
                if _shares_storage(args, out):
                    # an alias the schema does not declare (``_unsafe_view``)
                    self._pure[func] = False
                elif spec is not None:
                    self.cache[(func, sig)] = (spec, work)
        else:
            spec, work = hit
            out = _from_spec(spec)
        dev = self._dev(key)
        dev.flops += work[0]
        dev.bytes_accessed += work[1]
        # a storage first seen as an input was made before the count
        # began (an argument of the step): a view of it or an in-place
        # write into it allocates nothing
        for t in _tensors((args, kwargs)):
            if t.device.type == "meta":
                self._track(key, t, held=False)
        for t in _tensors(out):
            if t.device.type == "meta":
                self._track(key, t)
            elif t.device.type == "cpu" and t.numel() <= 1:
                self.host_scalars += 1
            else:
                self.off_meta.append((str(func), str(t.device),
                                      tuple(t.shape)))
        return out

    @staticmethod
    def _work(func, args, kwargs, out):
        """``(flops, bytes)`` of one op."""
        packet = func._overloadpacket
        flops = 0.0
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
        if func.is_view or packet in _NO_TRAFFIC:
            return flops, 0.0
        return flops, float(sum(_nbytes(t)
                                for t in _tensors((args, kwargs, out))))

    def _track(self, key, t: torch.Tensor, held: bool = True):
        """Count ``t``'s storage live from its first sight as an output
        (``held``) until it is freed; mark a storage an op reads."""
        st = t.untyped_storage()
        if not held:
            st._dryrun_read = self.token
        if getattr(st, "_dryrun_seen", None) is self.token:
            return
        st._dryrun_seen = self.token
        if not held:
            return
        n = st.nbytes()
        with self.lock:
            dev = self._dev(key)
            dev.live += n
            dev.peak = max(dev.peak, dev.live)
            self.live += n
            self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n: int):
        with self.lock:
            self.devices[key].live -= n
            self.live -= n

    def _kernel(self, key, name: str, c: cost.Cost):
        dev = self._dev(key)
        dev.flops += c.n_ops
        dev.bytes_accessed += c.n_bytes
        k = self.kernels.setdefault(name, {"calls": 0, "bytes": 0.0,
                                           "ops": 0.0})
        k["calls"] += 1
        k["bytes"] += c.n_bytes
        k["ops"] += c.n_ops

    def _collective(self, key, kind: str, out: torch.Tensor):
        self._dev(key).collective[kind] += _nbytes(out)

    # -- reading ----------------------------------------------------------

    def busiest(self) -> Dict[str, Any]:
        """Each field the largest over the devices."""
        devs = list(self.devices.values()) or [_Device()]
        coll = {k: max(d.collective[k] for d in devs)
                for k in COLLECTIVE_KINDS}
        coll["total"] = max(sum(d.collective.values()) for d in devs)
        top = max(self.devices, key=lambda k: self.devices[k].flops,
                  default=self.device_key())
        return {"flops": max(d.flops for d in devs),
                "bytes_accessed": max(d.bytes_accessed for d in devs),
                "collective_bytes": coll,
                "temp_bytes": max(d.peak for d in devs),
                "busiest_device": list(top)}

    def whole(self) -> Dict[str, Any]:
        """The counts summed over every device: the thread mesh's work on
        one card."""
        devs = list(self.devices.values())
        coll = {k: sum(d.collective[k] for d in devs)
                for k in COLLECTIVE_KINDS}
        coll["total"] = sum(coll.values())
        return {"flops": sum(d.flops for d in devs),
                "bytes_accessed": sum(d.bytes_accessed for d in devs),
                "collective_bytes": coll, "temp_bytes": self.peak,
                "devices_counted": len(devs)}


# ---------------------------------------------------------------------------
# layouts: bytes of each leaf's shard
# ---------------------------------------------------------------------------


def _entry_size(entry, axis_sizes) -> int:
    if entry is None:
        return 1
    names = (entry,) if isinstance(entry, str) else entry
    return math.prod(axis_sizes[a] for a in names)


def shard_nbytes(shape, dtype, spec, axis_sizes) -> int:
    """Bytes of one device's shard of a ``shape`` leaf split by ``spec``
    (a dimension that does not divide is padded up, as XLA pads it)."""
    n = 1
    spec = tuple(spec or ())
    for dim, size in enumerate(shape):
        parts = _entry_size(spec[dim], axis_sizes) if dim < len(spec) else 1
        n *= -(-size // parts)
    return n * torch.empty((), dtype=dtype).element_size()


def tree_shard_bytes(tree, specs, axis_sizes, read_by=None) -> int:
    """Sum of :func:`shard_nbytes` over a tree's leaves and their specs
    (a :class:`~repro_torch.sharding.specs.NamedSharding` tree or a
    :class:`P` tree, or one spec for every leaf).

    ``read_by``: only the leaves that an op counted by that
    :class:`Counter` read.  XLA drops an argument that a step never reads
    (jit's ``keep_unused=False``), such as an encoder's weights in a decode
    step that takes the encoder's output."""
    leaves = tree_leaves(tree)
    if isinstance(specs, P) or specs is None:
        spec_leaves = [specs] * len(leaves)
    else:
        spec_leaves = [getattr(s, "spec", s) for s in tree_leaves(specs)]
    return sum(shard_nbytes(tuple(lf.shape), lf.dtype, s, axis_sizes)
               for lf, s in zip(leaves, spec_leaves)
               if read_by is None
               or getattr(lf.untyped_storage(), "_dryrun_read", None)
               is read_by.token)


def _data_entry(mesh):
    data_axes = tuple(a for a in mesh.axis_names if a != "model")
    return data_axes if len(data_axes) > 1 else data_axes[0]


#: a step index, a decode position: python ints in the port, the
#: reference's int32 scalar arguments
SCALAR_BYTES = 4
#: a PRNG key: int64-held uint32 words in the port, the reference's two
#: uint32 words
KEY_BYTES = 8
#: XLA's tuple of output buffers: a pointer for each output leaf
TUPLE_ENTRY_BYTES = 8


def _reads_position(arch: ArchConfig) -> bool:
    """Whether a decode step reads its position: a model with attention
    does (RoPE, the cache's slot); a purely recurrent one does not, and XLA
    drops an argument a step never reads (jit's ``keep_unused=False``)."""
    return (transformer.block_kind(arch) not in (transformer.MAMBA2,
                                                  transformer.RWKV6)
            or bool(arch.shared_attn_every))


def _outputs_bytes(outs, specs, sizes) -> int:
    """Bytes of the output leaves' shards and of XLA's tuple of them."""
    total = n = 0
    for tree, spec in zip(outs, specs):
        total += tree_shard_bytes(tree, spec, sizes)
        n += len(tree_leaves(tree))
    return total + TUPLE_ENTRY_BYTES * n


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainLayout:
    """A train step on ``meta`` and its inputs, laid out on its mesh."""
    step: Any
    params: Any
    opt_state: Any
    delta: Any
    batch: Dict[str, torch.Tensor]

    def argument_bytes(self, read_by=None) -> int:
        """Bytes of one device's shards of the step's arguments (``read_by``:
        of those a traced step read, :func:`tree_shard_bytes`)."""
        ts = self.step
        sizes = dict(zip(ts.mesh.axis_names, ts.mesh.shape))
        return (tree_shard_bytes(self.params, ts.param_sharding, sizes,
                                 read_by)
                + tree_shard_bytes(self.opt_state, ts.opt_sharding, sizes,
                                   read_by)
                + tree_shard_bytes(self.delta, ts.delta_sharding, sizes,
                                   read_by)
                + tree_shard_bytes(self.batch, ts.batch_spec, sizes, read_by)
                + SCALAR_BYTES + KEY_BYTES)


def train_layout(arch: ArchConfig, train_cfg: TrainConfig, ota, mesh,
                 ota_axes, batch: Dict[str, torch.Tensor]) -> TrainLayout:
    """The train step of ``arch`` on ``mesh`` (the sliced layout where
    ``ota.layout`` says so) on ``meta``, its abstract params, optimizer
    state and error accumulator."""
    make = (trainer_lib.make_train_step_sliced if ota.layout == "sliced"
            else trainer_lib.make_train_step)
    ts = make(arch, train_cfg, ota, mesh, ota_axes=ota_axes, donate=True,
              device=META)
    params = trainer_lib.abstract_params(arch)
    opt_state = make_optimizer(train_cfg).init(params)
    sdt = getattr(torch, ota.state_dtype)
    if ota.layout == "sliced":
        delta = {k: torch.empty(s, dtype=sdt, device=META)
                 for k, s in zip(("sh", "rep"), ts.delta_shape)}
    else:
        delta = torch.empty(ts.delta_shape, dtype=sdt, device=META)
    return TrainLayout(ts, params, opt_state, delta, batch)


def trace_train(lay: TrainLayout, counter: "Counter"):
    """One step of ``lay`` under ``counter``; ``(extra fields, output
    bytes)``."""
    ts = lay.step
    with counter:
        out = ts.jitted(lay.batch)(lay.params, lay.opt_state, lay.delta,
                                   lay.batch, 0, rng.PRNGKey(0, device=META))
    new_params, new_opt, new_delta, metrics = out
    sizes = dict(zip(ts.mesh.axis_names, ts.mesh.shape))
    out_bytes = _outputs_bytes(
        (new_params, new_opt, new_delta, metrics),
        (ts.param_sharding, ts.opt_sharding, ts.delta_sharding, P()), sizes)
    return {"d": ts.d, "d_pad": ts.d_pad, "m_devices": ts.m_devices,
            "delta_shape": ts.delta_shape}, out_bytes


def production_ota(arch_id: str, aggregator: str = "a_dsgd",
                   ota_kw: Optional[dict] = None):
    """The dry run's OTA settings: ``ota_overrides(arch)`` with the
    aggregator, the kernels (the path the card runs) and ``ota_kw``."""
    kw = dict(scheme=aggregator, use_kernel=True)
    if ota_kw:
        kw.update(ota_kw)
    return dataclasses.replace(ota_overrides(arch_id), **kw)


def production_train_cfg() -> TrainConfig:
    """The reference's train settings of a dry run."""
    return TrainConfig(compute_dtype="bfloat16", remat=True,
                       total_steps=1000)


def _train(arch, arch_id, shape, mesh, multi_pod, aggregator, ota_axes,
           ota_kw, counter):
    train_cfg = production_train_cfg()
    if ota_axes is None:
        ota_axes = ("pod", "data") if multi_pod else ("data",)
    lay = train_layout(arch, train_cfg,
                       production_ota(arch_id, aggregator, ota_kw), mesh,
                       ota_axes, input_specs(arch, shape, train_cfg))
    extra, out_bytes = trace_train(lay, counter)
    return extra, lay.argument_bytes(counter), out_bytes


def _prefill(arch, shape, mesh, counter):
    B, L = shape.global_batch, shape.seq_len
    ss = serve_lib.make_serve_step(arch, mesh, B, L, device=META)
    batch = input_specs(arch, shape)
    params = trainer_lib.abstract_params(arch)
    cache = ss.init_cache()
    sizes = dict(zip(mesh.axis_names, mesh.shape))

    # the forward over the L prompt tokens into a fresh cache
    with counter, torch.no_grad():
        enc_out = None
        if arch.encoder is not None:
            enc_out = transformer.encode_audio(
                params, arch, batch["frames"].to(torch.bfloat16))
        logits, new_cache, _ = transformer.forward(
            params, arch, batch["tokens"], positions=batch.get("positions"),
            extra_embeds=batch.get("extra"), enc_out=enc_out, cache=cache,
            cache_index=0, compute_dtype=torch.bfloat16, remat=False)
        logits = logits[:, -1:]
    arg_bytes = (
        tree_shard_bytes(params, ss.param_sharding, sizes, counter)
        + tree_shard_bytes(cache, ss.cache_sharding, sizes, counter)
        + tree_shard_bytes(batch, P(_data_entry(mesh)), sizes, counter))
    out_bytes = _outputs_bytes(
        (logits, new_cache),
        (_logits_spec(logits, mesh, sizes, vocab=False), ss.cache_sharding),
        sizes)
    return {}, arg_bytes, out_bytes


def _decode(arch, shape, mesh, counter):
    B, L = shape.global_batch, shape.seq_len
    window = decode_window_for(arch, shape)
    ss = serve_lib.make_serve_step(arch, mesh, B, L, decode_window=window,
                                   device=META)
    params = trainer_lib.abstract_params(arch)
    cache = ss.init_cache()
    tok = torch.empty((B, 1), dtype=torch.int32, device=META)
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    n_data = math.prod(n for a, n in sizes.items() if a != "model")
    tok_spec = P(_data_entry(mesh)) if B % n_data == 0 else P()
    args = [tok]
    if arch.encoder is not None:
        args.append(torch.empty((B, arch.encoder.n_frames,
                                 arch.encoder.d_model), dtype=torch.bfloat16,
                                device=META))
    # the last position of the cache: every slot full
    with counter:
        logits, new_cache = ss.decode_fn(params, cache, tok, L - 1,
                                         *args[1:])
    arg_bytes = (
        tree_shard_bytes(params, ss.param_sharding, sizes, counter)
        + tree_shard_bytes(cache, ss.cache_sharding, sizes, counter)
        + sum(tree_shard_bytes(a, tok_spec, sizes, counter) for a in args)
        + (SCALAR_BYTES if _reads_position(arch) else 0))
    out_bytes = _outputs_bytes(
        (logits, new_cache),
        (_logits_spec(logits, mesh, sizes, vocab=True), ss.cache_sharding),
        sizes)
    return {"decode_window": window}, arg_bytes, out_bytes


def _logits_spec(logits, mesh, sizes, vocab: bool) -> P:
    """The logits' layout, which the reference leaves to XLA: its compiled
    module splits the batch over the data axes where it divides, and a
    decode step's vocabulary over ``'model'`` too (prefill's last position
    is sliced from logits whose vocabulary XLA gathers)."""
    B, V = logits.shape[0], logits.shape[-1]
    n_data = math.prod(n for a, n in sizes.items() if a != "model")
    return P(_data_entry(mesh) if B % n_data == 0 else None, None,
             "model" if vocab and V % sizes.get("model", 1) == 0 else None)


def dryrun_one(arch_id: str, shape_id: str, multi_pod: bool,
               aggregator: str = "a_dsgd", ota_axes=None,
               variant: str = "baseline",
               ota_kw: Optional[dict] = None) -> Dict:
    arch = get_config(arch_id)
    shape = INPUT_SHAPES[shape_id]
    if (arch_id, shape_id) in SKIPS:
        return {"skipped": SKIPS[(arch_id, shape_id)]}
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    counter = Counter(mesh)
    t0 = time.time()
    if shape.kind == "train":
        extra, arg_bytes, out_bytes = _train(
            arch, arch_id, shape, mesh, multi_pod, aggregator, ota_axes,
            ota_kw, counter)
    elif shape.kind == "prefill":
        extra, arg_bytes, out_bytes = _prefill(arch, shape, mesh, counter)
    else:
        extra, arg_bytes, out_bytes = _decode(arch, shape, mesh, counter)
    info = counted_record(counter, arg_bytes, out_bytes, extra)
    info.update({
        "arch": arch_id, "shape": shape_id,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": mesh.size,
        "aggregator": aggregator if shape.kind == "train" else None,
        "variant": variant,
        "kind": shape.kind,
        "compile_seconds": round(time.time() - t0, 1),
        "model_params": approx_param_count(arch),
        "active_params": active_param_count(arch),
    })
    return info


def counted_record(counter: Counter, arg_bytes: int, out_bytes: int,
                   extra: Dict) -> Dict:
    """A record's counted fields from a traced step's counter; raises if
    the trace made a tensor off ``meta``."""
    if counter.off_meta:
        raise RuntimeError(f"the trace made tensors off meta: "
                           f"{counter.off_meta[:5]}")
    top = counter.busiest()
    return {
        "flops": top["flops"],
        "bytes_accessed": top["bytes_accessed"],
        "mem_per_device": {
            "argument_bytes": arg_bytes, "output_bytes": out_bytes,
            "temp_bytes": top["temp_bytes"], "generated_code_bytes": None},
        "collective_bytes": top["collective_bytes"],
        "busiest_device": top["busiest_device"],
        "thread_mesh": counter.whole(),
        "kernels": counter.kernels,
        "bytes_accessed_kind": "unfused upper bound: each op's inputs "
                               "read once and outputs written once",
        **{k: (list(v) if isinstance(v, tuple) else v)
           for k, v in extra.items()},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--aggregator", default="a_dsgd")
    ap.add_argument("--ota-axes", default=None,
                    help="comma list, e.g. 'pod' for the site_ota variant")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--ota", default=None,
                    help='JSON OTAConfig overrides, e.g. '
                         '\'{"layout":"sliced","use_kernel":false}\'')
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    outdir = args.out or os.path.abspath(RESULTS_DIR)
    os.makedirs(outdir, exist_ok=True)
    archs = list(ARCH_IDS) if (args.all or not args.arch) else [args.arch]
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    ota_axes = tuple(args.ota_axes.split(",")) if args.ota_axes else None

    n_ok = n_fail = 0
    for arch_id in archs:
        for shape_id in shapes:
            for mp in meshes:
                tag = f"{arch_id}__{shape_id}__{'mp' if mp else 'sp'}__" \
                      f"{args.aggregator}__{args.variant}"
                path = os.path.join(outdir, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip-existing] {tag}")
                    continue
                print(f"[dryrun] {tag} ...", flush=True)
                try:
                    info = dryrun_one(arch_id, shape_id, mp,
                                      aggregator=args.aggregator,
                                      ota_axes=ota_axes,
                                      variant=args.variant,
                                      ota_kw=json.loads(args.ota)
                                      if args.ota else None)
                    with open(path, "w") as f:
                        json.dump(info, f, indent=1)
                    if "skipped" in info:
                        print(f"  -> SKIP ({info['skipped']})")
                    else:
                        print(f"  -> ok flops={info['flops']:.3e} "
                              f"coll={info['collective_bytes']['total']:.3e}B "
                              f"({info['compile_seconds']}s)")
                    n_ok += 1
                except Exception as e:   # noqa: BLE001
                    n_fail += 1
                    print(f"  -> FAIL {type(e).__name__}: {e}")
                    traceback.print_exc()
                    with open(path + ".fail", "w") as f:
                        f.write(traceback.format_exc())
    print(f"done: {n_ok} ok, {n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
