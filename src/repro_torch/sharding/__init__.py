"""Named meshes of ranks and their collectives.

The port's counterpart of ``repro.sharding.shard_map`` and of the
``jax.lax`` collectives the slice drivers call (``psum``, ``all_gather``,
``axis_index``, ``axis_size``).  A :class:`Mesh` names the axes of a grid
of ranks; :func:`shard_map` runs a body once per rank on that rank's
slices of its inputs and assembles the outputs, and inside the body the
collectives read the calling rank's place in the mesh.

Every ``psum`` gathers the contributions of its group and adds them in
rank order, as jax's ``psum`` on the CPU does (a float32 sum left to
right in device order; a bfloat16 one accumulated in float32 in that order
and rounded once; a grouped one in member order).  The result therefore
never depends on which rank ran first or on how the contributions
travelled.  A ring all-reduce (gloo's, NCCL's) changes the order by chunk
and is not used.

Two transports carry one body and give it the same bits:

* **threads** (the default): one process, one thread per rank, one rank
  running at a time between collectives.  Each collective puts every
  rank's contribution into that rank's slot behind a barrier, and the
  group's first member reduces only when every slot is full; a second
  barrier hands the result back.  A rank that raises aborts the barrier,
  so every other rank raises too, and the barrier has a timeout, so a rank
  that never arrives cannot hang the others.
* **a torch.distributed process group** (:func:`init_process_mesh`): one
  process per rank, the mesh a ``DeviceMesh`` over a gloo group, each
  collective an ``all_gather_into_tensor`` over the axis's group followed
  by the same rank-order sum.
"""
from __future__ import annotations

import contextlib
import math
import threading
import time
import warnings
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, Sequence, Tuple, Union

import torch

Axes = Union[str, Sequence[str]]

#: seconds a rank waits at a barrier for the others before the collective
#: fails (the first use of a kernel builds it while the other ranks wait)
DEFAULT_TIMEOUT = 600.0


class P(tuple):
    """A partition spec: for each dimension of a tensor, ``None`` (not
    split), a mesh axis name, or a tuple of names (split over those axes,
    the first major).  ``P()`` is a replicated tensor."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)


@dataclass(frozen=True)
class Mesh:
    """A grid of ranks with named axes; rank ``r`` sits at the row-major
    coordinates of ``r`` in ``shape``.  ``device_mesh`` is set on a
    process-group mesh (:func:`init_process_mesh`) and holds this
    process's rank; a mesh without one runs its ranks as threads."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device_mesh: Any = None

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(n) for n in self.shape))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axis names "
                             f"{self.axis_names} differ in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis in {self.axis_names}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, axis: str) -> int:
        return self.shape[self._dim(axis)]

    def coords(self, rank: int) -> Tuple[int, ...]:
        out = []
        for n in reversed(self.shape):
            out.append(rank % n)
            rank //= n
        return tuple(reversed(out))

    def rank(self, coords: Sequence[int]) -> int:
        r = 0
        for c, n in zip(coords, self.shape):
            r = r * n + c
        return r

    def _dim(self, axis: str) -> int:
        try:
            return self.axis_names.index(axis)
        except ValueError:
            raise ValueError(f"no mesh axis {axis!r} in "
                             f"{self.axis_names}") from None

    def _index(self, coords, axes: Tuple[str, ...]) -> Tuple[int, int]:
        """(row-major index of ``coords`` over ``axes``, their size)."""
        idx, n = 0, 1
        for ax in axes:
            d = self._dim(ax)
            idx, n = idx * self.shape[d] + coords[d], n * self.shape[d]
        return idx, n

    def _members(self, rank: int, axes: Tuple[str, ...]) -> list:
        """The ranks that share ``rank``'s coordinates off ``axes``,
        row-major over ``axes``."""
        coords = list(self.coords(rank))
        dims = [self._dim(ax) for ax in axes]
        out = []
        for flat in range(math.prod(self.shape[d] for d in dims)):
            for d in reversed(dims):
                coords[d] = flat % self.shape[d]
                flat //= self.shape[d]
            out.append(self.rank(coords))
        return out


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


# ---------------------------------------------------------------------------
# the calling rank
# ---------------------------------------------------------------------------


_local = threading.local()


@dataclass(frozen=True)
class _Rank:
    mesh: Mesh
    rank: int
    coords: Tuple[int, ...]
    comm: Any


def _me() -> _Rank:
    me = getattr(_local, "rank", None)
    if me is None:
        raise RuntimeError("a collective was called outside shard_map")
    return me


@contextlib.contextmanager
def rank_context(factory: Callable[[Mesh, int], Any]):
    """Run each rank thread that :func:`shard_map` starts from the calling
    thread inside the context manager ``factory(mesh, rank)``, as a
    counter of the ranks' work needs (a dispatch mode is the state of its
    own thread and a rank thread starts without one)."""
    prev = getattr(_local, "rank_context", None)
    _local.rank_context = factory
    try:
        yield
    finally:
        _local.rank_context = prev


@contextlib.contextmanager
def observe_collectives(fn: Callable[[str, torch.Tensor], Any]):
    """Call ``fn(kind, out)`` after each collective that the calling thread
    makes, with the kind's name in XLA's HLO (``"all-reduce"`` for each
    axis a :func:`psum` sums over, ``"all-gather"``) and the rank's
    output."""
    prev = getattr(_local, "observer", None)
    _local.observer = fn
    try:
        yield
    finally:
        _local.observer = prev


def _observe(kind: str, out: torch.Tensor) -> torch.Tensor:
    fn = getattr(_local, "observer", None)
    if fn is not None:
        fn(kind, out)
    return out


def axis_index(axis: str) -> int:
    """The calling rank's coordinate along a mesh axis."""
    me = _me()
    return me.coords[me.mesh._dim(axis)]


def axis_size(axis: str) -> int:
    """The size of a mesh axis of the calling rank's mesh."""
    return _me().mesh.axis_size(axis)


def _rank_order_sum(parts) -> torch.Tensor:
    """Left to right in float32; a bfloat16 sum accumulates in float32 and
    rounds once, as jax's ``psum`` on the CPU does."""
    acc = parts[0].float()
    for p in parts[1:]:
        acc = acc + p.float()
    return acc.to(parts[0].dtype)


def _stack(parts) -> torch.Tensor:
    return torch.stack(parts)


def psum(x: torch.Tensor, axis: Axes, groups=None) -> torch.Tensor:
    """Sum ``x`` over the ranks along ``axis`` (a name, or a tuple of names
    summed one after the other in tuple order), in rank order.

    ``groups`` (jax's ``axis_index_groups``): a partition of the axis's
    indices; each rank then sums its own group, in member order."""
    me = _me()
    axes = _axes(axis)
    if groups is not None and len(axes) != 1:
        raise ValueError("psum: groups need a single axis")
    for ax in axes:
        select = None
        if groups is not None:
            idx = me.coords[me.mesh._dim(ax)]
            select = next((list(g) for g in groups if idx in g), None)
            if select is None:
                raise ValueError(f"psum: axis index {idx} of {ax!r} is in "
                                 f"none of the groups {groups}")
        x = _observe("all-reduce", me.comm.collective(
            me, x, (ax,), select, _rank_order_sum))
    return x


def all_gather(x: torch.Tensor, axes: Axes, tiled: bool = False):
    """The ranks' ``x`` along ``axes``, stacked on a new leading dimension
    (``tiled``: concatenated along dimension 0), row-major over ``axes``."""
    me = _me()
    out = _observe("all-gather",
                   me.comm.collective(me, x, _axes(axes), None, _stack))
    return out.reshape(-1, *x.shape[1:]) if tiled else out


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------


class _Threads:
    """The thread transport: slots behind a barrier.

    A collective posts each rank's tensor into its slot; after the first
    barrier every slot is full, and the first member of each group reduces
    its members' slots into its result; after the second barrier every
    member reads that result.  The next collective overwrites a slot or a
    result only after its own first barrier, which no rank reaches before
    it has read the last result.  Every rank calls the same collectives in
    the same order (the body is SPMD), so the barriers pair up."""

    def __init__(self, mesh: Mesh, timeout: float):
        self.mesh = mesh
        self.barrier = threading.Barrier(mesh.size, timeout=timeout)
        self.slots = [None] * mesh.size
        self.results = [None] * mesh.size
        # one rank runs at a time: torch releases the interpreter lock in
        # every op, and ranks that all run would hand it over op by op (on
        # the card, 50 rank threads ran ~6x slower per rank than one); a
        # rank gives the baton up only while it waits at a barrier
        self.baton = threading.Lock()

    def wait(self):
        self.baton.release()
        try:
            self.barrier.wait()
        finally:
            self.baton.acquire()

    def collective(self, me: _Rank, x, axes, select, fn):
        members = self.mesh._members(me.rank, axes)
        if select is not None:
            members = [members[i] for i in select]
        self.slots[me.rank] = x
        self.wait()
        leader = members[0]
        if me.rank == leader:
            self.results[leader] = fn([self.slots[r] for r in members])
        self.wait()
        return self.results[leader]


class _Processes:
    """The process-group transport: one rank per process.

    gloo's ``all_gather_into_tensor`` takes host tensors only, so each
    contribution crosses the host for the collective and the gathered
    tensors go back to the contribution's device, where the reduction
    runs; the rest of the body stays on its device."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def collective(self, me: _Rank, x, axes, select, fn):
        parts = x[None]
        for ax in reversed(axes):                 # the minor axis first
            parts = _gather_host(parts, self.mesh.device_mesh.get_group(ax),
                                 self.mesh.axis_size(ax))
        members = list(parts.reshape(-1, *x.shape).unbind(0))
        if select is not None:
            members = [members[i] for i in select]
        return fn(members)


def _gather_host(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """``(n, *x.shape)``: the group's ``x`` by group rank, back on ``x``'s
    device.  gloo gathers host tensors only, so the tensor crosses the host
    for the collective; a bfloat16 tensor travels as float32, which holds
    its values exactly."""
    import torch.distributed as dist
    wire = x.detach().reshape(1, *x.shape).to("cpu")
    if wire.dtype == torch.bfloat16:
        wire = wire.float()
    out = torch.empty((n, *x.shape), dtype=wire.dtype)
    with warnings.catch_warnings():
        # newer torch renames the call; the old name stays for older ones
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, wire, group=group)
    return out.to(device=x.device, dtype=x.dtype)


def init_process_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
                      rank: int, world_size: int, init_method: str,
                      timeout: float = DEFAULT_TIMEOUT) -> Mesh:
    """Join a gloo process group and lay its ranks out as a named mesh.

    ``init_method`` is ``tcp://host:port`` or ``file://path``; the world's
    ranks sit row-major in ``shape``.  The gloo backend serves any device:
    the collectives stage through the host (:class:`_Processes`).  Close
    with :func:`close_process_mesh`."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if math.prod(shape) != world_size:
        raise ValueError(f"mesh {tuple(shape)} does not hold {world_size} "
                         "ranks")
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(seconds=timeout))
    dm = init_device_mesh("cpu", tuple(shape),
                          mesh_dim_names=tuple(axis_names))
    return Mesh(tuple(shape), tuple(axis_names), device_mesh=dm)


def close_process_mesh() -> None:
    import torch.distributed as dist
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------


def _piece(mesh: Mesh, spec, coords) -> list:
    """Per dimension of a tensor split by ``spec``: ``None``, or one rank's
    ``(block index, number of blocks)``."""
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
        else:
            out.append(mesh._index(coords, _axes(entry)))
    return out


def _local_slice(mesh: Mesh, x, spec, coords):
    if spec is None:
        return x
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{x.dim()} dimensions")
    for dim, part in enumerate(_piece(mesh, spec, coords)):
        if part is None:
            continue
        idx, n = part
        size = x.shape[dim]
        if size % n:
            raise ValueError(f"dimension {dim} of size {size} does not "
                             f"split over {n} ranks ({spec})")
        x = x.narrow(dim, idx * size // n, size // n)
    return x


def _assemble(mesh: Mesh, outs: list, spec) -> torch.Tensor:
    """One output from every rank's block: split dimensions concatenated,
    and over the axes ``spec`` does not name, the copy at coordinate 0."""
    named = {ax for entry in spec if entry is not None for ax in _axes(entry)}
    first = outs[0]
    shape = list(first.shape)
    parts = _piece(mesh, spec, mesh.coords(0))
    for dim, part in enumerate(parts):
        if part is not None:
            shape[dim] *= part[1]
    full = first.new_empty(shape)
    for rank, out in enumerate(outs):
        coords = mesh.coords(rank)
        if any(coords[d] for d, ax in enumerate(mesh.axis_names)
               if ax not in named):
            continue
        view = full
        for dim, part in enumerate(_piece(mesh, spec, coords)):
            if part is not None:
                n = out.shape[dim]
                view = view.narrow(dim, part[0] * n, n)
        view.copy_(out)
    return full


def _as_tuple(v):
    return v if isinstance(v, (tuple, list)) and not isinstance(v, P) else (v,)


def shard_map(body: Callable, mesh: Mesh, in_specs, out_specs,
              timeout: float = DEFAULT_TIMEOUT) -> Callable:
    """``body`` once per rank of ``mesh`` on that rank's slices.

    ``in_specs`` holds one :class:`P` per argument (``None`` passes the
    argument to every rank as it is); ``out_specs`` one :class:`P` per
    output (a single P for a body that returns one tensor).  A dimension
    split over mesh axes is concatenated from the ranks' blocks; over the
    axes a spec does not name, the output is rank coordinate 0's copy, as
    jax's ``shard_map`` with ``check_vma=False`` takes it.

    On a thread mesh the ranks run as threads of this process and the call
    re-raises the first error any rank raised; on a process-group mesh
    this process runs its own rank, and every process gets the assembled
    outputs."""
    in_specs = _as_tuple(in_specs)
    single = isinstance(out_specs, P)
    o_specs = _as_tuple(out_specs)

    def run(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"shard_map: {len(args)} arguments for "
                            f"{len(in_specs)} in_specs")
        if mesh.device_mesh is not None:
            outs = _run_process(body, mesh, args, in_specs)
        else:
            outs = _run_threads(body, mesh, args, in_specs, timeout)
        outs = [_as_tuple(o) for o in outs]
        for o in outs:
            if len(o) != len(o_specs):
                raise ValueError(f"shard_map: the body returned {len(o)} "
                                 f"outputs for {len(o_specs)} out_specs")
        full = tuple(_assemble(mesh, [o[i] for o in outs], spec)
                     for i, spec in enumerate(o_specs))
        return full[0] if single else full

    return run


def _rank_args(mesh, args, in_specs, coords):
    return [_local_slice(mesh, a, s, coords) for a, s in zip(args, in_specs)]


def _run_threads(body, mesh: Mesh, args, in_specs, timeout: float) -> list:
    comm = _Threads(mesh, timeout)
    outs = [None] * mesh.size
    errors = []
    lock = threading.Lock()
    context = getattr(_local, "rank_context", None)

    def work(rank: int):
        coords = mesh.coords(rank)
        _local.rank = _Rank(mesh, rank, coords, comm)
        _local.rank_context = context
        comm.baton.acquire()
        try:
            with (context(mesh, rank) if context is not None
                  else contextlib.nullcontext()):
                outs[rank] = body(*_rank_args(mesh, args, in_specs, coords))
        except BaseException as exc:          # noqa: BLE001 -- re-raised below
            with lock:
                errors.append((rank, exc))
            comm.barrier.abort()
        finally:
            comm.baton.release()
            _local.rank = None

    threads = [threading.Thread(target=work, args=(r,), daemon=True,
                                name=f"shard_map-rank-{r}")
               for r in range(mesh.size)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout + 60.0
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    hung = [t.name for t in threads if t.is_alive()]
    if hung:
        comm.barrier.abort()
        raise RuntimeError(f"shard_map: ranks still running "
                           f"{timeout + 60.0} s after the start: {hung}")
    if errors:
        # the first rank that failed on its own; the others saw the
        # barrier break under them
        first = next((e for e in errors
                      if not isinstance(e[1], threading.BrokenBarrierError)),
                     errors[0])
        rank, exc = first
        raise RuntimeError(f"shard_map: rank {rank} {mesh.coords(rank)} "
                           f"failed: {exc!r}") from exc
    return outs


def _run_process(body, mesh: Mesh, args, in_specs) -> list:
    import torch.distributed as dist
    rank = dist.get_rank()
    coords = mesh.coords(rank)
    comm = _Processes(mesh)
    _local.rank = _Rank(mesh, rank, coords, comm)
    try:
        out = _as_tuple(body(*_rank_args(mesh, args, in_specs, coords)))
        # every rank's outputs, gathered over the whole world in rank order
        gathered = [_gather_host(t, None, mesh.size).unbind(0) for t in out]
    finally:
        _local.rank = None
    return [tuple(g[r] for g in gathered) for r in range(mesh.size)]
