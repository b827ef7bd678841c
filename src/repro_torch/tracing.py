"""The port's own spans and counters, kept in memory.

A **span** is a named stretch of the program: ``with tracing.span("grads"):``.
It records its name, its parent (the innermost span open in the same
thread when it opened), the round index ``t`` (given to the ``round`` span,
inherited below it) and the chunk index the stream last set with
:func:`at_chunk`.  It keeps its host start and end in Unix-epoch
nanoseconds (``time.time_ns()``), the clock torch's profiler writes its
Chrome export on (``ts`` + ``baseTimeNanoseconds / 1000``, in µs).  Inside
a ``round`` span on a CUDA process it also records a CUDA event at each
edge on the current stream; the events are timed only when
:func:`last_round` is read, so nothing inside the round waits on the
device.  While torch's profiler records, each span is also a
``record_function`` range named ``repro_torch.<name>``, on the device
trace's clock beside every kernel.

A **counter** adds an integer: :func:`count` adds it to the process's
totals (:func:`totals`, :func:`reset`) and charges it to the innermost span
open in the calling thread.  The kernels' launches are counters
(``launches.<kernel>``, read by ``kernels.ops.launch_counts``) and count
whether tracing is on or not.  While a ``round`` span is open on a CUDA
process, the tracer sets torch's sync debug mode to ``warn`` and counts
every warning it gives as ``host_syncs`` (each time the host waited on the
device); the previous mode, filters and ``warnings.showwarning`` come back
when the last open round closes.  The ``round`` span reads
``torch.cuda.memory_stats()`` at its edges and charges the deltas of
``num_device_alloc`` and ``num_alloc_retries`` as ``device_mallocs`` and
``alloc_retries``.

**Arming.**  :func:`enable` and :func:`disable` are the one switch.  Off,
a span entry reads one module-level flag and makes no torch call, so the
spans cost nothing under a dry run's dispatch mode or inside
``torch.func``, and a profile taken while the tracer is off holds no
``repro_torch.`` range.  Spans nest per thread: rank threads running the
same encode code each keep their own stack.

**What is kept**: the last completed ``round`` span's tree, which
:func:`last_round` returns as plain data, and the counters' totals.  Spans
opened outside a ``round`` record no device time and are dropped when the
outermost of them closes.
"""
from __future__ import annotations

import threading
import time
import warnings
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

#: the prefix of the spans' ``record_function`` ranges
PREFIX = "repro_torch."
#: the text of the warning torch's sync debug mode gives at each wait
SYNC_WARNING = "called a synchronizing CUDA operation"
#: ``torch.cuda.memory_stats()`` keys read at the ``round`` span's edges
MEMORY_COUNTERS = {"device_mallocs": "num_device_alloc",
                   "alloc_retries": "num_alloc_retries"}

_on = False
_local = threading.local()
_lock = threading.RLock()
_totals: Dict[str, int] = {}
_last: Optional["_Record"] = None
#: free CUDA events by device index
_pool: Dict[int, List[torch.cuda.Event]] = {}
#: the sync watch: open rounds, and what it replaced
_watch = {"depth": 0, "mode": 0, "warnings": None, "show": None}


def enable() -> None:
    """Arm the tracer."""
    global _on
    _on = True


def disable() -> None:
    """Disarm the tracer."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


class _Off:
    """The span of a disarmed tracer."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, t: Optional[int] = None):
    """A context manager over one span; ``t`` is the round index (a child
    takes its parent's)."""
    if not _on:
        return _OFF
    return _Span(name, t)


def at_chunk(i: Optional[int]) -> None:
    """The chunk index the spans opened next in this thread record."""
    _local.chunk = i


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``: to the totals, and to the innermost
    span open in this thread."""
    with _lock:
        _totals[name] = _totals.get(name, 0) + n
    stack = getattr(_local, "stack", None)
    if stack:
        c = stack[-1].counters
        c[name] = c.get(name, 0) + n


def totals() -> Dict[str, int]:
    """The counters' totals since their last :func:`reset`."""
    with _lock:
        return dict(_totals)


def reset(*names: str) -> None:
    """Set the named counters' totals back to 0."""
    with _lock:
        for name in names:
            _totals.pop(name, None)


def last_round() -> Optional[dict]:
    """The last completed ``round`` span's tree, or None.

    ``{"t", "spans", "counters"}``: ``spans`` in the order they opened,
    each ``{"name", "parent"`` (index into ``spans``, None for the round),
    ``"t", "chunk", "start_ns", "end_ns", "host_ms", "device_ms"`` (None
    without CUDA), ``"counters"}``; ``counters`` the round's totals over
    its spans.  Reading it waits for the round's last CUDA event.
    """
    with _lock:
        return None if _last is None else _last.resolve()


def clear() -> None:
    """Drop the kept round."""
    global _last
    with _lock:
        if _last is not None:
            _last.release()
        _last = None


# ----------------------------------------------------------------- spans
def _event() -> torch.cuda.Event:
    free = _pool.setdefault(torch.cuda.current_device(), [])
    try:
        ev = free.pop()
    except IndexError:
        ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _memory() -> Dict[str, int]:
    stats = torch.cuda.memory_stats()
    return {k: stats[v] for k, v in MEMORY_COUNTERS.items() if v in stats}


class _Span:
    __slots__ = ("name", "t", "chunk", "parent", "spans", "counters",
                 "start_ns", "end_ns", "events", "device", "rf", "memory")

    def __init__(self, name: str, t: Optional[int]):
        self.name = name
        self.t = t

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if stack:
            self.parent = stack[-1]
            self.spans = self.parent.spans
            if self.t is None:
                self.t = self.parent.t
            in_round = self.spans is not None
        else:
            self.parent = None
            in_round = self.name == "round"
            # a tree outside a round is dropped: it keeps no list
            self.spans = [] if in_round else None
        cuda = in_round and torch.cuda.is_initialized()
        root = in_round and not stack
        if cuda and root:
            _watch_syncs()
        self.chunk = getattr(_local, "chunk", None)
        self.counters = {"host_syncs": 0} if cuda and root else {}
        if in_round:
            self.spans.append(self)
        stack.append(self)
        self.memory = _memory() if cuda and root else None
        self.start_ns = time.time_ns()
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = _profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        self.device = torch.cuda.current_device() if cuda else None
        self.events = (_event(),) if cuda else ()
        return self

    def __exit__(self, *exc):
        if self.events:
            self.events += (_event(),)
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        self.end_ns = time.time_ns()
        if self.memory is not None:
            now = _memory()
            for k, v in self.memory.items():
                self.counters[k] = self.counters.get(k, 0) + now[k] - v
        stack = _local.stack
        stack.pop()
        if not stack and self.spans is not None:
            if self.events:
                _unwatch_syncs()
            _keep(self)
        return False


def _keep(root: _Span) -> None:
    global _last
    with _lock:
        if _last is not None:
            _last.release()
        _last = _Record(root.spans)


class _Record:
    """A closed round's span tree; its CUDA events are timed at the first
    read."""

    def __init__(self, spans: List[_Span]):
        self.spans = spans
        self.data: Optional[dict] = None

    def release(self) -> None:
        for s in self.spans:
            if len(s.events) == 2:
                _pool.setdefault(s.device, []).extend(s.events)
            s.events = ()
            s.parent = s.spans = None
        self.spans = []

    def resolve(self) -> dict:
        if self.data is not None:
            return self.data
        index = {id(s): i for i, s in enumerate(self.spans)}
        out, total = [], {}
        for s in self.spans:
            device_ms = None
            if len(s.events) == 2:
                s.events[1].synchronize()
                device_ms = s.events[0].elapsed_time(s.events[1])
            out.append({"name": s.name,
                        "parent": (None if s.parent is None
                                   else index[id(s.parent)]),
                        "t": s.t, "chunk": s.chunk,
                        "start_ns": s.start_ns, "end_ns": s.end_ns,
                        "host_ms": (s.end_ns - s.start_ns) * 1e-6,
                        "device_ms": device_ms,
                        "counters": dict(s.counters)})
            for k, v in s.counters.items():
                total[k] = total.get(k, 0) + v
        self.data = {"t": out[0]["t"], "spans": out, "counters": total}
        self.release()
        return self.data


# ------------------------------------------------------------ host syncs
def _show(message, category, filename, lineno, file=None, line=None):
    if SYNC_WARNING in str(message):
        count("host_syncs")
        return
    _watch["show"](message, category, filename, lineno, file, line)


def _watch_syncs() -> None:
    """Count torch's waits on the device from the first open round to the
    last one's close."""
    with _lock:
        _watch["depth"] += 1
        if _watch["depth"] > 1:
            return
        _watch["mode"] = torch.cuda.get_sync_debug_mode()
        cw = warnings.catch_warnings()
        cw.__enter__()
        _watch["warnings"] = cw
        warnings.filterwarnings("always", message=SYNC_WARNING)
        _watch["show"] = warnings.showwarning
        warnings.showwarning = _show
        torch.cuda.set_sync_debug_mode("warn")


def _unwatch_syncs() -> None:
    with _lock:
        _watch["depth"] -= 1
        if _watch["depth"] > 0:
            return
        torch.cuda.set_sync_debug_mode(_watch["mode"])
        _watch["warnings"].__exit__(None, None, None)
        _watch["warnings"] = _watch["show"] = None
