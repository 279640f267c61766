"""The port's spans and counters: one record per assembly.

Each ``assemble_codes`` call (and each single-device assembly of the command
line) opens an ``assembly``: a ``Trace`` whose root span is ``assembly``.
Inside it the pipeline opens spans at its stage boundaries (fixed names, in
``STAGES``), and the kernels' wrappers count their launches (``COUNTERS``).

- A span records its name, its id, its parent's id, the assembly's id, the
  native id of the thread that ran it, and its [start, end] in Unix ns (the
  host clock of ``torch.profiler``'s events; a monotonic clock anchored to
  it once per trace), with attributes (a batch or group number, bytes), and
  where asked the process CPU time at both ends (``time.process_time_ns``:
  every thread of the process, the native packer's included).
- The spans of a thread nest. A thread that is not the assembly's (the
  feed's worker) is handed the ``Trace`` by its caller and records into it;
  its outermost spans are children of the root.
- ``stage_seconds`` (the reference's stage timers) is a sum of spans: stage
  ``s`` is the sum of the spans named in ``STAGES[s]``, each less the
  staged spans nested inside it (the sharded mode's count step takes its
  batches, and so holds their ``feed: wait``). The single-device routes
  nest no staged span in another.
- A counter is added to the process totals (``totals``) and, inside an
  assembly, to the assembly's own.
- While a ``torch.profiler`` records, each span also enters a
  ``torch._C._profiler._RecordFunctionFast`` of its name: a host op of the
  profiler's trace (``cpu_op``), which has no mark on the device's
  timeline. A worker thread's spans do not reach the profiler; they are in
  the trace (``Trace.to_json``).
- A finished assembly's rollup (seconds, process-CPU seconds and calls per
  span name, and its counters) goes to a bounded ``history``.

Outside an assembly, spans go nowhere but into the stage times that a
caller asks for (``stage_times``), and counters go to the process totals
only. The tracer holds no tensor, CUDA event or stream, and never syncs the
device.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import threading
import time

import torch

try:
    from torch._C._profiler import _RecordFunctionFast
except ImportError:  # this torch has none: spans are not mirrored
    _RecordFunctionFast = None

#: stage -> the spans whose seconds sum to it, in ``stage_seconds``' order
STAGES = {
    "encode": ("feed: setup", "feed: wait", "encode: reads"),
    "count": ("count: extract launch", "count: merge", "count: step"),
    "count_drain": ("count: sort", "count: drain", "count: finalize"),
    "gather": ("gather: spectrum",),
    "tips": ("clean",),
    "graph": (
        "graph: cutoff", "graph: build", "graph: transition keys", "graph: walk", "graph: sync",
        "graph: sharded traversal",
    ),
    "extract": ("emit: device", "emit: copy", "emit: host", "emit: fragments"),
}
STAGE_OF = {span: stage for stage, spans in STAGES.items() for span in spans}
ROOT = "assembly"

COUNTERS = (
    "batches",  # batches the feed prepared
    "h2d_bytes",  # bytes the feed copied to the device
    "d2h_bytes",  # bytes the emission copied to the host
    "extract_launches",  # the extract kernel's packed loader (the single-device routes)
    "extract_int8_launches",  # its int8 loader (the sharded mode)
    "walk_launches",
    "cut_table_launches",  # the cut-table kernel (one call a cycle walk's cut rank)
    "cut_table_rows",  # the edges those calls passed over
    "jump_launches",  # the pointer-jump kernels (one a doubling)
    "jump_rounds",  # the doubling rounds those launches ran
    "label_launches",  # the doubling label kernel
    "label_rounds",
    "ruling_label_calls",  # ruling_labels on the card: two launches each
    "emit_reruns",  # device emissions that overflowed and ran again with exact capacities
    "emit_canonical_launches",  # the canonical emission kernel (three launches a call)
    "emit_mirrored_prefixes",  # contigs whose first 64 positions mirror themselves: its second pass
    "key_sorts",  # keys.sort calls on multi-word keys
    "key_sort_passes",  # the stable passes those calls made (one a word)
    "key_sort_rows",  # rows times passes: the rows those passes sorted
)
HISTORY = 4096  # finished assemblies kept in ``history``

_lock = threading.Lock()
_totals = dict.fromkeys(COUNTERS, 0)
_history: collections.deque = collections.deque(maxlen=HISTORY)
_assembly_ids = itertools.count(1)
_profiling = torch._C._autograd._profiler_enabled


class _Span:
    __slots__ = ("_trace", "_name", "_cpu", "_attrs", "_id", "_parent", "_stack", "_tid", "_t0", "_c0", "_mirror")

    def __init__(self, trace: Trace, name: str, cpu: bool, attrs: dict):
        self._trace, self._name, self._cpu, self._attrs = trace, name, cpu, attrs

    def __enter__(self):
        tr = self._trace
        entry = tr._stacks.get(threading.get_ident())
        if entry is None:
            entry = tr._stacks[threading.get_ident()] = (threading.get_native_id(), [])
        self._tid, stack = entry
        self._parent = stack[-1] if stack else tr.root
        self._id = next(tr._ids)
        stack.append(self._id)
        self._stack = stack
        self._mirror = None
        if _RecordFunctionFast is not None and _profiling():
            self._mirror = _RecordFunctionFast(self._name)
            self._mirror.__enter__()
        self._c0 = time.process_time_ns() if self._cpu else None
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        c1 = time.process_time_ns() if self._cpu else None
        if self._mirror is not None:
            self._mirror.__exit__(None, None, None)
        self._stack.pop()
        self._trace.spans.append(
            (self._id, self._parent, self._name, self._tid, self._t0, t1, self._c0, c1, self._attrs)
        )
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


class _Off:
    """The trace outside an assembly: spans go nowhere, counters to the
    process totals."""

    def span(self, name: str, cpu: bool = False, **attrs) -> _NoSpan:
        return _NO_SPAN

    def add(self, name: str, n: int = 1) -> None:
        with _lock:
            _totals[name] += n


OFF = _Off()


class Trace:
    """One assembly's spans (``spans``: tuples of id, parent, name, thread,
    start and end ns on ``time.perf_counter_ns``, process CPU ns at both
    ends or None, attributes) and counters."""

    def __init__(self, assembly: int | None = None):
        self.assembly = assembly
        self.anchor = time.time_ns() - time.perf_counter_ns()  # perf_counter ns -> Unix ns
        self.root: int | None = None
        self.spans: list[tuple] = []
        self.counters = dict.fromkeys(COUNTERS, 0)
        self._ids = itertools.count(1)
        self._stacks: dict[int, tuple[int, list[int]]] = {}  # thread ident -> (native id, open span ids)

    def span(self, name: str, cpu: bool = False, **attrs) -> _Span:
        """A span of this trace on the calling thread; ``cpu`` also records
        the process CPU time at both ends."""
        return _Span(self, name, cpu, attrs)

    def add(self, name: str, n: int = 1) -> None:
        with _lock:
            _totals[name] += n
            self.counters[name] += n

    def stage_seconds(self, start: int = 0) -> dict[str, float]:
        """The stages of the spans from ``spans[start]`` on, in ``STAGES``
        order: each stage that has a span, its spans' seconds summed, each
        span's less those of the staged spans whose nearest staged ancestor
        it is."""
        spans = self.spans[start:]
        parent = {rec[0]: rec[1] for rec in spans}
        stage_of = {rec[0]: STAGE_OF[rec[2]] for rec in spans if rec[2] in STAGE_OF}
        ns: dict[str, int] = {}
        for sid, up, _, _, t0, t1, *_ in spans:
            stage = stage_of.get(sid)
            if stage is None:
                continue
            ns[stage] = ns.get(stage, 0) + t1 - t0
            while up in parent and up not in stage_of:
                up = parent[up]
            if up in stage_of:
                ns[stage_of[up]] = ns.get(stage_of[up], 0) - (t1 - t0)
        return {stage: ns[stage] / 1e9 for stage in STAGES if stage in ns}

    def rollup(self) -> dict:
        """Per span name: seconds, process-CPU seconds (where recorded) and
        calls; and the counters."""
        ns: dict[str, int] = {}
        cpu: dict[str, int] = {}
        calls: dict[str, int] = {}
        for _, _, name, _, t0, t1, c0, c1, _ in self.spans:
            ns[name] = ns.get(name, 0) + t1 - t0
            calls[name] = calls.get(name, 0) + 1
            if c0 is not None:
                cpu[name] = cpu.get(name, 0) + c1 - c0
        return {
            "assembly": self.assembly,
            "seconds": {name: v / 1e9 for name, v in ns.items()},
            "cpu_seconds": {name: v / 1e9 for name, v in cpu.items()},
            "calls": calls,
            "counters": dict(self.counters),
        }

    def records(self) -> list[dict]:
        """The spans in the order they ended, stamps in Unix ns."""
        out = []
        for sid, parent, name, tid, t0, t1, c0, c1, attrs in self.spans:
            rec = {"id": sid, "parent": parent, "assembly": self.assembly, "name": name, "thread": tid,
                   "start_ns": t0 + self.anchor, "end_ns": t1 + self.anchor, "attrs": dict(attrs)}
            if c0 is not None:
                rec["attrs"].update(cpu_start_ns=c0, cpu_end_ns=c1)
            out.append(rec)
        return out

    def to_json(self) -> dict:
        return {"assembly": self.assembly, "spans": self.records(), "counters": dict(self.counters)}


_current: contextvars.ContextVar = contextvars.ContextVar("tpu_euler_torch_trace", default=OFF)


def current() -> Trace | _Off:
    """The calling context's trace: its assembly's, a ``stage_times``
    block's, else ``OFF``."""
    return _current.get()


def span(name: str, cpu: bool = False, **attrs):
    """A span of the current trace (nothing outside one)."""
    return _current.get().span(name, cpu, **attrs)


def add(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``: the process total, and the current
    assembly's."""
    _current.get().add(name, n)


@contextlib.contextmanager
def assembly():
    """A new trace for the block, whose root span ``assembly`` is the
    block; its rollup goes to ``history`` when the block ends without an
    error. Yields the trace."""
    tr = Trace(next(_assembly_ids))
    token = _current.set(tr)
    try:
        with tr.span(ROOT) as root:
            tr.root = root._id
            yield tr
    finally:
        _current.reset(token)
    _history.append(tr.rollup())


@contextlib.contextmanager
def stage_times(t: dict | None):
    """Within the block, spans go to the current trace, or where there is
    none, to one of the block's own that nothing else reads; when the block
    ends without an error, the seconds of its spans' stages are added to
    ``t`` (where given), in ``STAGES`` order."""
    tr = _current.get()
    token = None
    if tr is OFF:
        tr = Trace()
        token = _current.set(tr)
    start = len(tr.spans)
    try:
        yield tr
    finally:
        if token is not None:
            _current.reset(token)
    if t is not None:
        for stage, s in tr.stage_seconds(start).items():
            t[stage] = t.get(stage, 0.0) + s


def totals() -> dict[str, int]:
    """The process's counters since it started."""
    with _lock:
        return dict(_totals)


def since(before: dict[str, int]) -> dict[str, int]:
    """The counters' growth since ``before`` (a ``totals()``)."""
    now = totals()
    return {name: now[name] - before.get(name, 0) for name in now}


def history() -> list[dict]:
    """The rollups of the last ``HISTORY`` finished assemblies, oldest
    first."""
    return list(_history)
