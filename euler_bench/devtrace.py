"""The profiler's trace of a window, reduced to what the metrics read.

A traced window runs under ``torch.profiler`` (host ops and device
activity). From the raw events (``kineto_results``, which skips the
profiler's own tree building) it keeps:

- the device's intervals (kernels, copies, sets) inside the window, their
  union (``busy_s``: the arithmetic of the port's
  ``profile_config2.device_profile``) and their time by name;
- the idle gaps between them, each named by the innermost host op or span
  that ran on the main thread at the gap's middle.

The spans are the harness's own (``layer_spans``): round each assembly, and,
in a traced run only, round the assembler's calls into its layers, found by
name in ``tpu_euler_torch.pipeline.assemble``. A name that is gone gets no
span, and the run says which on standard error. A gap inside a span and no
op is the host running Python or NumPy there.
"""

from __future__ import annotations

import bisect
import contextlib
import re
from collections import defaultdict

ASSEMBLY_SPAN = "assemble_codes"
# functions of tpu_euler_torch.pipeline.assemble -> the span round each call
LAYER_SPANS = {
    "_batch_feed": "feed wait",  # round each batch taken from the feed
    "extract_fill_packed": "extract launch",
    "oneshot_count": "count: one-shot sort",
    "arena_drain": "count: drain",
    "arena_finalize": "count: finalize",
    "apply_cutoff": "cutoff",
    "build_graph_staged": "graph build",
    "transition_keys_spec": "walk: transition keys",
    "chains_from_t": "walk",
    "chains_to_contigs_device_spec": "emit",
}
SPANS = {ASSEMBLY_SPAN, *LAYER_SPANS.values()}
MIN_LABELED_GAP_NS = 10_000  # shorter gaps are launch latency, counted together
SHORT_GAPS = "gaps under 10 us"
NO_OP = "no op (host Python)"


@contextlib.contextmanager
def profiled(host: bool = True):
    """Profile the block, the host's ops too unless ``host`` is False;
    yields a holder whose ``events`` are filled on exit."""
    from torch.profiler import ProfilerActivity, profile

    holder = type("Trace", (), {})()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        yield holder
    holder.events = prof.profiler.kineto_results.events()


def span():
    """The span the harness puts round each assembly."""
    from torch.profiler import record_function

    return record_function(ASSEMBLY_SPAN)


def _spanned(fn, name):
    from torch.profiler import record_function

    def call(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)

    return call


def _spanned_feed(feed, name):
    from torch.profiler import record_function

    def batches(*args, **kwargs):
        gen = feed(*args, **kwargs)
        try:
            while True:
                with record_function(name):
                    try:
                        batch = next(gen)
                    except StopIteration:
                        return
                yield batch
        finally:
            gen.close()

    return batches


@contextlib.contextmanager
def layer_spans(module):
    """Spans round ``module``'s layer functions for the block; yields the
    names of ``LAYER_SPANS`` that ``module`` does not have."""
    saved, missing = {}, []
    for attr, name in LAYER_SPANS.items():
        fn = getattr(module, attr, None)
        if fn is None:
            missing.append(attr)
        else:
            saved[attr] = fn
            setattr(module, attr, (_spanned_feed if attr == "_batch_feed" else _spanned)(fn, name))
    try:
        yield missing
    finally:
        for attr, fn in saved.items():
            setattr(module, attr, fn)


def union_ns(intervals: list[tuple[int, int]]) -> int:
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or b > end:
            total += b - (a if end is None else max(a, end))
            end = b
    return total


def _device_intervals(events, t0_ns: int, t1_ns: int) -> list[tuple[int, int, str]]:
    """The device's intervals (kernels, copies, sets) clipped to [t0_ns,
    t1_ns], without the spans' own marks on its timeline."""
    out = []
    for e in events:
        if str(e.device_type()).endswith("CUDA") and e.name() not in SPANS:
            a, b = max(e.start_ns(), t0_ns), min(e.end_ns(), t1_ns)
            if b > a:
                out.append((a, b, e.name()))
    return out


def busy_seconds(events, t0_ns: int, t1_ns: int) -> float:
    """Seconds of [t0_ns, t1_ns] in which the device ran an operation."""
    return union_ns([(a, b) for a, b, _ in _device_intervals(events, t0_ns, t1_ns)]) / 1e9


class Reduced:
    """What the metrics read from one traced window [t0_ns, t1_ns]."""

    def __init__(self, events, t0_ns: int, t1_ns: int):
        self.window_s = (t1_ns - t0_ns) / 1e9
        dev, host, main = _device_intervals(events, t0_ns, t1_ns), [], None
        for e in events:
            if not str(e.device_type()).endswith("CUDA"):
                host.append((e.start_ns(), e.end_ns(), e.name(), e.start_thread_id()))
                if main is None and e.name() == ASSEMBLY_SPAN:
                    main = e.start_thread_id()
        self.device_events = len(dev)
        self.busy_s = union_ns([(a, b) for a, b, _ in dev]) / 1e9
        self.by_name: dict[str, float] = defaultdict(float)
        for a, b, name in dev:
            self.by_name[name] += (b - a) / 1e9
        self.gaps = self._gaps(dev, [h for h in host if h[3] == main], t0_ns, t1_ns)

    def kernel_seconds(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(s for name, s in self.by_name.items() if rx.search(name))

    @staticmethod
    def _gaps(dev, host, t0_ns: int, t1_ns: int) -> dict[str, float]:
        host.sort(key=lambda h: (h[0], -h[1]))
        starts = [h[0] for h in host]
        parent = [-1] * len(host)
        stack: list[int] = []
        for i, (a, b, _, _) in enumerate(host):  # one thread's ops nest
            while stack and host[stack[-1]][1] < a:
                stack.pop()
            parent[i] = stack[-1] if stack else -1
            stack.append(i)
        out: dict[str, float] = defaultdict(float)
        at = t0_ns
        for a, b, _ in sorted(dev) + [(t1_ns, t1_ns, None)]:
            if a > at:
                if a - at < MIN_LABELED_GAP_NS:
                    out[SHORT_GAPS] += (a - at) / 1e9
                else:
                    mid = (a + at) // 2
                    i = bisect.bisect_right(starts, mid) - 1
                    while i >= 0 and host[i][1] < mid:
                        i = parent[i]
                    out[host[i][2] if i >= 0 else NO_OP] += (a - at) / 1e9
            at = max(at, b)
        return out

    def breakdown(self, top: int = 10) -> dict:
        def head(d):
            return [[name[:200], s] for name, s in sorted(d.items(), key=lambda x: -x[1])[:top]]

        return {"device_ops": head(self.by_name), "idle_gaps": head(self.gaps)}
