"""Per-layer metrics from the assembler's own record.

Each finished assembly of ``tpu_euler_torch`` leaves a rollup in
``tpu_euler_torch.trace.history()``: seconds per span name, process-CPU
seconds where a span records them, calls, and counters. A traced window's
assemblies are the last ``len(ctx["stages"])`` rollups there (the harness
reads its metrics before anything else assembles). A program without that
record gives no reading.
"""

from __future__ import annotations


def window(ctx: dict) -> list[dict] | None:
    """The rollups of the window's finished assemblies, or None where the
    program keeps none (or fewer than the window finished)."""
    n = len(ctx["stages"])
    try:
        from tpu_euler_torch import trace
    except ImportError:
        return None
    done = trace.history()[-n:] if n else []
    return done if n and len(done) == n else None


def mean(ctx: dict, field: str, *names: str) -> float | None:
    """The mean per assembly of ``field`` ("seconds" or "cpu_seconds")
    summed over the spans ``names``; None where no rollup has them."""
    done = window(ctx)
    if done is None or not any(name in r[field] for r in done for name in names):
        return None
    return sum(r[field].get(name, 0.0) for r in done for name in names) / len(done)
