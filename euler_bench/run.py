#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on the card this machine holds.

    python3 euler_bench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the checkout's root. A run:

1. loads the cell's configuration and traffic files by name;
2. fails (exit 2, no result) without a CUDA card, or with fewer cards than
   the cell asks for;
3. loads the assembler's kernels (the first run of a checkout builds them
   into its fixed ``build/tpu_euler_torch/``), and fails (exit 2, no
   result) where the native read packer does not load: the assembler would
   then pack on another, slower path and the run would measure that;
4. makes the genome and the reads from ``--seed`` on the card
   (``reads.py``) and hands the host code matrix to the assembler; a mix
   with ``read_sets`` N makes N read sets, set i from seed ``--seed`` +
   i * 2^32 (each its own genome and reads, all of one size), so that a
   run's work does not hang on what one seed's errors happen to leave;
5. runs one cold assembly of the first read set (``cold_assembly_s``);
   everything up to here is ``setup_s``, counted from the interpreter's
   first line;
6. runs the window: a closed loop of ``assemble_codes`` over the read sets
   in turn, one assembly after another with nothing between them but
   keeping each result, until ``--seconds`` have passed and every read set
   has been assembled once; the last one started before then is finished
   and counts. The allocator's cache is kept. With ``--trace 1`` the window
   runs under ``torch.profiler``; with ``--trace 0``, in a cell that reports a
   ``DEVICE_ACTIVITY`` metric, under the profiler's device activity alone;
7. reads the window's peak of device memory, frees the assembler's cached
   memory, and runs the plain reference (``reference.py``) on each read
   set on the card, with the cell's cutoff and cleaning rounds; it logs
   the k-mers the reference's tip and bubble rounds removed;
8. compares every assembly of the window (and the cold one) with the
   reference of its read set: windows counted, distinct k-mers after the
   cutoff and the cleaning, and the canonical contig set byte for byte.
   Each number compared is printed with its limit as the last lines on
   standard error;
9. prints the result as the last line of standard output: ``correct``,
   ``attempted`` (assemblies in the window), ``failed`` (those that raised or
   disagreed), ``metrics`` (the cell's end-to-end metrics, or with
   ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
   ``breakdown``, and last ``checks``.

It exits non-zero with no result where the window leaves JAX or the JAX
package ``tpu_euler`` loaded, or where a file it needs is missing.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
from contextlib import nullcontext  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "euler_bench":
    sys.path[0] = str(ROOT)  # the package, not its files, is importable
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_euler")
READ_SET_STRIDE = 1 << 32  # read set i of a run is made from seed + i * stride


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (whole names: ``tpu_euler_torch`` is not ``tpu_euler``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# --- end-to-end metrics, by name -------------------------------------------

END_TO_END = {
    "assembly_s": lambda run: run["window_s"] / len(run["walls"]),
    "device_busy_s": lambda run: run["busy_s"] / len(run["walls"]) if run["busy_s"] is not None else None,
    "device_busy_s.clean": lambda run: END_TO_END["device_busy_s"](run),
    "peak_device_gib": lambda run: run["peak_bytes"] / 2**30 if run["peak_bytes"] is not None else None,
    "cold_assembly_s": lambda run: run["cold_s"],
    "setup_s": lambda run: run["setup_s"],
}


# end-to-end metrics read from the device's activity: a cell that reports one
# runs its untraced window under the profiler's device activity alone
DEVICE_ACTIVITY = ("device_busy_s", "device_busy_s.clean")


# --- per-layer metrics, by recipe ------------------------------------------


def per_layer_value(metric: dict, ctx: dict, bench: Path) -> float | None:
    """One per-layer metric from its recipe (``metrics/<name>.json``); None
    where there is nothing to read."""
    from euler_bench import cells, rooflines

    recipe = metric["recipe"]
    kind = recipe["kind"]
    trace = ctx["trace"]
    if kind == "stage_mean":
        stages = ctx["stages"]
        if not stages or not any(s in st for st in stages for s in recipe["stages"]):
            return None
        return sum(sum(st.get(s, 0.0) for s in recipe["stages"]) for st in stages) / len(stages)
    if kind == "device_idle":
        return None if trace is None else 100.0 * (1.0 - trace.busy_s / trace.window_s)
    if kind == "kernel_roofline":
        if trace is None:
            return None
        seconds = trace.kernel_seconds(recipe["kernels"])
        if seconds <= 0.0:
            log(f"{metric['name']}: no device time under /{recipe['kernels']}/: not measured")
            return None
        per_assembly = getattr(rooflines, recipe["bytes"])(ctx["n_reads"], ctx["settings"])
        bound_s = per_assembly * len(ctx["stages"]) / rooflines.peak_bytes_per_s(ctx["kind"])
        return 100.0 * bound_s / seconds
    if kind == "reader":
        return cells.load_reader(bench, recipe.get("reader", metric["name"]))(ctx)
    raise ValueError(f"{metric['name']}: unknown recipe kind {kind!r}")


# --- the comparison --------------------------------------------------------

LIMITS = {"windows_gap": 0, "distinct_gap": 0, "contigs_only_program": 0, "contigs_only_reference": 0, "raised": 0}


def compare(outcome, ref) -> dict:
    """The numbers compared for one assembly: each is 0 when it agrees."""
    if isinstance(outcome, BaseException):
        return {"raised": 1}
    return {
        "windows_gap": abs(outcome.n_kmers_counted - ref.windows),
        "distinct_gap": abs(outcome.n_distinct_kmers - ref.distinct),
        "contigs_only_program": len(outcome.contigs - ref.contigs),
        "contigs_only_reference": len(ref.contigs - outcome.contigs),
        "raised": 0,
    }


# --- one run ---------------------------------------------------------------


class NoResult(RuntimeError):
    """Set-up cannot give the run the path it measures: no result."""


def load_kernels() -> None:
    """The assembler's kernels and its native read packer, built on a
    checkout's first run."""
    from tpu_euler_torch.euler import ranking_kernel
    from tpu_euler_torch.io import native
    from tpu_euler_torch.kmer import extract_kernel

    if not native.native_available():
        raise NoResult("the native read packer (tpu_euler_torch/io/native) did not build or load")
    extract_kernel.build()
    ranking_kernel.build()


def _assemble_or_raise(assemble, codes, acfg, dev):
    try:
        return assemble(codes, acfg, dev)
    except Exception as e:  # a failed assembly is counted, and the window goes on
        log(f"an assembly raised: {e!r}")
        return e


def run_cell(
    workload: str,
    seed: int,
    seconds: float,
    trace: bool,
    device: str = "cuda",
    root: Path = ROOT,
    t_start: float | None = None,
    assemble=None,
) -> dict:
    """One run of cell ``workload``; returns the result line's object.
    ``assemble`` stands in for the assembler's ``assemble_codes`` (the
    control and the tests put others there)."""
    import torch

    from euler_bench import cells, devtrace, reads, reference
    from tpu_euler_torch.config import AssemblyConfig
    from tpu_euler_torch.pipeline.assemble import assemble_codes

    assemble = assemble or assemble_codes
    t_start = T_START if t_start is None else t_start
    cell = cells.load(root, workload)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    settings = cell.settings()
    acfg = AssemblyConfig(**settings)

    if cuda:
        load_kernels()
    read_sets = [
        reads.host_codes(reads.make_codes(seed=seed + i * READ_SET_STRIDE, device=dev, **cell.read_params()))
        for i in range(cell.read_sets)
    ]
    if cuda:
        torch.cuda.empty_cache()  # the cold assembly meets the allocator as a user's first run does
    n_reads, read_len = read_sets[0].shape
    log(f"{workload}: {len(read_sets)} read set(s) of {n_reads} reads of {read_len} bases, seed {seed}")

    t0 = time.perf_counter()
    cold = _assemble_or_raise(assemble, read_sets[0], acfg, dev)
    cold_s = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s, of it the cold assembly {cold_s:.3f} s")

    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    walls, outcomes = [], []
    spans = devtrace.layer_spans(sys.modules[assemble_codes.__module__]) if trace else nullcontext()
    busy_only = cuda and not trace and any(m["name"] in DEVICE_ACTIVITY for m in cell.end_to_end)
    profiler = devtrace.profiled(host=not busy_only) if trace or busy_only else nullcontext()
    with spans as missing_spans, profiler as holder:
        t_open, t_open_ns = time.perf_counter(), time.time_ns()
        while True:
            t0 = time.perf_counter()
            with devtrace.span() if trace else nullcontext():
                outcomes.append(_assemble_or_raise(assemble, read_sets[len(walls) % len(read_sets)], acfg, dev))
            t1 = time.perf_counter()
            walls.append(t1 - t0)
            if t1 - t_open >= seconds and len(walls) >= len(read_sets):
                break
        if cuda:
            torch.cuda.synchronize(dev)
        window_s, t_close_ns = time.perf_counter() - t_open, time.time_ns()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    log(f"window {window_s:.3f} s, {len(walls)} assemblies, walls {[round(w, 4) for w in walls]}")
    done = [o.stage_seconds for o in outcomes if not isinstance(o, BaseException)]
    if done:
        log(f"stages, mean per assembly: { {k: round(sum(d.get(k, 0.0) for d in done) / len(done), 4) for k in done[0]} }")

    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    if trace:
        t0 = time.perf_counter()
        reduced = devtrace.Reduced(holder.events, t_open_ns, t_close_ns)
        log(f"trace: {len(holder.events)} events, {reduced.device_events} on the device, read in "
            f"{time.perf_counter() - t0:.3f} s")
        if missing_spans:
            log(f"trace: no function {', '.join(missing_spans)} in {assemble_codes.__module__}: those spans are "
                f"missing, and their idle gaps go under other names")
        ctx = {"trace": reduced, "stages": done, "n_reads": n_reads, "settings": settings, "kind": kind,
               "window_s": window_s, "assemblies": len(walls)}
        metrics = {m["name"]: (per_layer_value(m, ctx, cell.bench), m["unit"]) for m in cell.per_layer}
    else:
        busy_s = devtrace.busy_seconds(holder.events, t_open_ns, t_close_ns) if busy_only else None
        if busy_only:
            log(f"device busy {busy_s:.3f} s of the window's {window_s:.3f} s")
        run = {"walls": walls, "window_s": window_s, "peak_bytes": peak, "cold_s": cold_s, "setup_s": setup_s,
               "busy_s": busy_s}
        metrics = {m["name"]: (END_TO_END[m["name"]](run), m["unit"]) for m in cell.end_to_end}

    del holder
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    refs = []
    for i, codes in enumerate(read_sets):
        t0 = time.perf_counter()
        refs.append(reference.assemble(codes, settings, dev))
        ref = refs[-1]
        log(f"reference, read set {i}, {time.perf_counter() - t0:.3f} s: {ref.windows} windows, {ref.distinct} "
            f"k-mers, {len(ref.contigs)} contigs; clipped {sum(ref.clipped)} k-mers (by round {ref.clipped}), "
            f"popped {sum(ref.popped)} (by round {ref.popped})")
    checked = [compare(cold, refs[0])] + [compare(o, refs[i % len(refs)]) for i, o in enumerate(outcomes)]
    checks = {name: max(c.get(name, 0) for c in checked) for name in LIMITS}
    failed = sum(any(v > LIMITS[n] for n, v in c.items()) for c in checked[1:])
    correct = bool(outcomes) and failed == 0 and all(checks[n] <= LIMITS[n] for n in LIMITS)

    device_rec = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": cell.chips, "memory_peak_bytes": peak}
    if trace:
        device_rec.update(busy_s=reduced.busy_s, window_s=reduced.window_s)
    out = {
        "correct": correct,
        "attempted": len(outcomes),
        "failed": failed,
        "metrics": {n: {"value": v, "unit": u} for n, (v, u) in metrics.items() if v is not None},
        "device": device_rec,
    }
    if trace:
        out["breakdown"] = reduced.breakdown()
    out["checks"] = {n: {"value": v, "limit": LIMITS[n]} for n, v in checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from euler_bench import cells

    try:
        cell = cells.load(ROOT, args.workload)
    except (OSError, KeyError, ValueError) as e:
        log(f"cannot load cell {args.workload!r}: {e!r}")
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"needs {cell.chips} CUDA card(s), found {n}: no result")
        return 2
    try:
        out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except NoResult as e:
        log(f"{e}: no result")
        return 2
    bad = forbidden_modules()
    if bad:
        log(f"loaded in this process: {', '.join(bad)}: no result")
        return 3
    for name, c in out["checks"].items():
        log(f"{name} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
