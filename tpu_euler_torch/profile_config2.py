"""Where SPEC config 2's (or config 3's, config 4's or config 5's) time
goes on one CUDA card.

    python -m tpu_euler_torch.profile_config2 [--k 31] [--repeats 3] [--out FILE.json]
    python -m tpu_euler_torch.profile_config2 --config 3 [--repeats 3] [--out FILE.json]
    python -m tpu_euler_torch.profile_config2 --config 4 [--loopback 4 [--shard-traversal]] [--repeats 2] [--out FILE.json]
    python -m tpu_euler_torch.profile_config2 --config 3 --loopback 4 --shard-traversal [--repeats 1] [--out FILE.json]
    python -m tpu_euler_torch.profile_config2 --config 5 [--repeats 1] [--out FILE.json]
    python -m tpu_euler_torch.profile_config2 --config 5 --loopback 4 [--genome-bp 25000000 --shard-traversal] [--repeats 1]

``--k`` replaces config 2's k (31) on the same genome and reads; k = 41 is
SPEC config 5's k, with two-word keys. ``--config 5`` runs SPEC config 5 at
full size (100 Mbp, 40x, k = 41: grouped arena counting, 13 groups).
``--config 4`` runs SPEC config 4 at full size (12 Mbp, 60x paired-end,
k = 31: grouped arena counting at one-word keys); with ``--loopback N`` it
runs sharded over N ranks held by this process on the one card
(``dist/pipeline.py`` with a ``LoopbackComm``, which ships int8 codes);
with ``--shard-traversal`` also the traversal stays sharded
(``dist/traverse_dist.py``). Over NCCL ranks the bench entry times them
(``bench_torch.py --mesh N``, through ``mesh_rank`` here). ``--genome-bp``
cuts the genome of configs 3, 4 and 5 (their other settings, and config
5's capacity rule, unchanged). ``--config 3`` runs SPEC config 3 at full
size (4.6 Mbp, 40x reads with 0.4% errors, cutoff 4, three tip and two
bubble rounds, k = 31). After one warm-up run it measures, on the same
input:

1. ``walls``/``stages``/``peak_gib``: ``repeats`` (at least one) runs of the assembly,
   host clock, the pipeline's own stage timers and the peak of
   ``torch.cuda.max_memory_allocated`` over them;
2. ``fine_s`` and ``counters``: the last of those runs split by the
   assembly's own record (``AssemblyResult.trace``, ``trace.py``; nothing
   is wrapped or synchronized for it). ``fine_s`` has each span name's
   seconds and calls, and process-CPU seconds where the span records them
   (the feed worker's ``feed: pack``); a name of a few calls also lists
   each call with its attributes (``fine_split``): the arena's drains by
   group, config 3's cleaning rounds (``clean: graph`` and ``clean: mark``,
   by kind and round). Spans of one thread nest (``clean`` holds the
   rounds); the feed worker's run beside the main thread, whose wait for
   them is ``feed: wait``. A sharded run splits by stage: its steps,
   drains, gather, traversal attempts and fragment emission;
3. ``device``: one run under ``torch.profiler`` (CPU + CUDA): the union of the
   card's kernel and copy intervals against the run's host wall, the count of
   device events and kernel launches, the host-to-device copies' device
   time, and the ops with the most device time.

It prints the JSON record (and writes it to ``--out``) and fails where there
is no CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch


#: a span name of 2 to this many calls lists each call in ``fine_s``
EACH_MOST = 40


def fine_split(rollup: dict, records: list) -> dict:
    """An assembly's rollup (``Trace.rollup``) as the record's ``fine_s``:
    span name -> ``s`` (seconds), ``calls`` and, where the span records
    it, ``cpu_s`` (process-CPU seconds), the costliest first. A name of 2
    to ``EACH_MOST`` calls also lists each call's seconds and attributes
    from the trace's ``records``, in the order they ended (``each``)."""
    each = collections.defaultdict(list)
    for r in records:
        attrs = {k: v for k, v in r["attrs"].items() if k not in ("cpu_start_ns", "cpu_end_ns")}
        each[r["name"]].append({"s": (r["end_ns"] - r["start_ns"]) / 1e9, **attrs})
    out = {}
    for name, s in sorted(rollup["seconds"].items(), key=lambda kv: -kv[1]):
        row = {"s": s, "calls": rollup["calls"][name]}
        if name in rollup["cpu_seconds"]:
            row["cpu_s"] = rollup["cpu_seconds"][name]
        if 1 < len(each[name]) <= EACH_MOST:
            row["each"] = each[name]
        out[name] = row
    return out


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _union_seconds(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e6  # profiler times are in microseconds


# the runtime and driver calls that launch a kernel (the pointer-jump doubling
# is a cooperative launch)
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel", "cuLaunchCooperativeKernel")


def device_profile(run) -> dict:
    """One ``run()`` under torch.profiler: device busy share and top ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = _union_seconds((e.time_range.start, e.time_range.end) for e in dev_events)
    averages = prof.key_averages()
    launches = sum(a.count for a in averages if a.key in LAUNCH_CALLS)
    top = sorted(
        ((a.device_time_total / 1e3, a.key[:120], a.count) for a in averages if a.device_time_total > 0),
        reverse=True,
    )[:15]
    return {
        "profiled_wall_s": wall,
        "device_busy_union_s": busy,
        "device_idle_share": 1.0 - busy / wall,
        "n_device_events": len(dev_events),
        "kernel_launches": launches,
        "h2d_copy_ms": sum(a.device_time_total for a in averages if a.key.startswith("Memcpy HtoD")) / 1e3,
        "top_device_ms": top,
    }


@contextlib.contextmanager
def slab_retries():
    """The sharded traversal's retry warnings ("retrying with a bigger
    slab") over the block, collected from the port's logger."""
    import logging

    seen = []

    class Catch(logging.Handler):
        def emit(self, record):
            if "retrying with a bigger slab" in record.getMessage():
                seen.append(record.getMessage())

    handler, logger = Catch(), logging.getLogger("tpu_euler_torch")
    logger.addHandler(handler)
    try:
        yield seen
    finally:
        logger.removeHandler(handler)


def barrier(comm) -> None:
    """Wait until every rank of ``comm`` is here: a one-element all-reduce,
    read back on the host."""
    comm.all_reduce_sum([torch.zeros(1, device=comm.device)])[0].item()


def mesh_rank(comm, codes_path, cfg, shard_traversal: bool = False, repeats: int = 1, diagnose=None) -> dict:
    """A ``spawn_ranks`` target: on one rank, ``assemble_reads_distributed``
    on the [R, read_len] int8 codes mapped from ``codes_path``, once to warm
    up, ``repeats`` (at least one) times timed (walls, stage splits, the
    peak of device memory over them, the int8 extract kernel's launches in
    each) and, on a CUDA device, once under torch.profiler. Every rank
    waits for the others before each timed run, so that the ranks' walls
    of a run time the same run. ``diagnose(device)``, where given (a
    module-level function), runs before each timed run, ahead of the
    barrier, and its dicts are returned.
    Returns those, the sharded traversal's slab retries over all runs, the
    last timed run's result, and when the rank began (``time.time()``)."""
    import numpy as np

    from tpu_euler_torch.dist.pipeline import assemble_reads_distributed

    started = time.time()
    codes = np.load(codes_path, mmap_mode="c")
    dev, cuda = comm.device, comm.device.type == "cuda"

    def run():
        return assemble_reads_distributed(None, cfg, comm, codes=codes, shard_traversal=shard_traversal)

    with slab_retries() as retries:
        run()
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        walls, stages, launches, diagnoses = [], [], [], []
        for _ in range(max(1, repeats)):
            if diagnose is not None:
                diagnoses.append(diagnose(dev))
            res = None  # the last run's result is dropped before the next run
            barrier(comm)
            t0 = time.perf_counter()
            res = run()
            walls.append(time.perf_counter() - t0)
            stages.append(res.stage_seconds)
            launches.append(res.trace.counters["extract_int8_launches"])
        peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None
        device = device_profile(run) if cuda else None
    return {
        "rank": comm.ranks[0],
        "started_unix_s": started,
        "result": res,
        "walls": walls,
        "stages": stages,
        "launches": launches,
        "diagnoses": diagnoses,
        "retries": retries,
        "peak_gib": peak,
        "device": device,
    }


def _emit(rec: dict, out: str) -> int:
    """Print the record, and write it to ``out`` where given."""
    text = json.dumps(rec, indent=1)
    print(text)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            f.write(text + "\n")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", type=int, choices=(2, 3, 4, 5), default=2)
    ap.add_argument("--loopback", type=int, default=0, help="shard over this many ranks held on the one card")
    ap.add_argument("--shard-traversal", action="store_true", help="with --loopback: keep the traversal sharded")
    ap.add_argument("--genome-bp", type=int, default=0, help="cut the genome of configs 3, 4 and 5 to this many bases")
    ap.add_argument("--k", type=int, default=31, help="config 2's k-mer length (odd)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_config2: no CUDA device")
    if args.shard_traversal and not args.loopback:
        raise SystemExit("profile_config2: --shard-traversal needs --loopback N")
    if args.genome_bp and args.config == 2:
        raise SystemExit("profile_config2: --genome-bp cuts configs 3, 4 and 5")

    from tpu_euler_torch.pipeline.assemble import assemble_codes
    from tpu_euler_torch.dist.mesh import LoopbackComm
    from tpu_euler_torch.dist.pipeline import assemble_reads_distributed
    from tpu_euler_torch.simulate import config2_inputs, config3_inputs, config4_inputs, config5_inputs

    dev = torch.device("cuda:0")
    card = card_line()
    t0 = time.perf_counter()
    cut = (args.genome_bp,) if args.genome_bp else ()
    if args.config == 5:
        genome, codes, cfg = config5_inputs(*cut)
    elif args.config == 4:
        genome, codes, cfg = config4_inputs(*cut)
    elif args.config == 3:
        genome, codes, cfg = config3_inputs(*cut)
    else:
        genome, codes, cfg = config2_inputs()
        cfg = dataclasses.replace(cfg, k=args.k)
    sim_s = time.perf_counter() - t0

    def run():
        if args.loopback:
            res = assemble_reads_distributed(
                None, cfg, LoopbackComm(args.loopback, dev), codes=codes, shard_traversal=args.shard_traversal
            )
        else:
            res = assemble_codes(codes, cfg, dev)
        one = len(res.contigs) == 1 and len(next(iter(res.contigs))) == len(genome) + cfg.k - 1
        if args.config != 3 and not one:
            raise AssertionError(f"config {args.config}: expected one contig of G + k - 1 bases")
        return res

    return _measure(args, run, genome, cfg, card, sim_s, dev)


def _measure(args, run, genome, cfg, card, sim_s, dev) -> int:
    """Warm-up, the timed repeats (the last one's trace split into
    ``fine_s``) and the profiled run of ``run``; prints (and writes) the
    record."""
    from tpu_euler_torch.verify.compare import substring_gate

    warm = run()  # warm-up
    gate = None
    if args.config == 3:  # reads with errors: many contigs, each an exact substring
        gate = substring_gate(warm.contigs, genome, 150, circular=True)
        if gate["contigs_substring_ok"] != gate["contigs_checked"] or gate["coverage_lower_bound"] < 0.99:
            raise AssertionError(f"config 3: the substring gate failed: {gate}")
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    walls, stages = [], []
    for _ in range(max(1, args.repeats)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        walls.append(time.perf_counter() - t0)
        stages.append(res.stage_seconds)
    peak = torch.cuda.max_memory_allocated(dev)

    rec = {
        "card": card,
        "torch": torch.__version__,
        "config": args.config,
        "genome_bp": len(genome),
        "loopback_ranks": args.loopback,
        "shard_traversal": args.shard_traversal,
        "transport": "int8" if args.loopback else "packed",
        "k": cfg.k,
        "simulation_s": sim_s,
        **({"gate": gate} if gate else {}),
        "walls": walls,
        "stages": stages,
        "peak_gib": peak / 2**30,
        "fine_s": fine_split(res.trace.rollup(), res.trace.records()),
        "counters": res.trace.counters,
        "device": device_profile(run),
    }
    return _emit(rec, args.out)


if __name__ == "__main__":
    sys.exit(main())
