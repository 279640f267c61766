"""Where SPEC config 2's (or config 3's, config 4's or config 5's) time
goes on one CUDA card.

    python -m tpu_euler_torch.profile_config2 [--k 31] [--repeats 3] [--transport packed|int8] [--out FILE.json]
    python -m tpu_euler_torch.profile_config2 --config 3 [--repeats 3] [--out FILE.json]
    python -m tpu_euler_torch.profile_config2 --config 4 [--loopback 4 [--shard-traversal]] [--repeats 2] [--out FILE.json]
    python -m tpu_euler_torch.profile_config2 --config 3 --loopback 4 --shard-traversal [--repeats 1] [--out FILE.json]
    python -m tpu_euler_torch.profile_config2 --config 5 [--repeats 1] [--transport packed|int8] [--out FILE.json]
    python -m tpu_euler_torch.profile_config2 --config 5 --loopback 4 [--genome-bp 25000000 --shard-traversal] [--repeats 1]

``--transport`` picks what the single-device routes' feed copies to the
card: ``packed`` (their own: 2.25 bits a base, the extract kernel's packed
loader) or ``int8`` (one byte a base, the int8 loader, as the sharded mode
ships its batches); the sharded runs (``--loopback``) always take int8.
``--k`` replaces config 2's k (31) on the same genome and reads; k = 41 is
SPEC config 5's k, with two-word keys. ``--config 5`` runs SPEC config 5 at
full size (100 Mbp, 40x, k = 41: grouped arena counting, 13 groups).
``--config 4`` runs SPEC config 4 at full size (12 Mbp, 60x paired-end,
k = 31: grouped arena counting at one-word keys); with ``--loopback N`` it
runs sharded over N ranks held by this process on the one card
(``dist/pipeline.py`` with a ``LoopbackComm``), and the fine run splits a
step into extract kernel, hash and owner grouping, and the exchange; with
``--shard-traversal`` also the traversal stays sharded
(``dist/traverse_dist.py``), and the fine run splits it into the chains
steps (node-record exchange, cycle detection, the two Wyllie passes, their
request/reply gathers), the tip and bubble steps, the compactions and the
fragment emission (copies from the shards, the host's assembly).
Over NCCL ranks the bench entry times them (``bench_torch.py --mesh N``,
through ``mesh_rank`` here). ``--genome-bp`` cuts the genome of configs 3, 4
and 5 (their other settings, and config 5's capacity rule, unchanged).
``--config 3`` runs SPEC config 3 at full size (4.6 Mbp, 40x reads with 0.4%
errors, cutoff 4, three tip and two bubble rounds, k = 31); its ``tips``
stage is split into its rounds, and each round into graph build, transition
keys, walk, and mark + compact. After one warm-up run it measures, on the
same input:

1. ``walls``/``stages``/``peak_gib``: ``repeats`` plain runs of
   ``assemble_codes``, host clock, the pipeline's own stage timers and the
   peak of ``torch.cuda.max_memory_allocated`` over them;
2. ``fine_s``: one run with the functions below wrapped so each is timed
   between two ``torch.cuda.synchronize()`` calls (the syncs add a little to
   that run's wall, ``fine_wall_s``); nested entries are inside their parent,
   and a function called a few times (the arena drain, once per group)
   also lists each call's seconds. The feed is split (``feed_split``): the
   worker thread's pack into pinned memory and the rest of its pad-and-stage
   time (host clock, no sync: it runs beside the main thread), its
   host-to-device copies (CUDA events on the copy stream) and their bytes,
   and the main thread's wait for the prefetcher, which is that run's
   ``encode`` stage timer;
3. ``device``: one run under ``torch.profiler`` (CPU + CUDA): the union of the
   card's kernel and copy intervals against the run's host wall, the count of
   device events and kernel launches, and the ops with the most device time.

It prints the JSON record (and writes it to ``--out``) and fails where there
is no CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

import torch

# (module, attribute, key[, clock]): the functions the fine run times. The
# pipeline and the walk look each of them up as a module global at call time.
# clock: "sync" (default) = host clock between two device synchronizations;
# "host" = host clock alone (the feed's worker thread); "events" = CUDA
# events on the stream the function is called on (the feed's copy stream).
FEED_PACK = "feed: worker pack into pinned memory (host)"
FEED_STAGE = "feed: worker pad + stage into pinned memory, the pack apart (host)"
FEED_COPY = "feed: H2D copies from pinned memory (copy stream)"
FEED_BYTES = "feed: H2D bytes"
FEED_WAIT = "feed: main thread's wait for the prefetcher (encode)"
FINE = [
    ("tpu_euler_torch.pipeline.assemble", "extract_fill_packed", "extract kernel (packed loader)"),
    ("tpu_euler_torch.pipeline.assemble", "extract_fill", "extract kernel (int8 loader)"),
    ("tpu_euler_torch.pipeline.assemble", "oneshot_count", "sort + dedup"),
    ("tpu_euler_torch.pipeline.assemble", "arena_drain", "arena drain"),
    ("tpu_euler_torch.pipeline.assemble", "arena_finalize", "arena finalize"),
    ("tpu_euler_torch.pipeline.assemble", "merge_keys", "per-batch merge"),
    ("tpu_euler_torch.pipeline.assemble", "right_size_spectrum", "right_size"),
    ("tpu_euler_torch.pipeline.assemble", "apply_cutoff", "cutoff"),
    ("tpu_euler_torch.pipeline.assemble", "clip_tips", "clip_tips (all rounds)"),
    ("tpu_euler_torch.pipeline.assemble", "pop_bubbles", "pop_bubbles (all rounds)"),
    ("tpu_euler_torch.euler.clean", "build_graph_staged", "  round: graph build"),
    ("tpu_euler_torch.euler.clean", "successor", "  round: successor"),
    ("tpu_euler_torch.euler.unitigs", "transition_keys_spec", "  round: transition keys"),
    ("tpu_euler_torch.euler.unitigs", "chains_from_t", "  round: walk"),
    ("tpu_euler_torch.euler.clean", "_tip_mark", "  round: tip mark + compact"),
    ("tpu_euler_torch.euler.clean", "_bubble_mark", "  round: bubble mark + compact"),
    ("tpu_euler_torch.pipeline.assemble", "build_graph_staged", "build_graph_staged"),
    ("tpu_euler_torch.pipeline.assemble", "successor", "successor"),
    ("tpu_euler_torch.pipeline.assemble", "transition_keys_spec", "transition_keys"),
    ("tpu_euler_torch.pipeline.assemble", "chains_from_t", "chains_from_t"),
    ("tpu_euler_torch.euler.ranking", "cycle_min_ruling_tables", "  cycle_min_ruling_tables"),
    ("tpu_euler_torch.euler.ranking", "rank_chains_with_cut", "  rank_chains_with_cut"),
    ("tpu_euler_torch.pipeline.assemble", "chains_to_contigs_device_spec", "emission"),
    ("tpu_euler_torch.euler.extract", "emit_chains_device", "  emit (device)"),
    ("tpu_euler_torch.euler.extract", "_emission_to_contigs", "  host tail (D2H + numpy)"),
    # the sharded mode (--loopback)
    ("tpu_euler_torch.dist.pipeline", "dist_fill_step", "sharded fill step (extract, grouping, all-to-all, write)"),
    ("tpu_euler_torch.dist.count_dist", "local_send", "  a rank's send: extract, hash, owner grouping"),
    ("tpu_euler_torch.dist.count_dist", "extract_fill", "    extract kernel"),
    ("tpu_euler_torch.dist.count_dist", "_group_by_owner", "    owner grouping (sort of the owner, slab scatter)"),
    ("tpu_euler_torch.dist.pipeline", "dist_drain_step", "sharded drain step (all ranks)"),
    ("tpu_euler_torch.dist.count_dist", "oneshot_count", "  a rank's group sort + dedup"),
    ("tpu_euler_torch.dist.count_dist", "merge_spectra_lean", "  a rank's lean merge"),
    ("tpu_euler_torch.dist.pipeline", "gather_spectrum", "gather (all-gather + one sort)"),
    # the sharded traversal (--shard-traversal)
    ("tpu_euler_torch.dist.pipeline", "dist_cutoff_step", "sharded cutoff"),
    ("tpu_euler_torch.dist.pipeline", "dist_chains_step", "sharded chains step (all ranks)"),
    ("tpu_euler_torch.dist.traverse_dist", "_node_record_exchange", "  node-record exchange"),
    ("tpu_euler_torch.dist.traverse_dist", "_node_slab", "    a rank's records into slabs (hash, owner grouping)"),
    ("tpu_euler_torch.dist.traverse_dist", "_serve_node_records", "    an owner's sort, degrees and replies"),
    ("tpu_euler_torch.dist.traverse_dist", "_detect_pass", "  doubling: cycle detection + minimum transition"),
    ("tpu_euler_torch.dist.traverse_dist", "_wyllie_pass", "  doubling: a Wyllie pass (chain id, then position)"),
    ("tpu_euler_torch.dist.traverse_dist", "exchange_gather", "    request/reply gather over ranks (every caller)"),
    ("tpu_euler_torch.dist.traverse_dist", "exchange_push", "    push over ranks (every caller)"),
    ("tpu_euler_torch.dist.pipeline", "dist_tip_step", "sharded tip step"),
    ("tpu_euler_torch.dist.pipeline", "dist_bubble_step", "sharded bubble step"),
    ("tpu_euler_torch.dist.traverse_dist", "_serve_bubble_records", "  a (u, v) owner's sort and verdicts"),
    ("tpu_euler_torch.dist.pipeline", "dist_compact_step", "sharded compaction"),
    ("tpu_euler_torch.dist.pipeline", "shard_chains_to_contigs", "fragment emission"),
    ("tpu_euler_torch.dist.traverse_dist", "local_chain_fragments", "  fragments: select on the device, copy to the host"),
    ("tpu_euler_torch.dist.traverse_dist", "assemble_contig_fragments", "  fragments: the host's assembly (numpy)"),
]


@contextlib.contextmanager
def synced_timers(acc: dict):
    """Wrap every FINE function with its timer adding seconds into ``acc``."""
    import importlib

    saved = []
    pending = []  # (key, start event, end event), read once the run is over

    def wrap(fn, key, clock):
        def timed(*a, **kw):
            if clock == "events":
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*a, **kw)
                end.record()
                pending.append((key, start, end))
                return out
            if clock == "sync":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if clock == "sync":
                torch.cuda.synchronize()
            acc.setdefault(key, []).append(time.perf_counter() - t0)
            return out

        return timed

    try:
        for mod_name, attr, key, *clock in FINE:
            mod = importlib.import_module(mod_name)
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, wrap(getattr(mod, attr), key, clock[0] if clock else "sync"))
        yield acc
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)
        torch.cuda.synchronize()
        for key, start, end in pending:
            acc.setdefault(key, []).append(start.elapsed_time(end) / 1e3)


@contextlib.contextmanager
def transport(name: str):
    """Within the block, the single-device routes' feed ships ``name``:
    "packed" (their own) or "int8" (one byte a base, as the sharded mode's
    feed does)."""
    from tpu_euler_torch.pipeline import assemble

    if name not in ("packed", "int8"):
        raise ValueError(f"no transport {name!r}")
    feed = assemble._batch_feed
    if name == "int8":
        assemble._batch_feed = functools.partial(feed, packed=False)
    try:
        yield
    finally:
        assemble._batch_feed = feed


@contextlib.contextmanager
def feed_split():
    """The single-device feed's time split, over the block: the dict it
    yields gets ``pack_s`` (the worker's pack into pinned memory, host
    clock), ``stage_s`` (the rest of the worker's pad and stage time),
    ``h2d_s`` (the copies, CUDA events on the copy stream), ``h2d_bytes``
    and ``batches`` when the block ends. The worker runs beside the main
    thread, so none of these is on the main thread's path but its wait
    (the ``encode`` stage timer)."""
    from tpu_euler_torch.pipeline import assemble

    out: dict = {}
    host = {"pack": [], "stage": []}
    copies = []  # (start event, end event, bytes)

    def timed(fn, into):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            host[into].append(time.perf_counter() - t0)
            return r

        return wrapped

    def copy(dst, src):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        saved["_copy_h2d"](dst, src)
        end.record()
        copies.append((start, end, src.nbytes))

    saved = {name: getattr(assemble, name) for name in ("pack_codes", "_stage", "_pack_batch", "_copy_h2d")}
    assemble.pack_codes = timed(saved["pack_codes"], "pack")
    assemble._stage = timed(saved["_stage"], "stage")
    assemble._pack_batch = timed(saved["_pack_batch"], "stage")
    assemble._copy_h2d = copy
    try:
        yield out
    finally:
        for name, fn in saved.items():
            setattr(assemble, name, fn)
        torch.cuda.synchronize()
        out.update(
            pack_s=sum(host["pack"]),
            stage_s=sum(host["stage"]) - sum(host["pack"]),
            h2d_s=sum(s.elapsed_time(e) for s, e, _ in copies) / 1e3,
            h2d_bytes=sum(n for _, _, n in copies),
            batches=len(host["stage"]),
        )


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
    launches = sum(
        a.count for a in prof.key_averages() if a.key in LAUNCH_CALLS
    )
    top = sorted(
        ((a.device_time_total / 1e3, a.key[:120], a.count) for a in prof.key_averages()
         if a.device_time_total > 0),
        reverse=True,
    )[:15]
    return {
        "profiled_wall_s": wall,
        "device_busy_union_s": busy,
        "device_idle_share": 1.0 - busy / wall,
        "n_device_events": len(dev_events),
        "kernel_launches": launches,
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
    from tpu_euler_torch.kmer import extract_kernel as xk

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
            xk.launches = 0
            t0 = time.perf_counter()
            res = run()
            walls.append(time.perf_counter() - t0)
            stages.append(res.stage_seconds)
            launches.append(xk.launches)
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
    ap.add_argument("--transport", choices=("packed", "int8"), default="packed", help="the single-device feed's")
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

    with transport(args.transport):
        return _measure(args, run, genome, cfg, card, sim_s, dev)


def _measure(args, run, genome, cfg, card, sim_s, dev) -> int:
    """Warm-up, the timed repeats, the fine run and the profiled run of
    ``run``; prints (and writes) the record."""
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
    for _ in range(args.repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        walls.append(time.perf_counter() - t0)
        stages.append(res.stage_seconds)
    peak = torch.cuda.max_memory_allocated(dev)

    fine: dict = {}
    with synced_timers(fine), feed_split() as split:
        t0 = time.perf_counter()
        res = run()
        fine_wall = time.perf_counter() - t0
    fine[FEED_PACK], fine[FEED_STAGE] = [split["pack_s"]], [split["stage_s"]]
    fine[FEED_COPY], fine[FEED_BYTES] = [split["h2d_s"]], [split["h2d_bytes"]]
    fine[FEED_WAIT] = [res.stage_seconds["encode"]]

    rec = {
        "card": card,
        "torch": torch.__version__,
        "config": args.config,
        "genome_bp": len(genome),
        "loopback_ranks": args.loopback,
        "shard_traversal": args.shard_traversal,
        "transport": "int8" if args.loopback else args.transport,
        "k": cfg.k,
        "simulation_s": sim_s,
        **({"gate": gate} if gate else {}),
        "walls": walls,
        "stages": stages,
        "peak_gib": peak / 2**30,
        "fine_wall_s": fine_wall,
        "fine_s": {
            k: {"s": sum(v), "calls": len(v), **({"each": v} if 1 < len(v) <= 40 else {})}
            for k, v in fine.items()
        },
        "device": device_profile(run),
    }
    return _emit(rec, args.out)


if __name__ == "__main__":
    sys.exit(main())
