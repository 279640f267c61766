"""Weak scaling of the sharded mode: the twin of ``scripts/bench_scaling.py``.

    python -m tpu_euler_torch.bench_scaling [--worlds 1,2,4] [--loopback 2,4] [--out FILE.json]
    python -m tpu_euler_torch.bench_scaling --device cpu --worlds 1,2 --loopback 2 --reads-per-rank 256 --genome-per-rank 3000

The load a rank is fixed while the ranks grow, and two steps are timed:

* the count step (``dist_count_step``): one batch of ``--reads-per-rank``
  reads a rank (default the config-2 batch, 2^18 reads of 100 bases,
  k = 31): extract kernel, hash, owner grouping, all-to-all, and the merge
  into the rank's spectrum shard;
* the traversal step (``dist_chains_step``): the chains of the sharded
  spectrum of a circular genome of ``--genome-per-rank`` bases a rank
  (default 3 Mbp) read at 50x: node-record exchange, cycle detection and
  the two Wyllie passes. Its rounds grow as log2 of the global edge count,
  one more for each doubling of the ranks; the row gives that bound.

Rows: process ranks started by ``spawn_ranks`` (one rank a GPU over NCCL on
``cuda``, gloo processes on ``cpu``) at each world size up to the device
count, and ranks that this process holds on one device (``LoopbackComm``,
``--loopback``). Loopback ranks timeshare their device: those rows measure
the exchange's cost on one card, not an efficiency. Each time is the median
of five reps after a warm-up, with the min and max; a rep is timed on every
rank from a barrier to a device sync and counts as its slowest rank's.
Weak efficiency is t(1) / t(n) over the process rows, against the world-1
row. Rates are per device: reads and valid k-mer windows a second of the
count step, doubled edges a second of the traversal step. Every row reports
the keys dropped in the count exchange and the records and requests dropped
in the traversal's slabs; a row that dropped any fails the run, after it is
printed.

It runs on the card unless ``--device cpu`` is given; it prints each row
as JSON and writes the record to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

READ_LEN = 100
K = 31
COVERAGE = 50
READS_PER_RANK = 1 << 18  # the config-2 batch
GENOME_PER_RANK = 3_000_000
REPS = 5


def shard_rows(genome_per_rank: int) -> int:
    """Spectrum rows a rank: the power of two at or above 1.25 x its share
    of distinct k-mers (about one a genome base)."""
    return 1 << (int(1.25 * genome_per_rank) - 1).bit_length()


def make_inputs(world: int, reads_per_rank: int, genome_per_rank: int, seed: int = 2026):
    """(count codes [world * reads_per_rank, READ_LEN] int8, traversal codes):
    the reads at ``COVERAGE`` x of a circular genome of ``genome_per_rank *
    world`` bases, and the first ``world`` batches of them (tiled where they
    are too few) for the count step."""
    from tpu_euler_torch.simulate import random_genome, simulate_read_codes

    genome = random_genome(genome_per_rank * world, seed=seed + world)
    codes = simulate_read_codes(genome, READ_LEN, COVERAGE, seed=seed + 100 + world, circular=True)
    need = reads_per_rank * world
    count = np.tile(codes, (-(-need // codes.shape[0]), 1))[:need]
    return np.ascontiguousarray(count), codes


def _batch(codes: np.ndarray, b: int, rows: int, device) -> torch.Tensor:
    """Batch ``b`` of ``rows`` reads on ``device``, padded with code 4."""
    out = np.full((rows, codes.shape[1]), 4, np.int8)
    part = codes[b * rows : (b + 1) * rows]
    out[: part.shape[0]] = part
    return torch.from_numpy(out).to(device)


def _timed(comm, fn, reps: int):
    """``fn()`` once to warm up, then ``reps`` times, each from a barrier (an
    all-reduce) to a device sync. Returns (each rep's seconds on its slowest
    rank, the last output)."""
    from tpu_euler_torch.pipeline.assemble import _finish

    out = fn()
    mine = []
    for _ in range(reps):
        comm.all_reduce_sum([torch.zeros(1, dtype=torch.int64, device=comm.device) for _ in comm.ranks])
        _finish(comm.device)
        t0 = time.perf_counter()
        out = fn()
        _finish(comm.device)
        mine.append(time.perf_counter() - t0)
    every = comm.process_allgather([round(t * 1e9) for t in mine])  # [processes, reps] ns
    return [float(x) / 1e9 for x in every.max(axis=0)], out


def scaling_rank(comm, count_path: str, trav_path: str, reads_per_rank: int, c_rank: int, reps: int) -> dict:
    """Both timed steps on the ranks of ``comm`` (a ``spawn_ranks`` target,
    or called with a ``LoopbackComm``). The codes are mapped from the
    ``.npy`` files. Returns the same dict on every process."""
    from tpu_euler_torch.dist.count_dist import dist_count_step, empty_dist_spectrum
    from tpu_euler_torch.dist.traverse_dist import _log2_ceil, _sum_over_ranks, dist_chains_step, dist_cutoff_step

    def total(per_rank: list) -> int:  # over all ranks, the same on every rank
        return _sum_over_ranks(comm, per_rank)[0]

    world, dev, R = comm.world, comm.device, reads_per_rank
    c_dest = int(2.0 * R * (READ_LEN - K + 1) / world + 256)  # the pipeline's send slab rows

    count_codes = np.load(count_path, mmap_mode="r")
    batch = [_batch(count_codes, r, R, dev) for r in comm.ranks]
    acc = empty_dist_spectrum(comm, c_rank, K)
    count_s, (_, n_valid) = _timed(comm, lambda: dist_count_step(batch, acc, comm, K, c_dest), reps)
    windows = total(n_valid)
    count_dropped = total(acc.dropped)
    del batch, acc

    trav_codes = np.load(trav_path, mmap_mode="r")
    acc = empty_dist_spectrum(comm, c_rank, K)
    for s in range(-(-trav_codes.shape[0] // (R * world))):
        step = [_batch(trav_codes, s * world + r, R, dev) for r in comm.ranks]
        acc, _ = dist_count_step(step, acc, comm, K, c_dest)
    count_dropped += total(acc.dropped)
    words, _, n = dist_cutoff_step(acc.words, acc.counts, acc.n, 1)
    del acc
    trav_s, sc = _timed(comm, lambda: dist_chains_step(words, n, comm, K, c_rank), reps)
    edges = 2 * total([torch.tensor(nj, device=dev) for nj in n])
    return {
        "count_s": count_s,
        "count_windows": windows,
        "traverse_s": trav_s,
        "traverse_edges": edges,
        "traverse_rounds_max": _log2_ceil(world * 2 * c_rank) + 1,
        "count_dropped": count_dropped,
        "slab_dropped": total(sc.dropped),
    }


def _median(ts: list) -> float:
    s = sorted(ts)
    return s[len(s) // 2]


def _row(mode: str, world: int, devices: int, got: dict, reads_per_rank: int) -> dict:
    tc, tt = _median(got["count_s"]), _median(got["traverse_s"])
    return {
        "mode": mode,
        "world": world,
        "devices": devices,
        "count_step_s": tc,
        "count_spread_s": [min(got["count_s"]), max(got["count_s"])],
        "count_reads_per_s_per_device": reads_per_rank * world / tc / devices,
        "count_kmers_per_s_per_device": got["count_windows"] / tc / devices,
        "traverse_step_s": tt,
        "traverse_spread_s": [min(got["traverse_s"]), max(got["traverse_s"])],
        "traverse_edges_total": got["traverse_edges"],
        "traverse_edges_per_s_per_device": got["traverse_edges"] / tt / devices,
        "traverse_rounds_max": got["traverse_rounds_max"],
        "count_dropped": got["count_dropped"],
        "slab_dropped": got["slab_dropped"],
    }


def run(
    device: str = "cuda", worlds=(1, 2, 4), loopback=(2, 4), reads_per_rank: int = READS_PER_RANK,
    genome_per_rank: int = GENOME_PER_RANK, reps: int = REPS, timeout_s: float = 900.0, threads: int = 0,
    emit=print,
) -> dict:
    """The rows at every world size of ``worlds`` (process ranks) and of
    ``loopback`` (ranks held here, on one device). On ``cuda`` a world
    larger than the GPU count is left out and says so. Returns the record;
    raises after the rows if any row dropped keys, records or requests."""
    from tpu_euler_torch.dist.launch import spawn_ranks
    from tpu_euler_torch.dist.mesh import LoopbackComm

    dev = torch.device(device if device != "cuda" else "cuda:0")
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else None
    c_rank = shard_rows(genome_per_rank)
    rec = {
        "device": device,
        "devices_visible": n_dev,
        "host_cores": os.cpu_count(),
        "per_rank_load": {
            "count_reads": reads_per_rank,
            "count_windows": reads_per_rank * (READ_LEN - K + 1),
            "traverse_genome_bp": genome_per_rank,
            "coverage": COVERAGE,
            "k": K,
            "spectrum_rows": c_rank,
        },
        "reps": reps,
        "note": (
            "median of the reps after a warm-up, min and max beside it; a rep is its slowest rank's; "
            "weak efficiency t(1)/t(n) over process rows only: loopback ranks timeshare one device"
        ),
        "rows": [],
        "skipped": [],
    }
    mode = "nccl" if dev.type == "cuda" else "gloo"
    base = None
    with tempfile.TemporaryDirectory() as d:
        paths: dict = {}

        def inputs(world):
            if world not in paths:
                count, trav = make_inputs(world, reads_per_rank, genome_per_rank)
                paths[world] = (os.path.join(d, f"count{world}.npy"), os.path.join(d, f"trav{world}.npy"))
                np.save(paths[world][0], count)
                np.save(paths[world][1], trav)
            return paths[world]

        args = lambda world: (*inputs(world), reads_per_rank, c_rank, reps)  # noqa: E731
        for world in worlds:
            if n_dev is not None and world > n_dev:
                why = f"{mode} world {world} not run: {n_dev} GPU(s) visible"
                rec["skipped"].append(why)
                emit(why)
                continue
            got = spawn_ranks(world, dev.type, scaling_rank, args(world), timeout_s=timeout_s, threads=threads)[0]
            row = _row(mode, world, world, got, reads_per_rank)
            if world == 1:
                base = row
            if base is not None:
                row["count_weak_eff"] = base["count_step_s"] / row["count_step_s"]
                row["traverse_weak_eff"] = base["traverse_step_s"] / row["traverse_step_s"]
            rec["rows"].append(row)
            emit(json.dumps(row))
        for world in loopback:
            got = scaling_rank(LoopbackComm(world, dev), *args(world))
            row = _row("loopback", world, 1, got, reads_per_rank)
            row["label"] = f"{world} ranks timeshare one device: the exchange's cost there, not a weak-scaling efficiency"
            rec["rows"].append(row)
            emit(json.dumps(row))
    bad = [r for r in rec["rows"] if r["count_dropped"] or r["slab_dropped"]]
    if bad:
        raise RuntimeError(f"rows dropped keys or slab records: {[(r['mode'], r['world']) for r in bad]}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--worlds", default="1,2,4", help="world sizes of process ranks")
    ap.add_argument("--loopback", default="2,4", help="world sizes of ranks held on one device ('' for none)")
    ap.add_argument("--reads-per-rank", type=int, default=READS_PER_RANK)
    ap.add_argument("--genome-per-rank", type=int, default=GENOME_PER_RANK)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_scaling: no CUDA device (--device cpu runs on the CPU)")
    sizes = lambda s: tuple(int(x) for x in s.split(",") if x)  # noqa: E731
    rec = {}
    if args.device == "cuda":
        rec["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()
        print(rec["card"][0])
    rec["torch"] = torch.__version__
    rec.update(run(
        args.device, sizes(args.worlds), sizes(args.loopback), args.reads_per_rank, args.genome_per_rank,
    ))
    text = json.dumps(rec, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
