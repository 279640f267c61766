"""The port's bench entry: the twin of ``bench.py``, the reference's headline
benchmark, run through ``bench_torch.py`` at the repository root.

    python3 bench_torch.py [--config 2|3|4|5|repeat] [--mesh N [--shard-traversal]] [--reps 3]
                           [--seed S] [--genome-bp B] [--device cuda|cpu] [--out F]

``--config 2`` (the default) is ``bench.py`` step by step: SPEC config 2
(a 4.6 Mbp random circular genome, seed 2024; 50x 100 bp reads, seed 2025;
k = 31, batches of 2^18 reads, a spectrum of 2^23), one warm-up run over
the full dataset (the kernels build at first use and the graph arrays are
right-sized from the live key count), then ``--reps`` timed runs of
``assemble_codes`` on the host clock, each after ``gc.collect()``. The
result comes back as host bytes, so the clock stops after the device is
done; each run also records the time to a device sync after the return
(``wall_then_sync_s``), which must not differ. Before each timed run, the
counterparts of the reference's self-diagnosis: a 64 MiB host-to-device and
device-to-host copy probe from pageable and from pinned memory (CUDA
events, MB/s), in place of its relay probe, and the count of new files
under the kernels' build directory during the run, in place of its
compile-cache delta (0 in a timed run: the builds fall in the warm-up).
After the timed runs, one more run under ``torch.profiler`` gives the
device idle share; tracing is off in the timed runs. No result outlives the
next run, and the allocator's cache is kept between runs, as in a user's
repeated runs (no ``torch.cuda.empty_cache()``).

The other configurations are those of scripts/run_configs.py,
scripts/run_full_configs.py and scripts/fullscale_adversarial.py, from the
port's simulator: ``3`` (4.6 Mbp, 40x with 0.4% errors, cutoff 4, three tip
and two bubble rounds), ``4`` (12 Mbp, 60x paired-end), ``5`` (100 Mbp, 40x,
k = 41, grouped counting) and ``repeat`` (the 12 Mbp repeat genome).

The gate (``verify/compare.py``): one contig of G + k - 1 bases that spells
the circular genome on either strand (configs 2, 4, 5), or every contig of
150 bases or more an exact substring of the genome covering 99% of it
(config 3) or the repeat genome's structural floor, with at least two
contigs (``repeat``); and every timed run must give the warm-up's counts
and contigs. A failed gate prints the reference's error shape (``"value":
null`` and ``"error"``) and exits 1.

``--mesh N`` runs the configuration over N ranks, one a GPU over NCCL (or
gloo ranks with ``--device cpu``), through ``dist/launch.py``
``spawn_ranks`` and ``profile_config2.mesh_rank``, with the replicated
traversal or, with ``--shard-traversal``, the sharded one; the codes go to
the ranks as a mapped ``.npy``. A run's wall is its slowest rank's (every
rank waits for the others before each run, and the contigs wait for every
rank); the ranks' start-up is reported apart, the peak is the largest
rank's and the idle share the mean of the ranks' profiled runs. Every rank
must give rank 0's counts and contigs, and rank 0 passes the gate. More ranks than GPUs
exit non-zero before anything is simulated.

``--seed S`` seeds the genome with S and the reads with S + 1; without it
each configuration takes its reference seeds. ``--genome-bp B`` cuts the
genome, for tests on the CPU; a cut run also sizes its batch and spectrum
to its reads and lists every cut under ``detail.reduced``, and its metric
name says the size it ran.

It prints one JSON line on stdout (progress goes to stderr): ``metric``,
``value`` (the best wall in seconds), ``unit`` and ``detail``; ``--out``
writes the same object to a file. It runs on the card unless ``--device
cpu`` is given, and exits non-zero where there is no CUDA device; a kernel
that fails to build or launch fails the run.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import hashlib
import inspect
import json
import os
import statistics
import sys
import tempfile
import time
from typing import Callable

import numpy as np
import torch

from tpu_euler_torch import _build, simulate
from tpu_euler_torch.pipeline import assemble as pipeline
from tpu_euler_torch.verify.compare import check_one_contig, check_substring_gate, same_assembly

PROBE_BYTES = 1 << 26  # the reference's relay probe: 64 MiB


@dataclasses.dataclass(frozen=True)
class Setup:
    """One configuration: its full genome length, its metric name's tail,
    ``inputs(genome_bp, seed)`` (seed None: the reference's seeds) and its
    gate, ``gate(name, contigs, genome, k)``, which raises on a failure."""

    genome_bp: int
    label: str
    inputs: Callable
    gate: Callable


def _substring_gate(circular: bool, floor: Callable, min_contigs: int) -> Callable:
    def gate(name, contigs, genome, k):
        check_substring_gate(name, contigs, genome, circular, floor(len(genome)), min_contigs)

    return gate


def _seeded(default: int, seed: int | None) -> int:
    return default if seed is None else seed


SETUPS = {
    "2": Setup(
        simulate.CONFIG2_GENOME_BP, "50x_k31",
        lambda bp, seed: simulate.config2_inputs(_seeded(simulate.CONFIG2_SEED, seed), bp),
        check_one_contig,
    ),
    "3": Setup(
        simulate.CONFIG3_GENOME_BP, "40x_err_k31",
        lambda bp, seed: simulate.config3_inputs(bp, seed),
        _substring_gate(True, lambda bp: 0.99, 1),
    ),
    "4": Setup(
        simulate.CONFIG4_GENOME_BP, "60x_paired_k31",
        lambda bp, seed: simulate.config4_inputs(bp, seed),
        check_one_contig,
    ),
    "5": Setup(
        simulate.CONFIG5_GENOME_BP, "40x_k41",
        lambda bp, seed: simulate.config5_inputs(bp, _seeded(simulate.CONFIG5_SEED, seed)),
        check_one_contig,
    ),
    "repeat": Setup(
        simulate.ADVERSARIAL_GENOME_BP, "repeat_k31",
        lambda bp, seed: simulate.adversarial_inputs(bp, _seeded(simulate.ADVERSARIAL_SEED, seed)),
        _substring_gate(False, lambda bp: max(0.0, simulate.adversarial_coverage_floor(bp)), 2),
    ),
}


def size_label(bp: int) -> str:
    for unit, scale in (("Mbp", 10**6), ("kbp", 10**3)):
        if bp >= scale:
            return f"{bp / scale:g}{unit}"
    return f"{bp}bp"


def metric_name(config: str, genome_bp: int, world: int, shard_traversal: bool, device: str) -> str:
    """``wall_clock_4.6Mbp_50x_k31_1xH100`` and the like: the size run, the
    configuration, the traversal where sharded, and ranks x device."""
    tail = "_sharded_traversal" if shard_traversal else ""
    return f"wall_clock_{size_label(genome_bp)}_{SETUPS[config].label}{tail}_{world}x{device}"


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def make_inputs(config: str, seed: int | None = None, genome_bp: int = 0, world: int = 1):
    """(genome, [R, read_len] int8 codes, config, reduced) of ``config``.
    ``genome_bp`` (0: the full size) cuts the genome; a cut run's batch
    holds a rank's share of the reads at most and its spectrum the reads'
    windows at most (the next powers of two), which changes no count, and
    ``reduced`` lists every cut (None when nothing was cut)."""
    setup = SETUPS[config]
    bp = genome_bp or setup.genome_bp
    genome, codes, cfg = setup.inputs(bp, seed)
    if bp == setup.genome_bp:
        return genome, codes, cfg, None
    cfg = dataclasses.replace(
        cfg,
        read_batch=min(cfg.read_batch, _pow2_at_least(-(-codes.shape[0] // world))),
        spectrum_capacity=min(cfg.spectrum_capacity, _pow2_at_least(codes.shape[0] * cfg.windows_per_read)),
    )
    return genome, codes, cfg, {
        "genome_bp": bp, "read_batch": cfg.read_batch, "spectrum_capacity": cfg.spectrum_capacity,
    }


def contig_digest(contigs) -> str:
    """sha256 of the sorted canonical contigs, one a line."""
    return hashlib.sha256(b"\n".join(sorted(contigs))).hexdigest()


def build_files() -> int:
    """Files under the kernels' build directory."""
    root = _build.BUILD_DIR
    return sum(1 for p in root.rglob("*") if p.is_file()) if root.exists() else 0


def copy_probe(dev: torch.device) -> dict:
    """MB/s of a 64 MiB copy to the card and back, from pageable and from
    pinned host memory (CUDA events)."""
    pageable = torch.from_numpy(np.arange(PROBE_BYTES, dtype=np.uint8))
    out = {}
    on_card = torch.empty(PROBE_BYTES, dtype=torch.uint8, device=dev)
    for kind, host in (("pageable", pageable), ("pinned", pageable.pin_memory())):
        for way, dst, src in (("h2d", on_card, host), ("d2h", host, on_card)):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
            dst.copy_(src)
            end.record()
            end.synchronize()
            out[f"{way}_{kind}_mb_s"] = PROBE_BYTES / 2**20 / (start.elapsed_time(end) / 1e3)
    del on_card
    return out


def diagnose(dev: torch.device) -> dict:
    """A run's self-diagnosis, taken before it: the copy probe on the card,
    the time, and the build directory's file count."""
    rec = {"utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()), "build_files": build_files()}
    if dev.type == "cuda":
        rec["copy_probe"] = copy_probe(dev)
    return rec


def _stats(walls: list[float]) -> dict:
    mean = sum(walls) / len(walls)
    return {
        "best_of": len(walls),
        "wall_mean_s": mean,
        "wall_sd_s": (sum((w - mean) ** 2 for w in walls) / len(walls)) ** 0.5,
        "wall_median_s": statistics.median(walls),
    }


def _profile(run) -> dict:
    from tpu_euler_torch.profile_config2 import device_profile

    prof = device_profile(run)
    return {**prof, "top_device_ms": prof["top_device_ms"][:8]}


def one_device(genome, codes, cfg, setup: Setup, dev: torch.device, reps: int, emit) -> tuple[dict, object]:
    """The warm-up, the gate, ``reps`` timed runs and, on the card, the
    profiled run of ``assemble_codes``; returns (the detail, the warm-up's
    result). Raises ``AssertionError`` where a gate fails."""
    cuda = dev.type == "cuda"
    files = build_files()
    t0 = time.perf_counter()
    first = pipeline.assemble_codes(codes, cfg, dev)
    warm = {"warmup_s": time.perf_counter() - t0, "warmup_new_build_files": build_files() - files}
    emit(f"warm-up run {warm['warmup_s']:.3f} s, {warm['warmup_new_build_files']} new build files")
    setup.gate("the warm-up run", first.contigs, genome, cfg.k)
    emit("the warm-up run passed the gate")
    runs = []
    for i in range(reps):
        gc.collect()
        diag = diagnose(dev)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = pipeline.assemble_codes(codes, cfg, dev)
        wall = time.perf_counter() - t0
        if cuda:
            torch.cuda.synchronize(dev)
        synced = time.perf_counter() - t0
        launches = res.trace.counters
        if launches["extract_int8_launches"]:
            raise AssertionError(
                f"timed run {i + 1}: the int8 loader launched {launches['extract_int8_launches']} times"
            )
        same_assembly(f"timed run {i + 1}, against the warm-up", res, first)
        runs.append({
            "wall_s": wall,
            "wall_then_sync_s": synced,
            "stages_s": res.stage_seconds,
            "extract_launches": launches["extract_launches"],
            "peak_device_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None,
            "utc": diag["utc"],
            "new_build_files": build_files() - diag["build_files"],
            **({"copy_probe": diag["copy_probe"]} if cuda else {}),
        })
        del res
        emit(f"timed run {i + 1}: wall {wall:.4f} s")
    walls = [r["wall_s"] for r in runs]
    best = runs[walls.index(min(walls))]
    detail = {
        **_stats(walls),
        **warm,
        "runs": runs,
        "transport": "packed",
        "extract_launches": best["extract_launches"],
        "peak_device_gib": max(r["peak_device_gib"] for r in runs) if cuda else None,
        "stages_s": best["stages_s"],
    }
    if cuda:
        prof = _profile(lambda: pipeline.assemble_codes(codes, cfg, dev))
        detail.update(device_idle_share=prof["device_idle_share"], profile=prof)
        emit(f"profiled run: device idle share {prof['device_idle_share']:.4f}")
    else:
        detail["device_idle_share"] = None
    return detail, first


def mesh(genome, codes, cfg, setup: Setup, args, emit) -> tuple[dict, object]:
    """The configuration over ``args.mesh`` ranks; returns (the detail,
    rank 0's last timed result). Raises ``AssertionError`` where a rank
    differs from rank 0 or rank 0 fails the gate."""
    from tpu_euler_torch.dist.launch import spawn_ranks
    from tpu_euler_torch.dist.pipeline import assemble_reads_distributed
    from tpu_euler_torch.profile_config2 import mesh_rank

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "codes.npy")
        np.save(path, codes)
        spawned = time.time()
        t0 = time.perf_counter()
        ranks = spawn_ranks(
            args.mesh, args.device, mesh_rank, (path, cfg, args.shard_traversal, args.reps, diagnose),
            timeout_s=3000.0,
        )
        joined = time.perf_counter() - t0
        after = build_files()
    emit(f"{args.mesh} ranks started, ran and joined in {joined:.2f} s")
    first = ranks[0]["result"]
    for rk in ranks:
        same_assembly(f"rank {rk['rank']}, against rank 0", rk.pop("result"), first)
    setup.gate("rank 0", first.contigs, genome, cfg.k)

    runs = []
    for i in range(args.reps):
        ends = [rk["diagnoses"][i + 1]["build_files"] if i + 1 < args.reps else after for rk in ranks]
        rank_walls = [rk["walls"][i] for rk in ranks]
        diag = ranks[0]["diagnoses"][i]
        runs.append({
            "wall_s": max(rank_walls),
            "rank_walls_s": rank_walls,
            "stages_s": ranks[0]["stages"][i],
            "extract_launches_a_rank": [rk["launches"][i] for rk in ranks],
            "utc": diag["utc"],
            "new_build_files": max(e - rk["diagnoses"][i]["build_files"] for e, rk in zip(ends, ranks)),
            **({"copy_probe_rank0": diag["copy_probe"]} if "copy_probe" in diag else {}),
        })
    walls = [r["wall_s"] for r in runs]
    best = runs[walls.index(min(walls))]
    cuda = args.device == "cuda"
    detail = {
        **_stats(walls),
        "runs": runs,
        "transport": "int8",
        "extract_launches": best["extract_launches_a_rank"][0],
        "peak_device_gib": max(rk["peak_gib"] for rk in ranks) if cuda else None,
        "device_idle_share": statistics.mean(rk["device"]["device_idle_share"] for rk in ranks) if cuda else None,
        "stages_s": best["stages_s"],
        "ranks_start_to_join_s": joined,
        "ranks": [
            {
                "rank": rk["rank"],
                "startup_s": rk["started_unix_s"] - spawned,
                "walls_s": rk["walls"],
                "peak_device_gib": rk["peak_gib"],
                **({"device_idle_share": rk["device"]["device_idle_share"],
                    "profiled_wall_s": rk["device"]["profiled_wall_s"],
                    "kernel_launches": rk["device"]["kernel_launches"]} if cuda else {}),
            }
            for rk in ranks
        ],
    }
    if args.shard_traversal:
        # each run retries alike, so a run's retries are the total over the
        # warm-up, the timed runs and the profiled one over their number
        factors = inspect.signature(assemble_reads_distributed).parameters["slab_factors"].default
        retries = len(ranks[0]["retries"]) // (args.reps + 1 + cuda)
        detail.update(slab_retries_a_run=retries, slab_factor_held=factors[retries])
    return detail, first


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=sorted(SETUPS), default="2")
    ap.add_argument("--mesh", type=int, default=0, help="ranks, one a GPU (NCCL; gloo with --device cpu)")
    ap.add_argument("--shard-traversal", action="store_true", help="with --mesh: keep the traversal sharded")
    ap.add_argument("--reps", type=int, default=3, help="timed runs after the warm-up")
    ap.add_argument("--seed", type=int, default=None, help="genome seed S, read seed S + 1")
    ap.add_argument("--genome-bp", type=int, default=0, help="cut the genome to this many bases (CPU tests)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default="", help="write the JSON object here too")
    args = ap.parse_args(argv)
    if args.reps < 1:
        ap.error("--reps must be at least 1")
    if args.shard_traversal and not args.mesh:
        ap.error("--shard-traversal needs --mesh N")
    if args.mesh < 0:
        ap.error("--mesh takes a number of ranks")
    if not 0 <= args.genome_bp < SETUPS[args.config].genome_bp:
        ap.error(f"--genome-bp cuts config {args.config}'s {SETUPS[args.config].genome_bp} bases")
    return args


def main(argv=None) -> int:
    args = _parse(argv)
    world = args.mesh or 1
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bench: no CUDA device (--device cpu runs on the CPU)")
        if torch.cuda.device_count() < world:
            raise SystemExit(f"bench: --mesh {world} needs {world} GPUs, {torch.cuda.device_count()} visible")
    start = time.perf_counter()

    def emit(line):
        print(f"bench [{time.perf_counter() - start:.2f} s]: {line}", file=sys.stderr, flush=True)

    setup = SETUPS[args.config]
    dev = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    head = {"device": "cpu"}
    if dev.type == "cuda":
        from tpu_euler_torch.profile_config2 import card_line

        torch.cuda.init()
        name = torch.cuda.get_device_name(dev)
        head = {"device": name, "card": card_line()}
    tag = "cpu" if dev.type == "cpu" else ("H100" if "H100" in head["device"] else "GPU")

    t0 = time.perf_counter()
    genome, codes, cfg, reduced = make_inputs(args.config, args.seed, args.genome_bp, world)
    sim_s = time.perf_counter() - t0
    emit(f"config {args.config}: simulated {len(genome)} bp, {codes.shape[0]} reads in {sim_s:.2f} s; {cfg}")
    metric = metric_name(args.config, len(genome), world, args.shard_traversal, tag)
    try:
        # the gates print what passed: that is progress, for stderr
        with contextlib.redirect_stdout(sys.stderr):
            if args.mesh:
                detail, res = mesh(genome, codes, cfg, setup, args, emit)
            else:
                detail, res = one_device(genome, codes, cfg, setup, dev, args.reps, emit)
    except AssertionError as e:
        return _emit({"metric": metric, "value": None, "unit": "s", "error": f"correctness gate failed: {e}"}, args.out)
    wall = min(r["wall_s"] for r in detail["runs"])
    rec = {
        "metric": metric,
        "value": wall,
        "unit": "s",
        "detail": {
            **head,
            "torch": torch.__version__,
            "config": args.config,
            "genome_bp": len(genome),
            "k": cfg.k,
            "seed": args.seed,
            "ranks": world,
            "shard_traversal": args.shard_traversal,
            **({"reduced": reduced} if reduced else {}),
            "simulation_s": sim_s,
            "between_runs": "gc.collect(); every result dropped before the next run; the allocator's cache kept "
                            "(no torch.cuda.empty_cache())",
            **detail,
            "reads": res.n_reads,
            "kmers_counted": res.n_kmers_counted,
            "distinct_kmers": res.n_distinct_kmers,
            "contigs": len(res.contigs),
            "contig_bases": sum(len(c) for c in res.contigs),
            "contigs_sha256": contig_digest(res.contigs),
            # a CPU run's rate is no GPU's
            f"kmers_per_s_per_{'gpu' if dev.type == 'cuda' else 'cpu_rank'}": res.n_kmers_counted / wall / world,
            "reads_per_s": res.n_reads / wall,
        },
    }
    return _emit(rec, args.out)


def _emit(rec: dict, out: str) -> int:
    """Print the record as one line (and write it to ``out`` where given);
    0 where it holds a value, 1 where the gate failed."""
    line = json.dumps(rec)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0 if rec["value"] is not None else 1


if __name__ == "__main__":
    sys.exit(main())
