"""The Eulerian tour at bench scale: the twin of ``scripts/bench_tour.py``.

    python -m tpu_euler_torch.bench_tour [--bp 4600000] [--device cuda|cpu] [--out FILE.json]

The input is the reference script's: ``random_genome(bp, seed=2024)``, 50x
error-free 100 bp reads from ``simulate_read_codes(..., seed=2025,
circular=True)`` (the port's simulator, bit-equal to the reference's) and
``AssemblyConfig(k=31, read_batch=2^18, read_len=100, spectrum_capacity=2^23)``;
an input of fewer reads than one batch is counted in one batch of its own
size (the next power of two), which changes no count. At the default 4.6 Mbp
this is SPEC config 2's input, ~9.2 M doubled edges.

Each of two runs, a warm-up and the timed one, counts the reads
(``count_spectrum``, ``right_size_spectrum``), builds the graph as the
command line's ``tour`` does (``apply_cutoff``, ``build_graph``), waits for
the device, and times ``eulerian_tour`` alone. The gate is then checked
outside that time (``gate_s``): every valid edge is in the tour, within each
chain the positions run 0..len-1 (the reference's check), and each edge's
tour successor is the next edge of its chain and starts where it ends
(``walks_follow_edges``). After the timed run the tour runs once more split
into its phases, with a device sync after each: the successor pairing
(``pair_s``), each merge round (``merge_s``) and the cut and ranking
(``cut_rank_s``); its tour must equal the timed one field by field. On the
card a last tour runs under ``torch.profiler`` (``profile``: busy share,
kernel launches, the ops with the most device time).

One JSON line a run, with the reference's keys (``genome_bp``, ``edges``,
``edge_capacity``, ``tour_wall_s``, ``merge_rounds``, ``chains``,
``every_edge_once``, ``run``) and the port's: the gate's parts, the peak
device memory of the count and graph build (``count_and_graph_peak_gib``)
and of the tour alone, the graph resident (``tour_peak_gib``), the split,
and the card's name and power limit. The
exit code is 0 only where the timed run passes the gate. It runs on the card
unless ``--device cpu`` is given, and fails where there is no CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from tpu_euler_torch.config import AssemblyConfig
from tpu_euler_torch.euler.tour import (
    EulerTour,
    _cut_and_rank,
    _log2_ceil,
    _merge_round,
    _pair_successors,
    eulerian_tour,
    merge_limit,
)
from tpu_euler_torch.graph.build import DeBruijnGraph, build_graph
from tpu_euler_torch.kmer import keys
from tpu_euler_torch.kmer.count import apply_cutoff
from tpu_euler_torch.pipeline.assemble import count_spectrum, right_size_spectrum
from tpu_euler_torch.simulate import random_genome, simulate_read_codes

GENOME_BP = 4_600_000
GENOME_SEED, READ_SEED = 2024, 2025
K, READ_LEN, COVERAGE = 31, 100, 50
READ_BATCH, SPECTRUM_CAPACITY = 1 << 18, 1 << 23


def tour_inputs(bp: int = GENOME_BP):
    """(int8 read codes [R, 100], config) of the reference script."""
    genome = random_genome(bp, seed=GENOME_SEED)
    codes = simulate_read_codes(genome, read_len=READ_LEN, coverage=COVERAGE, seed=READ_SEED, circular=True)
    batch = min(READ_BATCH, 1 << (codes.shape[0] - 1).bit_length())
    cfg = AssemblyConfig(k=K, read_batch=batch, read_len=READ_LEN, spectrum_capacity=SPECTRUM_CAPACITY)
    return codes, cfg


def tour_graph(codes, cfg: AssemblyConfig, device) -> DeBruijnGraph:
    """Count, right-size, cut off and build, as the command line's tour."""
    acc, _ = count_spectrum(codes, cfg, device)
    return build_graph(apply_cutoff(right_size_spectrum(acc), cfg.min_count), cfg.k)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def tour_gate(g: DeBruijnGraph, tour: EulerTour) -> dict:
    """``every_edge_once``: the tour holds exactly the valid edges, and
    within each chain the positions run 0..len-1 (scripts/bench_tour.py:66-80,
    on the tour's device); ``walks_follow_edges``: in (chain, pos) order each
    edge's successor is the chain's next edge, whose tail is its head, and
    -1 at the chain's last edge."""
    valid = g.edge_valid
    once = torch.equal(valid, tour.in_tour)
    follows = False
    if once:
        v = torch.nonzero(valid).squeeze(1)
        order = keys.sort(torch.stack([tour.chain[v], tour.pos[v]], dim=1))[1]
        e = v[order]
        n = e.shape[0]
        idx = torch.arange(n, device=e.device)
        starts = torch.ones(n, dtype=torch.bool, device=e.device)
        starts[1:] = tour.chain[e[1:]] != tour.chain[e[:-1]]
        expect = idx - torch.cummax(torch.where(starts, idx, 0), 0).values
        once = torch.equal(tour.pos[e], expect)
        nxt = torch.full_like(e, -1)
        nxt[:-1] = torch.where(starts[1:], -1, e[1:])
        adjacent = (g.head[e[:-1]] == g.tail[e[1:]]) | starts[1:]
        follows = once and torch.equal(tour.succ[e], nxt) and bool(adjacent.all())
    return {"every_edge_once": bool(once), "walks_follow_edges": bool(follows)}


def split_tour(g: DeBruijnGraph, device) -> tuple[EulerTour, dict]:
    """``eulerian_tour`` phase by phase, with a device sync after each:
    (the tour, {"pair_s", "merge_s": [a round's seconds], "cut_rank_s"})."""
    E = g.tail.shape[0]
    rounds = _log2_ceil(E) + 1
    sync(device)
    t0 = time.perf_counter()
    succ = _pair_successors(g)
    sync(device)
    split = {"pair_s": time.perf_counter() - t0, "merge_s": []}
    changed = True
    while changed and len(split["merge_s"]) < merge_limit(E):
        t0 = time.perf_counter()
        succ, changed = _merge_round(g, succ, rounds)
        sync(device)
        split["merge_s"].append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    tour = _cut_and_rank(g, succ, rounds, len(split["merge_s"]))
    sync(device)
    split["cut_rank_s"] = time.perf_counter() - t0
    return tour, split


def same_tour(a: EulerTour, b: EulerTour) -> bool:
    return all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(a, b)
    )


def run(bp: int = GENOME_BP, device="cuda", emit=print) -> list[dict]:
    """The warm-up and the timed run; returns their records."""
    from tpu_euler_torch.profile_config2 import card_line, device_profile

    dev = torch.device("cuda:0" if device == "cuda" else device)
    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    codes, cfg = tour_inputs(bp)
    base = {
        "bench": "eulerian_tour at bench scale (one device)",
        "genome_bp": bp,
        "reads": int(codes.shape[0]),
        "read_batch": cfg.read_batch,
        "simulate_s": time.perf_counter() - t0,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "card": card_line() if on_card else "cpu",
    }
    recs = []
    for name in ("warm", "timed"):
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        g = tour_graph(codes, cfg, dev)
        sync(dev)
        rec = dict(base, count_and_graph_s=time.perf_counter() - t0)
        if on_card:
            rec["count_and_graph_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        tour = eulerian_tour(g)  # n_chains is read on the host: a sync
        sync(dev)
        wall = time.perf_counter() - t0
        if on_card:
            rec["tour_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        t0 = time.perf_counter()
        gate = tour_gate(g, tour)
        rec["gate_s"] = time.perf_counter() - t0
        rec.update(
            edges=int(g.edge_valid.sum()),
            edge_capacity=int(g.edge_valid.shape[0]),
            tour_wall_s=wall,
            merge_rounds=tour.merge_rounds,
            chains=tour.n_chains,
            **gate,
            run=name,
        )
        if name == "timed":
            t0 = time.perf_counter()
            split_t, split = split_tour(g, dev)
            rec.update(split, split_wall_s=time.perf_counter() - t0)
            rec["split_equals_tour"] = same_tour(split_t, tour)
            del split_t
            if on_card:
                prof = device_profile(lambda: eulerian_tour(g))
                rec["profile"] = {**prof, "top_device_ms": prof["top_device_ms"][:8]}
        del g, tour
        emit(json.dumps(rec))
        recs.append(rec)
    return recs


def passed(rec: dict) -> bool:
    return rec["every_edge_once"] and rec["walks_follow_edges"] and rec.get("split_equals_tour", True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bp", type=int, default=GENOME_BP, help="genome length")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default="", help="write the timed run's record here")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_tour: no CUDA device (--device cpu runs on the CPU)")
    rec = run(args.bp, args.device)[-1]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=2)
    return 0 if passed(rec) else 1


if __name__ == "__main__":
    sys.exit(main())
