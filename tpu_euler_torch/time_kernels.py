"""Times of the batch-size kernels, the feed's copies and config 5 on one
CUDA card, for comparing two trees or two versions of the sources in one
session.

    python3 tpu_euler_torch/time_kernels.py [--tree DIR] [--csrc DIR] [--check]
                                            [--feed] [--config5 N] [--exchange] [--gather]
                                            [--walk [--walk-bp N | --walk-config5] [--walk-labels-only]]

Run as a file from the repository root. ``--tree DIR`` imports
``tpu_euler_torch`` from another checkout (an archive of the parent commit,
say), so parent and change can be timed in turns on one card. ``--csrc DIR``
builds the kernels from a copy of ``csrc/`` (a variant edited by hand: stores
only, no code-4 test, ...) with this tree's wrappers.

It prints one JSON line: the card; ms per launch (CUDA events, 20 launches
after 3) of ``extract_fill`` at k = 31, 41, 63 and of ``probes.extract_stages``
at k = 31, 41 on the config-2 batch (2^18 reads x 100 codes), each beside
``fill_`` of its output, the least a kernel that only writes could take.
``--check`` first holds both kernels against their plain versions (100- and
107-base reads, a batch that does not fill its last tile, odd and even
``start``, a view of the codes that is not 16-byte aligned). ``--feed``
times one 26 MB batch to the card: pageable ``.to``, numpy and torch copies
into pinned memory, the pinned copy, and allocating a pinned batch.
``--config5 N`` runs SPEC config 5 N times and lists each run's wall and
stage timers (the first run is the warm-up). ``--exchange`` times one rank's
half of a sharded step before the all-to-all, at the config-4 batch (2^18
reads, k = 31, four ranks): ``local_send`` whole, then its parts (the owner
hash, the owner's stable sort as int64 and as a narrow type, an owner
group's first row by ``searchsorted`` and by ``scatter_reduce_`` "amin",
``owner_slots`` whole, the slab scatter) and a loopback all-to-all of four
slabs. ``--gather`` times one request/reply gather of the sharded traversal
at SPEC config 4's shape over four loopback ranks (2^24 edge rows a rank, 6 M
of them with a pointer to a random edge, request slabs of 4 x 8,388,864 rows,
state rows of two and of three int64): ``exchange_gather`` whole, a rank's
request slots, a rank's serving of the slab it received (over every slab row,
over the rows that hold a request only, and those a column at a time), and
the reply rows' way back. ``--walk`` times the ruling walk and the pointer
jumps on config 2's graph at k = 31 (``bench_tour``'s count and build;
``--walk-bp`` sets another genome length; ``--walk-config5`` takes SPEC
config 5's reads and config, k = 41): the walk kernel's device time in
every round of one cycle walk (``torch.profiler``'s events of
``walk_round_kernel``, after a warm-up walk); a doubling of each kind at
the contracted list's size and at E, as one call after a sync, and one
round of it enqueued alone against the mean of 50 back to back; the whole
walk's cycle and rank phases (synced host clock, median of 3) and the
device memory it takes above what it is given (peak); the tour's label
kernels on the same graph's paired successors (``_pair_successors``), the
doubling (``jump_labels``) and the ruling set (``ruling_labels``, where the
tree has it): each held once against the plain version, then one call
alone and its peak above its inputs; the doubling's mean a round and one
round alone; the ruling set at 1 in 8, 16, 32 and 64 ids sampled, each with
its rulers, longest sublist and phases by the card's clock; the plain
version on the card (in a parent tree without a kernel, the tour's own
``_labels``); and ``ptxas``'s report of the walk library.
``--walk-labels-only`` stops after the label kernels. Fails where there is
no CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

KS_EXTRACT = (31, 41, 63)
KS_STAGES = (31, 41)
KS_CHECKED = (3, 21, 31, 33, 41, 61, 63, 75, 95)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def alone_ms(fn, reset=lambda: None, iters: int = 5, warmup: int = 1) -> float:
    """Mean device time of ``fn`` in ms, each call enqueued alone after a
    sync (CUDA events around it), with ``reset()`` (not timed) before each."""
    total = 0.0
    for i in range(warmup + iters):
        reset()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i >= warmup:
            total += start.elapsed_time(end)
    return total / iters


def _one_jump_round(rk, kind: str, state: tuple, outs: tuple) -> None:
    """One doubling round, in either tree's API."""
    if hasattr(rk, "jump_min_round"):
        (rk.jump_min_round if kind == "min" else rk.jump_rank_round)(*state, *outs)
    else:
        (rk.jump_min if kind == "min" else rk.jump_rank)(*state, 1)


def peak_above(fn) -> float:
    """GiB that ``fn()`` takes on the card above what is allocated before
    it, its outputs included."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    del out
    return (torch.cuda.max_memory_allocated() - held) / 2**30


def time_labels(rk, g, strides=(8, 16, 32, 64)) -> dict:
    """The ``--walk`` section's label kernels on graph ``g`` (the module's
    note)."""
    from tpu_euler_torch.euler import tour

    succ, valid = tour._pair_successors(g), g.edge_valid
    E = succ.shape[0]
    rounds = tour._log2_ceil(E) + 1
    out = {"E": E, "rounds": rounds, "bytes": 18 * E, "bound_ms": 18 * E / 3.35e12 * 1e3}
    if not hasattr(rk, "jump_labels"):
        out["plain_ms"] = alone_ms(lambda: tour._labels(succ, valid, rounds), iters=3)
        return out
    want = rk.jump_labels_plain(succ, valid, rounds)
    kernels = {"doubling": lambda: rk.jump_labels(succ, valid, rounds)}
    if hasattr(rk, "ruling_labels"):
        kernels["ruling"] = lambda: rk.ruling_labels(succ, valid, rounds)
    for name, fn in kernels.items():
        got = fn()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"the {name} label kernel != its plain version")
        del got
        out[name] = {"ms": alone_ms(fn), "peak_above_inputs_gib": peak_above(fn)}
    out["doubling"].update(ms_a_round=out["doubling"]["ms"] / rounds,
                           one_round_alone_ms=alone_ms(lambda: rk.jump_labels(succ, valid, 1), iters=10))
    if "ruling" in kernels:
        out["ruling"]["stride"] = rk.label_stride(E)
        saved = rk.LABEL_RULER_STRIDE
        try:
            for stride in strides:
                rk.LABEL_RULER_STRIDE = stride
                row = {"ms": alone_ms(kernels["ruling"])}  # CUDA events; the stats add the card's own stamps
                kernels["ruling"]()
                row.update(rk.label_stats())
                out["ruling"][f"stride_{stride}"] = row
        finally:
            rk.LABEL_RULER_STRIDE = saved
    out["plain_ms"] = alone_ms(lambda: rk.jump_labels_plain(succ, valid, rounds), iters=3)
    return out


WALK_KERNEL = "walk_round_kernel"  # the walk's device function (csrc/ruling_walk.cu)


def time_walk(dev, bp: int = 4_600_000, config5: bool = False, labels_only: bool = False) -> dict:
    """The ``--walk`` section (the module's note), on ``bench_tour``'s
    graph of a ``bp``-base genome, or on SPEC config 5's graph; its label
    kernels alone with ``labels_only``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_euler_torch import _build, microbench
    from tpu_euler_torch.euler import ranking
    from tpu_euler_torch.euler import ranking_kernel as rk
    from tpu_euler_torch.euler.unitigs import _apply_cut

    rk.build()
    out = {"ptxas": [line.strip() for line in _build.build_info["ruling_walk"]["log"].splitlines()
                     if "registers" in line or "spill" in line or "Compiling entry" in line]}
    from tpu_euler_torch.bench_tour import tour_graph, tour_inputs
    from tpu_euler_torch.euler.unitigs import successor, transition_keys

    b = microbench.Bench("cuda")
    if config5:
        from tpu_euler_torch.simulate import config5_inputs

        _, codes, cfg = config5_inputs()
    else:
        codes, cfg = tour_inputs(bp)
        cfg = dataclasses.replace(cfg, spectrum_capacity=max(cfg.spectrum_capacity, 1 << (2 * bp).bit_length()))
    g = tour_graph(codes, cfg, dev)
    del codes
    out["labels"] = time_labels(rk, g)
    if labels_only:
        return out
    succ0, valid = successor(g), g.edge_valid
    t = transition_keys(g, succ0, cfg.k)
    del g
    E = succ0.shape[0]
    out.update(E=E, k=cfg.k)
    res = ranking.cycle_min_ruling_tables(succ0, valid, t)  # warm-up
    del res
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = ranking.cycle_min_ruling_tables(succ0, valid, t)
        torch.cuda.synchronize()
    rounds = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == DeviceType.CUDA and WALK_KERNEL in e.name
    )
    out["cycle_walk_rounds"] = [{"kernel_ms": (b - a) / 1e3} for a, b in rounds]
    out["cycle_walk_kernel_ms"] = sum(r["kernel_ms"] for r in out["cycle_walk_rounds"])

    on_cycle, cyc_min, owner_off, tabs, succ_c = res
    cut, _ = _apply_cut(succ0, t, on_cycle, cyc_min)
    q_of = lambda s: torch.where(s >= 0, s, torch.arange(s.shape[0], device=dev))  # noqa: E731
    states = {
        "min_S": ("min", (succ_c, tabs["mmin"])),
        "rank_S": ("rank", (succ_c, tabs["hops"], q_of(succ_c))),
        "min_E": ("min", (succ0, t)),
        "rank_E": ("rank", (cut, (cut >= 0).long(), q_of(cut))),
    }
    for name, (kind, state) in states.items():
        n = state[0].shape[0]
        n_rounds = ranking._log2_ceil(n) + 1
        doubling = rk.jump_min if kind == "min" else rk.jump_rank
        outs = tuple(torch.empty_like(x) for x in state)
        out["jump_" + name] = {
            "n": n, "rounds": n_rounds,
            "doubling_ms": alone_ms(lambda: doubling(*state, n_rounds)),
            "one_round_alone_ms": alone_ms(lambda: _one_jump_round(rk, kind, state, outs), iters=10),
            "one_round_mean_of_50_ms": cuda_ms(lambda: _one_jump_round(rk, kind, state, outs), iters=50),
        }
    del res, on_cycle, cyc_min, owner_off, tabs, succ_c, cut, states

    try:
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        microbench.walk_once(b, succ0, valid, t)  # warm-up
        out["whole_walk_peak_above_inputs_gib"] = (torch.cuda.max_memory_allocated() - held) / 2**30
        runs = sorted(microbench.walk_once(b, succ0, valid, t)[:2] for _ in range(3))
    except RuntimeError as e:  # a --csrc variant that does not walk right (stores cut out, say)
        out["whole_walk_error"] = str(e)
        return out
    out["whole_walk_cycle_ms"] = sorted(r[0] for r in runs)[1] * 1e3
    out["whole_walk_rank_ms"] = sorted(r[1] for r in runs)[1] * 1e3
    return out


def check(dev, batch) -> None:
    """Both kernels bit for bit against their plain versions."""
    from tpu_euler_torch import probes
    from tpu_euler_torch.kmer import extract_kernel as xk
    from tpu_euler_torch.kmer import keys

    rng = np.random.default_rng(1)
    small = rng.integers(0, 5, (301, 100)).astype(np.int8)
    small[7] = 4
    odd = rng.integers(0, 5, (77, 107)).astype(np.int8)

    def held(codes, k, start):
        W = codes.shape[1] - k + 1
        a = torch.full((start + codes.shape[0] * W + 5,) + keys.word_shape(k), -7, dtype=torch.int64, device=dev)
        b = a.clone()
        na, nb = xk.extract_fill(codes, a, start, k), xk.extract_fill_plain(codes, b, start, k)
        torch.cuda.synchronize()
        if not torch.equal(a, b) or int(na) != int(nb):
            raise AssertionError(f"extract kernel != plain: k={k}, {tuple(codes.shape)}, start {start}")

    for k in KS_CHECKED:
        for arr in (small, odd, batch):
            codes = torch.from_numpy(arr).to(dev)
            held(codes, k, 37)
            held(codes, k, 16)
            held(codes[3:], k, 0)
            if keys.nwords(k) <= 2 and not torch.equal(probes.extract_stages(codes, k), probes.extract_stages_plain(codes, k)):
                raise AssertionError(f"extract_stages kernel != plain: k={k}, {tuple(arr.shape)}")


def time_feed(dev, n: int = 1 << 18) -> dict:
    src = np.random.default_rng(0).integers(0, 5, (16 * n, 100)).astype(np.int8)  # 420 MB: past the CPU's caches
    t0 = time.perf_counter()
    pinned = torch.empty((n, 100), dtype=torch.int8, pin_memory=True)
    out = {"pin_alloc_ms": (time.perf_counter() - t0) * 1e3, "torch_threads": torch.get_num_threads()}
    on_card = torch.empty((n, 100), dtype=torch.int8, device=dev)

    def host_ms(fn, iters=16):
        fn(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e3

    def part(i):
        return src[(i % 16) * n : (i % 16 + 1) * n]

    out["pageable_to_ms"] = host_ms(lambda i: torch.from_numpy(part(i)).to(dev))
    out["numpy_into_pinned_ms"] = host_ms(lambda i: np.copyto(pinned.numpy(), part(i)))
    out["torch_into_pinned_ms"] = host_ms(lambda i: pinned.copy_(torch.from_numpy(part(i))))
    out["pinned_h2d_ms"] = host_ms(lambda i: on_card.copy_(pinned, non_blocking=True))
    return out


def time_config5(dev, runs: int) -> list[dict]:
    from tpu_euler_torch.pipeline.assemble import assemble_codes
    from tpu_euler_torch.simulate import config5_inputs

    genome, codes, cfg = config5_inputs()
    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = assemble_codes(codes, cfg, dev)
        wall = time.perf_counter() - t0
        if len(res.contigs) != 1 or len(next(iter(res.contigs))) != len(genome) + cfg.k - 1:
            raise AssertionError("config 5: expected one contig of G + k - 1 bases")
        out.append({"wall_s": wall, **res.stage_seconds})
    return out


def time_exchange(dev, codes, k: int = 31, world: int = 4) -> dict:
    from tpu_euler_torch.dist import count_dist
    from tpu_euler_torch.dist.exchange import owner_slots
    from tpu_euler_torch.dist.mesh import LoopbackComm
    from tpu_euler_torch.kmer import keys
    from tpu_euler_torch.kmer.extract_kernel import extract_fill

    n = codes.shape[0] * (codes.shape[1] - k + 1)
    c_dest = int(2.0 * n / world + 256)
    words = torch.empty((n,) + keys.word_shape(k), dtype=torch.int64, device=dev)
    extract_fill(codes, words, 0, k)

    def owner_of():
        return torch.where(keys.is_valid(words), keys.bucket_hash(words, keys.nlimbs(k)) % world, world)

    owner = owner_of()
    so, _ = torch.sort(owner, stable=True)
    idx = torch.arange(n, device=dev)
    send, _ = count_dist._group_by_owner(words, owner, world, c_dest)
    sends = [send] * world
    comm = LoopbackComm(world, dev)
    out = {
        "rows": n, "world": world, "c_dest": c_dest,
        "local_send_ms": cuda_ms(lambda: count_dist.local_send(codes, k, world, c_dest), iters=10),
        "owner_hash_ms": cuda_ms(owner_of, iters=10),
        "owner_sort_int64_ms": cuda_ms(lambda: torch.sort(owner, stable=True), iters=10),
        "owner_sort_uint8_ms": cuda_ms(lambda: torch.sort(owner.to(torch.uint8), stable=True), iters=10),
        "segment_starts_searchsorted_ms": cuda_ms(
            lambda: torch.searchsorted(so, torch.arange(world + 1, device=dev)), iters=10
        ),
        "segment_starts_scatter_amin_ms": cuda_ms(
            lambda: torch.full((world + 1,), n, dtype=torch.int64, device=dev).scatter_reduce_(0, so, idx, "amin"), iters=5
        ),
        "owner_slots_ms": cuda_ms(lambda: owner_slots(owner, world, c_dest), iters=10),
        "group_by_owner_ms": cuda_ms(lambda: count_dist._group_by_owner(words, owner, world, c_dest), iters=10),
        "loopback_all_to_all_ms": cuda_ms(lambda: comm.all_to_all(sends), iters=10),
    }
    return out


def time_gather(dev, world: int = 4, c_local: int = 1 << 23, n_valid: int = 6_000_000) -> dict:
    from tpu_euler_torch.dist import exchange
    from tpu_euler_torch.dist.mesh import LoopbackComm
    from tpu_euler_torch.dist.traverse_dist import slab_sizes

    el_cap = 2 * c_local
    _, c_req = slab_sizes(c_local, world, 2.0)
    comm = LoopbackComm(world, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    gids = []
    for _ in range(world):
        g = torch.full((el_cap,), -1, dtype=torch.int64, device=dev)
        rows = torch.randperm(el_cap, device=dev, generator=gen)[:n_valid]
        g[rows] = torch.randint(0, world * el_cap, (n_valid,), device=dev, generator=gen)
        gids.append(g)

    # three ways to serve a request slab: every slab row looked up and masked;
    # the rows that hold a request only; those, a column of the state at a time
    def every_row(state, recv, fill):
        return torch.where((recv >= 0)[:, None], state[recv.clamp(min=0) % el_cap], fill)

    def requests_only(state, recv, fill, by_column=False):
        idx = torch.nonzero(recv >= 0).squeeze(1)
        li = recv[idx] % el_cap
        served = fill.expand(recv.shape[0], state.shape[1]).clone()
        served[idx] = torch.stack([state[:, c][li] for c in range(state.shape[1])], 1) if by_column else state[li]
        return served

    out = {"world": world, "el_cap": el_cap, "c_req": c_req, "pointers_a_rank": n_valid}
    out["request_slots_ms"] = cuda_ms(lambda: exchange._request_slots(gids[0], world, el_cap, c_req), iters=5)
    for width in (2, 3):
        states = [torch.randint(0, 1 << 40, (el_cap, width), device=dev, generator=gen) for _ in range(world)]
        fill = torch.full((width,), -1, dtype=torch.int64, device=dev)
        placed = [exchange._request_slots(g, world, el_cap, c_req) for g in gids]
        reqs = []
        for g, rows, slots, _ in placed:
            req = torch.full((world * c_req,), -1, dtype=torch.int64, device=dev)
            req[slots] = g[rows]
            reqs.append(req)
        recv = comm.all_to_all(reqs)[0]
        _, rows, slots, _ = placed[0]
        del placed, reqs
        want = every_row(states[0], recv, fill)
        for got in (requests_only(states[0], recv, fill), requests_only(states[0], recv, fill, True), exchange._serve(states[0], recv, el_cap, fill)):
            if not torch.equal(want, got):
                raise AssertionError("two ways of serving a request slab disagree")
        del got
        out[f"serve_every_row_w{width}_ms"] = cuda_ms(lambda: every_row(states[0], recv, fill), iters=5)
        out[f"serve_requests_only_w{width}_ms"] = cuda_ms(lambda: requests_only(states[0], recv, fill), iters=5)
        out[f"serve_requests_only_by_column_w{width}_ms"] = cuda_ms(lambda: requests_only(states[0], recv, fill, True), iters=5)
        out[f"serve_as_exchange_does_w{width}_ms"] = cuda_ms(lambda: exchange._serve(states[0], recv, el_cap, fill), iters=5)
        # the way back: a rank's rows out of the reply slab (``want`` stands in for it)
        out[f"unpack_rows_w{width}_ms"] = cuda_ms(lambda: want[slots], iters=5)
        out[f"unpack_as_exchange_does_w{width}_ms"] = cuda_ms(lambda: exchange.take_rows(want, slots), iters=5)
        out[f"unpack_by_column_w{width}_ms"] = cuda_ms(
            lambda: torch.stack([want[:, c][slots] for c in range(width)], 1), iters=5
        )
        del recv, want
        out[f"exchange_gather_w{width}_ms"] = cuda_ms(lambda: exchange.exchange_gather(states, gids, comm, el_cap, c_req), iters=3, warmup=1)
        del states
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--csrc", default="")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--feed", action="store_true")
    ap.add_argument("--config5", type=int, default=0)
    ap.add_argument("--exchange", action="store_true")
    ap.add_argument("--gather", action="store_true")
    ap.add_argument("--walk", action="store_true")
    ap.add_argument("--walk-bp", type=int, default=4_600_000, help="genome length of --walk's graph")
    ap.add_argument("--walk-config5", action="store_true", help="--walk on SPEC config 5's graph")
    ap.add_argument("--walk-labels-only", action="store_true", help="--walk's label kernels alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.tree))
    from tpu_euler_torch import _build, probes
    from tpu_euler_torch.kmer import extract_kernel as xk
    from tpu_euler_torch.kmer import keys
    from tpu_euler_torch.simulate import random_genome, simulate_read_codes

    if args.csrc:
        _build.CSRC = Path(args.csrc).resolve()
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    rec = {"card": card, "tree": os.path.abspath(args.tree), "csrc": str(_build.CSRC)}

    batch = simulate_read_codes(random_genome(1_000_000, seed=5), 100, (1 << 18) / 10_000, seed=6)
    batch = np.ascontiguousarray(batch[: 1 << 18])
    batch[::997, 50] = 4  # some N
    xk.build()
    probes.build()
    rec["registers"] = {
        name: [int(line.split("Used ")[1].split()[0]) for line in info["log"].splitlines() if "Used " in line]
        for name, info in _build.build_info.items()
    }
    if args.check:
        check(dev, batch)
        rec["checked"] = list(KS_CHECKED)
    codes = torch.from_numpy(batch).to(dev)
    for k in KS_EXTRACT:
        buf = torch.empty((codes.shape[0] * (101 - k),) + keys.word_shape(k), dtype=torch.int64, device=dev)
        rec[f"extract_k{k}_ms"] = cuda_ms(lambda: xk.extract_fill(codes, buf, 0, k))
        rec[f"fill_k{k}_ms"] = cuda_ms(lambda: buf.fill_(7))
        del buf
    for k in KS_STAGES:
        rec[f"stages_k{k}_ms"] = cuda_ms(lambda: probes.extract_stages(codes, k), iters=10)
    if args.exchange:
        rec["exchange"] = time_exchange(dev, codes)
    del codes
    if args.gather:
        rec["gather"] = time_gather(dev)
    if args.feed:
        rec["feed"] = time_feed(dev)
    if args.config5:
        rec["config5"] = time_config5(dev, args.config5)
    if args.walk:
        rec["walk"] = time_walk(dev, args.walk_bp, args.walk_config5, args.walk_labels_only)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
