"""Smoke run of the PyTorch port (tpu_euler_torch) on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the port's kernels from ``tpu_euler_torch/csrc`` (one nvcc per
source) and the FASTA/FASTQ codec from ``native/`` (g++), all started
together, and then, phase by phase:

1. holds the fused extract kernel bit for bit against its plain PyTorch
   version at k = 21, 31 (one int64 word per key), 33, 41 (two words), 63,
   75 (three) and 95 (four), on reads with an N, a short read and padding
   rows at an odd ``start``, on a batch that does not fill its last tile at
   an even ``start``, and at the config-2 batch shape, and times both at
   k = 31, 41 and 63, beside the bytes the kernel must move and its bound;
1b. holds the kernel's packed loader (the feed's 2.25-bit batches: packed
   codes and an N map, or no map) bit for bit against its plain version and
   against the int8 loader on the unpacked codes, at every k of phase 1, with
   a map (an N, a short read, padding rows, an odd ``start``; a batch whose
   last tile is partial) and without one, and times both loaders at the
   config-2 batch at k = 31, 41 and 63 beside their bounds;
1c. holds the canonical emission kernel (``euler/emit_kernel.py``) bit for
   bit against its plain version at the benchmark cells' shapes (E. coli's
   circle at k = 31 and C. elegans' seven chromosomes at k = 41, each beside
   its reverse complement as the doubled edge array emits it), on 2,083
   short contigs, on a million contigs and on a contig whose first 5,000
   bases mirror its last, and times the kernel, its plain version, the copy
   and host tail (``extract._emission_to_contigs``) and the numpy tail it
   replaced (``canonicalize_contig_buffer``) on the same contigs, beside the
   kernel's bytes and bound;
2. runs the five TPU compiler probes (``python -m tpu_euler_torch.probes``)
   through their kernels against the scripts' own expectations, then holds
   each kernel against its plain version and times both, at the scripts'
   shape and at the config-2 batch (probe 3 at k = 31 and 41), beside each
   one's bound there;
3. assembles four small genomes on the card and checks them against the
   port's CPU oracle: 20 kbp at k = 31, 41 and 63, and a repeat genome;
3b. the fuzz twin (``tpu_euler_torch/fuzz.py``, the cases of
   tests/integration/test_fuzz.py): six adversarial genome profiles of
   2,500 bases and eight seeded trials against the oracle, and the GC-skewed
   genome over four loopback ranks with the traversal sharded;
4. runs SPEC config 2 (4.6 Mbp genome, 50x 100 bp error-free reads; the
   parameters of bench.py) at k = 31, then at k = 41 (SPEC config 5's k) on
   the same reads, each once to warm up and once timed, and checks that the
   one contig spells the genome; it prints each run's feed split from the
   assembly's own record (the worker's pack and copy-issue seconds, the
   copies' bytes, the main thread's wait);
5. runs config 2's reads at k = 31 through the grouped counting route
   (groups of 4, 4 and 1 batches) and the per-batch route, each of which
   must give the one-shot run's counts and contig;
5b. runs the tour at bench scale (``python -m tpu_euler_torch.bench_tour``,
   the twin of scripts/bench_tour.py): config 2's reads at 4.6 Mbp, a
   warm-up and a timed ``eulerian_tour`` with its phase split; every valid
   edge must be in the tour once, each chain's positions must run
   0..len-1 and its successors follow its edges, and the edge, chain and
   merge-round counts must be those of the reference's run in
   tour_results.json; then, on the same graph, a whole tour with each of
   its label calls (the merge round's, on the paired successors, and the
   cut's, on the merged ones: the ruling label kernels) held bit for bit
   against the plain doubling at full rounds, both label kernels (the
   ruling set's and the doubling's) held against it on the paired
   successors, and each timed by CUDA events against the plain version and
   its bound, with the ruling set's phases (by the card's clock), its
   rulers and its longest sublist;
5c. runs ``python -m tpu_euler_torch.microbench --quick`` (the H100 op-cost
   table at small sizes, the twins of scripts/microbench_*.py): every
   section must return its rows and every candidate must equal the
   function it stands for;
5e. holds the walk kernel (one thread a frontier slot, a launch a walk
   round; the cycle walk reads succ2 and t from one record) and the
   pointer-jump kernel (every round of a doubling in one cooperative
   launch) against their plain versions on config 2's graph
   (bench_tour's count and build of phase 4's reads) at k = 31 and 41, and
   on the five random functional graphs of
   tests/torch_port/test_torch_chains.py (sublists longer than WALK_CAP,
   ruler-free cycles, self-loops): every walk round from the same state
   (owner words, succ2 after the patch, the ruler tables, the
   continuations and their count), every doubling call's final state, and
   ``chains_from_t``'s chain ids, positions and lengths against the
   all-plain run, on the walk route and the doubling route, bit for bit;
   on the functional graphs also both doublings at every round count, one
   launch each; then times, at k = 31, the cycle walk's first round (with
   and without the minimum; the kernel alone and with the continuations'
   compaction and host read), every round of the cycle walk the same two
   ways, a doubling of each kind (and one round) at the contracted list's
   size and at E, and the whole walk's cycle and rank phases, kernel
   against plain, by CUDA events, with each route's launches under the
   profiler;
5d. runs the bench entry as a user runs it, ``python3 bench_torch.py --reps
   1`` from the root in a process of its own (SPEC config 2: a warm-up, a
   timed run, a profiled run): it must exit 0 with its JSON line, whose
   metric is ``wall_clock_4.6Mbp_50x_k31_1xH100``, transport ``packed``,
   one packed launch a batch, no new build file in the timed run, and
   phase 4's read, window and k-mer counts at k = 31; the line is printed;
6. runs SPEC config 5 at full size (100 Mbp genome, 40x 100 bp reads,
   k = 41; scripts/run_full_configs.py:97-123): 153 batches counted in 13
   arena groups, one walk, one contig of 100,000,040 bases that must spell
   the genome; with its feed split; then
   (6b) the same input sharded over four ranks that this process holds on
   the card (``LoopbackComm``), replicated traversal: 39 steps, grouped
   drains on every rank, the gather, one graph; it must equal phase 6's
   counts and contig, drop no key, and prints every shard's size; and
   (6c) config 5's shape reduced to a 25 Mbp genome (k, coverage, reads and
   capacity rule unchanged), on one device and then over four loopback
   ranks with the traversal sharded: the same gate against that one-device
   run, and the slab factor that held (the full genome's node slabs do not
   fit four ranks on one card). Each sharded run prints the bytes reckoned
   from the pipeline's sizes before it runs, beside its measured peak;
7. cleans three small inputs with errors (20 kbp circular genomes at k = 31
   and 41, a 30 kbp repeat genome) with cutoff + tips + bubbles: the contig
   set equals the oracle's, the cleaned graph and its chains pass the
   validators, and the device emission equals the host emission, also when
   its capacities are too small and it reruns with exact ones;
8. runs SPEC config 3 at full size (4.6 Mbp circular genome, 40x 100 bp reads
   with 0.4% errors, cutoff 4, three tip and two bubble rounds, k = 31;
   scripts/run_configs.py:71-73), once to warm up and once timed. No oracle
   replays it, so the gate is that of scripts/fullscale_adversarial.py:
   every contig of 150 bases or more is an exact substring of the genome
   or of its reverse complement, and those contigs cover 99% of it;
9. runs the 12 Mbp repeat genome of scripts/fullscale_adversarial.py
   (interspersed 3 kbp repeats and a mutated tandem array, linear, 40x, 0.3%
   errors, cutoff 3; 336 M window rows, so the grouped counting route)
   against the same gate with that script's structural coverage floor;
10. drives the command line (``tpu_euler_torch.cli.main``) on a FASTQ file
    of a 50 kbp genome with errors, on the default device: assemble with
    cleaning and both checkpoints, the two resumes, which must write the
    same contigs, equal to the oracle's, with the input read by the native
    codec; ``--mesh`` at the GPU count, where the command starts one NCCL
    rank a GPU and must write the same contigs, alone and with
    ``--shard-traversal``; then ``tour``;
11. runs SPEC config 4 at full size on one device (12 Mbp circular genome,
    60x paired-end 100 bp reads, k = 31; scripts/run_full_configs.py:63-72):
    7.2 M reads, 504 M window rows, so the grouped counting route at
    one-word keys; once to warm up and once timed; one contig of 12,000,030
    bases that must spell the genome;
12. runs config 4 sharded over four ranks held by this process on the one
    card (``LoopbackComm``): hash-owner all-to-all, a spectrum shard a
    rank, grouped drains, the gather, the replicated traversal. The same
    gate; the window and k-mer counts must equal phase 11's; no key may be
    dropped in the exchange; it prints every shard's size; then
    (12b) the same with ``shard_traversal=True``: nothing is gathered, and
    the graph, the doubling passes and the emission stay sharded
    (``dist/traverse_dist.py``). The same gate, phase 11's counts and phase
    12's contigs; it prints ``graph`` and ``extract`` beside phase 12's, the
    peak memory and the slab factor that held; then (12c) SPEC config 3 at
    full size over four loopback ranks with ``shard_traversal=True``
    (cutoff, tips and bubbles sharded): phase 8's gate and phase 8's contig
    set; then (12d) the multi-rank dry run (``tpu_euler_torch.entry``) over
    four loopback ranks on the card: three small assemblies against the
    oracle, the first of which must overflow its slabs and retry;
13. starts one rank a GPU (``ProcessComm`` over NCCL at world size
    ``torch.cuda.device_count()``) and runs, on every rank against the
    oracle, a small errored input at k = 21 with a cutoff and one at
    k = 41, then the multi-rank dry run inside the ranks; with two GPUs or
    more, config 4 as well, replicated and with ``shard_traversal=True``,
    held to phase 11's result. A rank that fails or hangs fails the script;
13b. with four GPUs or more, SPEC config 5 at full size over NCCL, one rank
    a GPU, replicated and then with the traversal sharded (the SPEC's
    config 5 as stated): every rank must equal phase 6's run; it prints
    rank 0's stages, every rank's wall, peak and device idle share, and the
    slab factor that held. With fewer GPUs it prints that it did not run.

``python3 chip_smoke.py --sharded-only`` runs phases 8 (config 3 alone),
10-12d, 6-6c and 13-13b (for a machine with several GPUs);
``python3 chip_smoke.py --emit-only`` runs phase 1c alone. The first line
of output is a JSON object with the GPU count and each GPU's name.

Phases 3-13 take their batches from the pipeline's prefetching feed (pinned
staging, a copy stream); their ``encode`` timer is the main thread's wait
for it. The single-device paths (phases 3-11) ship packed batches to the
kernel's packed loader; the sharded ones (phases 3b's skew case and 12-13)
ship int8 codes to the int8 loader, as the reference's sharded path does.

A kernel's bound is the larger of the bytes it must move (each input read
once, each output written once) over the card's published 3.35 TB/s and its
integer operations over the card's rate for them; every kernel here is
bound by bytes.

Every phase fails by exception, so any fault gives a non-zero exit and no
result line. Kernel launch counts are read from the run each kernel's path
makes, after setting them to 0 just before it: the extract kernel's in
phases 3b-11 for the packed loader, phase 4's int8 run, 3b's skew case, 6b,
6c and 12-12d for the int8 loader, each run on its own, where the other
loader must not launch; the probes' own run for the probes; the ranks of
phases 13 and 13b are processes of their own, and 13b reads each rank's
count; so is 5d's bench entry, which reports its timed run's count in its
line. The walk and pointer-jump kernels' counts are read on every
single-device path that walks (config 2 at k = 31 and 41, configs 3, 4 and
5, the repeat genome, configs 4 and 5 over the loopback with the replicated
traversal, the CLI) and on the tour, which ranks by doubling alone; zero
launches on one of them fails the run. The canonical emission kernel's
count is read on the same paths but the tour (it emits no contig); zero
launches on one of them fails the run. The ruling label kernels' count is
read on the tour's two paths, phase 5b's runs and the CLI's ``tour``; zero
launches on either fails the run (the doubling label kernel is held and
timed directly, off the paths).
The last line of output is

    {"ok": true, "device": {"platform": "gpu", "kind": "<card>", "count": 1}}

It imports nothing of JAX or of the reference package ``tpu_euler``, and
needs no network.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

K = 31
K41 = 41  # SPEC config 5's k: two int64 words per key
K63 = 63  # three words per key
KS_CHECKED = (21, K, 33, K41, K63, 75, 95)  # 95 leaves 6 windows per read, four words
KERNEL_SOURCE = "tpu_euler_torch/csrc/extract_canonical.cu"
KERNEL_REPLACES = "tpu_euler/kmer/pallas_extract.py:144"
PACKED_REPLACES = "tpu_euler/kmer/extract.py:51 + tpu_euler/kmer/pallas_extract.py:144"
WALK_SOURCE = "tpu_euler_torch/csrc/ruling_walk.cu"
WALK_REPLACES = "tpu_euler/euler/ranking.py:135"
JUMP_REPLACES = (
    "tpu_euler/euler/ranking.py:351 + :373 + :561, tpu_euler/euler/unitigs.py:59 + :170"
)
LABELS_REPLACES = "tpu_euler/euler/tour.py:115"
EMIT_SOURCE = "tpu_euler_torch/csrc/emit_canonical.cu"
EMIT_REPLACES = "no TPU kernel: the numpy tail tpu_euler/euler/extract.py:306 + :48"
# the benchmark cells' contigs: E. coli K-12's circle (k = 31) and WBcel235's
# six chromosomes and MtDNA (k = 41), each k - 1 bases longer as emitted
EMIT_SHAPES = {
    "ecoli": ([4_641_652 + 30], 31),
    "celegans": ([n + 40 for n in (15_072_434, 15_279_421, 13_783_801, 17_493_829, 20_924_180, 17_718_942, 13_794)],
                 41),
}
PROBE_SOURCE = "tpu_euler_torch/csrc/probes.cu"
PROBE_REPLACES = {
    "lane_slices": "scripts/debug_pallas2.py:33",
    "extract_stages": "scripts/debug_pallas3.py:44",
    "shift_terms": "scripts/debug_pallas4.py:59",
    "u32_shifts": "scripts/debug_pallas5.py:45",
    "hoisted_and_roll": "scripts/debug_pallas6.py:51",
}


HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
# 32-bit integer operations a second outside the tensor cores: half the
# card's published 67 TFLOP/s of float32 (an SM issues 64 int32 operations
# a clock where it issues 128 float32 ones)
INT32_OPS_PER_S = 33.5e12


def bound(n_bytes: int, int_ops: int) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and integer operations over their rate."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = int_ops / INT32_OPS_PER_S * 1e3
    return {
        "bytes": n_bytes,
        "bound_ms": max(by_bytes, by_ops),
        "bound_by": "bytes" if by_bytes >= by_ops else "operations",
    }


def extract_bound(R: int, Lmax: int, k: int, outputs: int = 1, in_bytes: int | None = None) -> dict:
    """Bound of one pass over [R, Lmax] codes (``in_bytes`` of input, R Lmax
    int8 codes unless given) that writes ``outputs`` keys of ceil(k/31)
    int64 words per window. Operations: per key word two cuts of a packed
    strand (two 64-bit shifts and an OR each), a compare and a select,
    counted as 32 32-bit operations."""
    n_words = R * (Lmax - k + 1) * (-(-k // 31))
    return bound((R * Lmax if in_bytes is None else in_bytes) + 8 * n_words * outputs, 32 * n_words)


def packed_bytes(R: int, Lmax: int, with_map: bool) -> int:
    """Input bytes of a packed batch: ceil(L/4) a read, and ceil(L/8) more
    with its N map."""
    return R * (-(-Lmax // 4) + (-(-Lmax // 8) if with_map else 0))


#: (walk kernel launches, jump kernel launches, doubling rounds they ran,
#: doubling label kernel launches, their rounds, ruling label calls) of each
#: path's run, by the path's name
WALK_LAUNCHES: dict[str, tuple[int, int, int, int, int, int, int]] = {}


#: the trace's counters when ``reset_launches`` last ran
_LAUNCHES_FROM: dict[str, int] = {}


def reset_launches() -> None:
    global _LAUNCHES_FROM
    from tpu_euler_torch import trace

    _LAUNCHES_FROM = trace.totals()


def launched() -> dict[str, int]:
    """The trace's counters' growth since ``reset_launches``."""
    from tpu_euler_torch import trace

    return trace.since(_LAUNCHES_FROM)


def path_launches(name: str, sharded: bool = False) -> int:
    """The extract kernel's launches since ``reset_launches``: the packed
    loader's on a single-device path, the int8 loader's on a sharded one;
    the other loader must not have launched. The
    walk and jump kernels' launches go to ``WALK_LAUNCHES[name]``."""
    n = launched()
    packed, int8 = n["extract_launches"], n["extract_int8_launches"]
    used, other = (int8, packed) if sharded else (packed, int8)
    if other:
        raise AssertionError(f"{name}: the {'packed' if sharded else 'int8'} loader launched {other} times")
    WALK_LAUNCHES[name] = (n["walk_launches"], n["jump_launches"], n["jump_rounds"], n["label_launches"],
                           n["label_rounds"], n["ruling_label_calls"], n["emit_canonical_launches"])
    print(
        f"{name}: walk kernel launches {n['walk_launches']}, pointer-jump kernel launches {n['jump_launches']} "
        f"({n['jump_rounds']} doubling rounds), doubling label kernel launches {n['label_launches']} "
        f"({n['label_rounds']} rounds), ruling label calls {n['ruling_label_calls']} (two launches each), "
        f"cut-table kernel calls {n['cut_table_launches']} ({n['cut_table_rows']} edges), "
        f"canonical emission kernel launches {n['emit_canonical_launches']} "
        f"({n['emit_mirrored_prefixes']} contigs through its second pass)"
    )
    return used


def split_line(name: str, result) -> str:
    """A single-device run's feed split, from its trace's rollup."""
    rollup = result.trace.rollup()
    s, n = rollup["seconds"], rollup["counters"]
    return (
        f"{name}: feed split over {n['batches']} batches: worker pack {s.get('feed: pack', 0.0):.4f} s, copy "
        f"issue {s.get('feed: copy issue', 0.0):.4f} s (host, beside the main thread); {n['h2d_bytes']} bytes "
        f"to the device; main thread's wait (encode) {result.stage_seconds['encode']:.4f} s"
    )


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def config2_batch():
    """One config-2 batch of simulated read codes (2^18 x 100) with some N."""
    import numpy as np

    from tpu_euler_torch.simulate import random_genome, simulate_read_codes

    batch = simulate_read_codes(random_genome(1_000_000, seed=5), 100, (1 << 18) / 10_000, seed=6)
    batch = np.ascontiguousarray(batch[: 1 << 18])
    batch[::997, 50] = 4  # some N
    assert batch.shape == (1 << 18, 100)
    return batch


def max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def phase_kernel(dev, batch) -> dict:
    """Kernel vs plain version on the card, bit for bit, and both times."""
    import numpy as np
    import torch

    from tpu_euler_torch.kmer import extract_kernel as xk
    from tpu_euler_torch.kmer import keys
    from tpu_euler_torch.pipeline.assemble import encode_reads
    from tpu_euler_torch.simulate import random_genome, simulate_reads

    def compare(codes_np, k, start):
        codes = torch.from_numpy(codes_np).to(dev)
        R, W = codes.shape[0], codes.shape[1] - k + 1
        a = torch.full((start + R * W + 5,) + keys.word_shape(k), -7, dtype=torch.int64, device=dev)
        b = a.clone()
        na = xk.extract_fill(codes, a, start, k)
        nb = xk.extract_fill_plain(codes, b, start, k)
        torch.cuda.synchronize()
        err = max_abs_err(a, b)
        if not torch.equal(a, b) or int(na) != int(nb):
            raise AssertionError(f"kernel != plain at k={k}, shape {tuple(codes.shape)}")
        return codes, a, err, int(na)

    reads = simulate_reads(random_genome(800, seed=3), read_len=100, coverage=4, seed=4)
    reads[3] = reads[3][:40] + "N" + reads[3][41:]  # an N mid-read
    reads[5] = reads[5][:55]  # a short read, padded with code 4
    small = np.concatenate([encode_reads(reads, 100), np.full((6, 100), 4, np.int8)])

    ragged = batch[: 5 * 128 + 37]  # does not fill the last tile of 128 reads
    max_err = 0.0
    rec = {"library_ms": None}  # no single PyTorch call computes this function
    for k in KS_CHECKED:
        _, _, err, nv = compare(small, k, 37)
        max_err = max(max_err, err)
        print(f"kernel == plain, k={k}, {small.shape[0]} reads incl. N and padding, start 37 ({nv} valid windows)")
        for start in (16, 1):
            _, _, err, nv = compare(ragged, k, start)
            max_err = max(max_err, err)
        print(f"kernel == plain, k={k}, {ragged.shape[0]} reads (a last tile of 37), start 16 and 1 ({nv} valid windows)")
        codes, buf, err, nv = compare(batch, k, 0)
        max_err = max(max_err, err)
        if k not in (K, K41, K63):
            print(f"kernel == plain, k={k}, config-2 batch {tuple(batch.shape)} ({nv} valid windows)")
            continue
        ms = cuda_ms(lambda: xk.extract_fill(codes, buf, 0, k), iters=20)
        plain_ms = cuda_ms(lambda: xk.extract_fill_plain(codes, buf, 0, k), iters=5)
        b = extract_bound(*batch.shape, k)
        sfx = "" if k == K else f"_k{k}"
        rec.update({"ms" + sfx: ms, "plain_ms" + sfx: plain_ms, **{name + sfx: v for name, v in b.items()}})
        print(
            f"kernel == plain, k={k}, config-2 batch {tuple(batch.shape)} ({nv} valid windows): "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per batch; {b['bytes']} bytes, "
            f"bound {b['bound_ms']:.4f} ms by {b['bound_by']}, kernel at {100 * b['bound_ms'] / ms:.1f}% of it"
        )
        del codes, buf
    rec["max_abs_err"] = max_err
    return rec


def emission_inputs_on_card(dev, lens: list[int], k: int, seed: int, mirror: int = 0):
    """The canonical emission kernel's inputs on the card for contigs of
    ``lens`` random bases (seeded), each beside its reverse complement (its
    twin), as the doubled edge array emits them: (codes, offsets, start
    keys, twins, n, total). The first contig's first ``mirror`` bases
    mirror its last ones. A contig's first k - 1 code slots hold junk."""
    import torch

    from tpu_euler_torch.kmer import keys

    g = torch.Generator(device=dev).manual_seed(seed)
    L = torch.tensor(lens, dtype=torch.int64, device=dev)
    cum = torch.cumsum(L, 0) - L  # each contig's start in x
    x = torch.randint(0, 4, (sum(lens),), dtype=torch.uint8, device=dev, generator=g)
    if mirror:
        x[lens[0] - mirror : lens[0]] = 3 - x[:mirror].flip(0)
    pair = torch.repeat_interleave(torch.arange(len(lens), device=dev), L)
    j = torch.arange(x.shape[0], device=dev) - cum[pair]
    codes = torch.zeros(2 * x.shape[0] + 1, dtype=torch.uint8, device=dev)
    codes[2 * cum[pair] + j] = x
    codes[2 * cum[pair] + 2 * L[pair] - 1 - j] = 3 - x
    del pair, j
    off = torch.stack([2 * cum, 2 * cum + L], 1).flatten()
    n = off.shape[0]
    start_words = keys.pack(codes[off[:, None] + torch.arange(k, device=dev)], k).contiguous()
    slots = (off[:, None] + torch.arange(k - 1, device=dev)).flatten()
    codes[slots] = torch.randint(0, 4, slots.shape, dtype=torch.uint8, device=dev, generator=g)
    twin = torch.arange(n, device=dev) ^ 1
    return codes, off, start_words, twin, n, 2 * x.shape[0]


def phase_emit_kernel(dev) -> dict:
    """Phase 1c: the canonical emission kernel against its plain version on
    the card, bit for bit, and the times of the kernel, its plain version,
    the tail that now follows it, and the numpy tail it replaced."""
    import numpy as np
    import torch

    from tpu_euler_torch.euler import emit_kernel as ek
    from tpu_euler_torch.euler import extract

    def check(name, lens, k, seed, mirror=0):
        codes, off, sw, twin, n, total = emission_inputs_on_card(dev, lens, k, seed, mirror)
        before = launched()["emit_canonical_launches"]
        got = ek.canonical_bytes(codes, off, sw, n, total, k, twin)
        want = ek.canonical_bytes_plain(codes, off, sw, n, total, k, twin)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"emit kernel != plain: {name}")
        _, mirrored, rep, _ = ek.split(got.cpu(), n)
        if launched()["emit_canonical_launches"] - before != ek.LAUNCHES or sum(r >= 0 for r in rep) != n // 2:
            raise AssertionError(f"emit kernel: {name}: launches or repeats wrong ({sum(r >= 0 for r in rep)} of {n})")
        print(f"emit kernel == plain, {name}: {n} contigs (twins included), {total} bytes, k = {k}, "
              f"{mirrored} through the second pass")
        return (codes, off, sw, twin, n, total), got

    reset_launches()
    rec = {"library_ms": None}  # no single PyTorch call computes this function
    check("2,083 contigs of 31-3,000 bases", [31 + (i * 797) % 2970 for i in range(2083)], 31, 11)
    check("a contig mirrored 5,000 bases deep", [4_000_000, 1000], 41, 12, mirror=5000)
    (codes, off, sw, twin, n, total), _ = check("a million contigs of 100 bases", [100] * 500_000, 31, 13)
    rec["ms_million_contigs"] = cuda_ms(lambda: ek.canonical_bytes(codes, off, sw, n, total, 31, twin), iters=20)
    print(f"emit kernel, a million contigs of 100 bases: {rec['ms_million_contigs']:.4f} ms")
    for name, (lens, k) in EMIT_SHAPES.items():
        args, got = check(f"{name}'s contigs", lens, k, 14)
        codes, off, sw, twin, n, total = args
        ms = cuda_ms(lambda: ek.canonical_bytes(codes, off, sw, n, total, k, twin), iters=20)
        plain_ms = cuda_ms(lambda: ek.canonical_bytes_plain(codes, off, sw, n, total, k, twin), iters=3, warmup=1)
        tail, tail_no_twins = [], []  # the host tail with the twins' repeats marked, and with none marked
        for i in range(10):
            buf = ek.canonical_bytes(codes, off, sw, n, total, k, twin if i % 2 == 0 else None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            contigs = extract._emission_to_contigs(buf, n)
            (tail if i % 2 == 0 else tail_no_twins).append(time.perf_counter() - t0)
            del buf
        # the tail it replaced: three pageable copies, the base lookup, the prefix stitch, the canonicalization
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c_np, o_np, w_np = codes[:total].cpu().numpy(), off.cpu().numpy(), sw.cpu().numpy()
        seq = extract._BASES[c_np]
        seq[o_np[:, None] + np.arange(k - 1)[None, :]] = extract.decode_bases_np(w_np, k - 1, k)
        numpy_set = extract.canonicalize_contig_buffer(seq, np.concatenate([o_np, [total]]))
        numpy_s = time.perf_counter() - t0
        if contigs != numpy_set or len(contigs) != n // 2:
            raise AssertionError(f"emit tail: {name}: {len(contigs)} contigs of {n}, not the numpy tail's")
        del c_np, seq, numpy_set
        b = bound(2 * total + total // 2, 0)
        rec.update({f"ms_{name}": ms, f"plain_ms_{name}": plain_ms, f"bytes_{name}": b["bytes"],
                    f"bound_ms_{name}": b["bound_ms"], f"tail_s_{name}": tail,
                    f"tail_no_twins_s_{name}": tail_no_twins, f"numpy_tail_s_{name}": numpy_s})
        print(
            f"emit kernel, {name}: {n} contigs, {total} bytes: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
            f"{b['bytes']} bytes (codes read, ASCII written, the twins' codes read again), bound "
            f"{b['bound_ms']:.4f} ms, kernel at {100 * b['bound_ms'] / ms:.1f}% of it; pinned copy and host tail "
            f"{', '.join(f'{x:.4f}' for x in tail)} s (without the twins marked "
            f"{', '.join(f'{x:.4f}' for x in tail_no_twins)} s); the numpy tail it replaced {numpy_s:.4f} s"
        )
        del args, got, codes, off, sw, twin
    torch.cuda.empty_cache()
    return rec


def phase_packed_kernel(dev, batch) -> dict:
    """Phase 1b: the packed loader against its plain version and the int8
    loader, bit for bit, with a map and without; times at the config-2
    batch (with the map, as config 2's feed ships it at 100 bases, whose pad
    bits past the read set it; and without) beside the int8 loader's."""
    import numpy as np
    import torch

    from tpu_euler_torch.io.encode import pack_codes
    from tpu_euler_torch.kmer import extract_kernel as xk
    from tpu_euler_torch.kmer import keys
    from tpu_euler_torch.pipeline.assemble import encode_reads
    from tpu_euler_torch.simulate import random_genome, simulate_reads

    def packed(codes_np, with_map):
        p, m = pack_codes(codes_np)
        return torch.from_numpy(p).to(dev), torch.from_numpy(m).to(dev) if with_map else None

    def compare(codes_np, with_map, k, start):
        if not with_map:  # a clean batch: no code 4
            codes_np = np.where(codes_np == 4, 0, codes_np).astype(np.int8)
        p, m = packed(codes_np, with_map)
        R, L = codes_np.shape
        W = L - k + 1
        a = torch.full((start + R * W + 5,) + keys.word_shape(k), -7, dtype=torch.int64, device=dev)
        b, c = a.clone(), a.clone()
        na = xk.extract_fill_packed(p, m, a, start, k, L)
        nb = xk.extract_fill_packed_plain(p, m, b, start, k, L)
        nc = xk.extract_fill(torch.from_numpy(codes_np).to(dev), c, start, k)
        torch.cuda.synchronize()
        if not (torch.equal(a, b) and torch.equal(a, c)) or not int(na) == int(nb) == int(nc):
            raise AssertionError(f"packed loader != plain or int8 at k={k}, {R} reads, map {with_map}, start {start}")
        return max(max_abs_err(a, b), max_abs_err(a, c)), int(na)

    reads = simulate_reads(random_genome(800, seed=13), read_len=100, coverage=4, seed=14)
    reads[3] = reads[3][:40] + "N" + reads[3][41:]
    reads[5] = reads[5][:55]
    small = np.concatenate([encode_reads(reads, 100), np.full((6, 100), 4, np.int8)])
    ragged = batch[: 5 * 128 + 37]
    max_err, counts = 0.0, {}
    for k in KS_CHECKED:
        for with_map in (True, False):
            for codes_np, start in ((small, 37), (ragged, 16), (ragged, 1), (batch, 0)):
                err, nv = compare(codes_np, with_map, k, start)
                max_err = max(max_err, err)
                counts[codes_np.shape[0], with_map] = nv
        print(
            f"packed loader == plain == int8 loader, k={k}: {small.shape[0]} reads incl. N and padding at start 37, "
            f"{ragged.shape[0]} reads (a last tile of 37) at start 16 and 1, the config-2 batch; with a map and "
            f"without ({counts[batch.shape[0], True]} / {counts[batch.shape[0], False]} valid windows there)"
        )
    rec = {"library_ms": None, "max_abs_err": max_err}
    R, L = batch.shape
    clean = np.where(batch == 4, 0, batch).astype(np.int8)
    codes = torch.from_numpy(batch).to(dev)
    for k in (K, K41, K63):
        buf = torch.empty((R * (L - k + 1),) + keys.word_shape(k), dtype=torch.int64, device=dev)
        sfx = "" if k == K else f"_k{k}"
        for with_map, tag in ((True, ""), (False, "_nomap")):
            p, m = packed(batch if with_map else clean, with_map)
            ms = cuda_ms(lambda: xk.extract_fill_packed(p, m, buf, 0, k, L), iters=20)
            b = extract_bound(R, L, k, in_bytes=packed_bytes(R, L, with_map))
            rec.update({"ms" + tag + sfx: ms, **{name + tag + sfx: v for name, v in b.items()}})
            if with_map:
                rec["plain_ms" + sfx] = cuda_ms(lambda: xk.extract_fill_packed_plain(p, m, buf, 0, k, L), iters=5)
            del p, m
        int8_ms = cuda_ms(lambda: xk.extract_fill(codes, buf, 0, k), iters=20)
        rec["int8_loader_ms" + sfx] = int8_ms
        print(
            f"packed loader at the config-2 batch, k={k}: with the map {rec['ms' + sfx]:.4f} ms "
            f"({rec['bytes' + sfx]} bytes, bound {rec['bound_ms' + sfx]:.4f} ms by {rec['bound_by' + sfx]}, "
            f"{100 * rec['bound_ms' + sfx] / rec['ms' + sfx]:.1f}% of it); without {rec['ms_nomap' + sfx]:.4f} ms "
            f"({rec['bytes_nomap' + sfx]} bytes, bound {rec['bound_ms_nomap' + sfx]:.4f} ms, "
            f"{100 * rec['bound_ms_nomap' + sfx] / rec['ms_nomap' + sfx]:.1f}%); plain {rec['plain_ms' + sfx]:.4f} ms; "
            f"the int8 loader in the same phase {int8_ms:.4f} ms"
        )
        del buf
    return rec


def phase_fuzz(dev) -> dict:
    """Phase 3b: the fuzz twin on the card against the oracle. Returns the
    launches of the single-device cases (packed loader) and of the sharded
    skew case (int8 loader)."""
    from tpu_euler_torch import fuzz
    from tpu_euler_torch.dist.mesh import LoopbackComm

    t0 = time.perf_counter()
    reset_launches()
    profiles = [fuzz.run_profile(i, dev) for i in range(len(fuzz.PROFILES))]
    trials = [fuzz.run_trial(t, dev) for t in range(fuzz.N_TRIALS)]
    single = path_launches("fuzz")
    print(
        f"fuzz: {len(profiles)} adversarial profiles ({', '.join(f'{p[0]} {n}' for p, n in zip(fuzz.PROFILES, profiles))} "
        f"contigs) and {len(trials)} seeded trials ({trials} contigs) == oracle on the card; packed loader launches {single}"
    )
    reset_launches()
    n = fuzz.run_skew(LoopbackComm(4, dev))
    skew = path_launches("fuzz skew", sharded=True)
    print(
        f"fuzz: the GC-skewed genome over four loopback ranks, traversal sharded: {n} contigs == oracle; "
        f"int8 loader launches {skew}; phase 3b in {time.perf_counter() - t0:.2f} s"
    )
    if not (single and skew):
        raise AssertionError("fuzz: a loader never launched")
    return {"launches_fuzz": single, "launches_fuzz_skew_loopback4": skew}


def phase_probes(dev, batch) -> list[dict]:
    """The probes' own run (kernels vs the scripts' expectations) with the
    launch counts read around it; then each kernel vs its plain version,
    bit for bit, with both times, at the scripts' shape and at the config-2
    batch (where a time is not launch latency), beside its bound there and,
    for ``lane_slices``, the one PyTorch call that computes it."""
    import numpy as np
    import torch

    from tpu_euler_torch import probes

    for name in probes.launches:
        probes.launches[name] = 0
    for line in probes.run_all(dev, k_stages=(K, K41)):
        print("probe " + line)
    launched = dict(probes.launches)
    missing = [n for n, c in launched.items() if c == 0]
    if missing:
        raise AssertionError(f"probe kernels never launched: {missing}")

    def held(label, probe, plain, iters, plain_iters):
        got, want = probe(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"probe {label}: kernel != plain")
        err = max_abs_err(got, want)
        del got, want
        return err, cuda_ms(probe, iters=iters), cuda_ms(plain, iters=plain_iters)

    recs = {name: {"max_abs_err": 0.0, "library_ms": None} for name in probes.launches}
    for name, probe, plain, x, _ in probes.cases((K, K41)):
        xd = torch.from_numpy(x).to(dev)
        err, ms, plain_ms = held(name, lambda: probe(xd), lambda: plain(xd), 50, 10)
        print(f"probe {name}: kernel == plain, {tuple(x.shape)}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        rec = recs[name.split()[0]]
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec.setdefault("ms_script_shape", ms)
        rec.setdefault("plain_ms_script_shape", plain_ms)

    # the config-2 batch: [2^18, 100] codes (70 windows a read at k = 31), and
    # as many rows of 128 uint32 for probe 5
    codes = torch.from_numpy(batch).to(dev)
    R, Lmax = batch.shape
    n = R * (Lmax - K + 1)
    x32 = torch.from_numpy(
        np.random.default_rng(0).integers(0, 1 << 32, (R, probes.U32_COLS), dtype=np.uint64).astype(np.uint32).view(np.int32)
    ).to(dev)
    m = x32.numel()

    def lane_slices_library():
        return torch.as_strided(codes, (probes.N_OFFSETS, R, Lmax - K + 1), (1, Lmax, 1)).to(
            torch.int32, memory_format=torch.contiguous_format
        )

    at_batch = [
        # name, suffix, probe, plain, bound (bytes in + out; 32-bit integer operations), library call
        ("lane_slices", "", lambda: probes.lane_slices(codes), lambda: probes.lane_slices_plain(codes),
         bound(R * Lmax + 4 * probes.N_OFFSETS * n, probes.N_OFFSETS * n), lane_slices_library),
        ("extract_stages", "", lambda: probes.extract_stages(codes, K), lambda: probes.extract_stages_plain(codes, K),
         extract_bound(R, Lmax, K, outputs=3), None),
        ("extract_stages", f"_k{K41}", lambda: probes.extract_stages(codes, K41), lambda: probes.extract_stages_plain(codes, K41),
         extract_bound(R, Lmax, K41, outputs=3), None),
        # 15 terms of a mask, a shift and three accumulations
        ("shift_terms", "", lambda: probes.shift_terms(codes), lambda: probes.shift_terms_plain(codes),
         bound(R * Lmax + 4 * 6 * n, 15 * 5 * n), None),
        ("u32_shifts", "", lambda: probes.u32_shifts(x32), lambda: probes.u32_shifts_plain(x32),
         bound(4 * m + 4 * 23 * m, 23 * m), None),
        # 15 bases of a mask and two accumulations of two operations
        ("hoisted_and_roll", "", lambda: probes.hoisted_and_roll(codes), lambda: probes.hoisted_and_roll_plain(codes),
         bound(R * Lmax + 4 * 5 * n, 15 * 5 * n), None),
    ]
    for name, sfx, probe, plain, b, library in at_batch:
        err, ms, plain_ms = held(name + sfx, probe, plain, 10, 2)
        rec = recs[name]
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec.update({"ms" + sfx: ms, "plain_ms" + sfx: plain_ms, **{key + sfx: v for key, v in b.items()}})
        line = (
            f"probe {name}{sfx}: kernel == plain at the config-2 batch: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
            f"{b['bytes']} bytes, bound {b['bound_ms']:.4f} ms by {b['bound_by']}, kernel at {100 * b['bound_ms'] / ms:.1f}% of it"
        )
        if library is not None:
            if not torch.equal(library(), probe()):
                raise AssertionError(f"probe {name}: the library call disagrees with the kernel")
            rec["library_ms"] = cuda_ms(library, iters=10)
            line += f"; one PyTorch call (as_strided(...).to(int32)) {rec['library_ms']:.4f} ms"
        print(line)
    return [
        {
            "name": name,
            "route": "cuda",
            "source": PROBE_SOURCE,
            "replaces": PROBE_REPLACES[name],
            "launches": launched[name],
            **recs[name],
        }
        for name in probes.launches
    ]


def phase_small_genomes(dev) -> None:
    """Whole port on the card vs the CPU oracle: 20 kbp at 30x at k = 31,
    (120 bp reads) at k = 41 and (three words per key) at k = 63, and a
    repeat genome at k = 31."""
    from tpu_euler_torch.config import AssemblyConfig
    from tpu_euler_torch.oracle import assemble_oracle, diff_contig_sets
    from tpu_euler_torch.pipeline.assemble import assemble_reads
    from tpu_euler_torch.simulate import random_genome, simulate_reads

    g20 = random_genome(20_000, seed=99)
    rep = random_genome(300, seed=61)
    grep = (
        random_genome(800, seed=62) + rep + random_genome(700, seed=63)
        + rep + random_genome(600, seed=64)
    )
    cases = [
        # capacity 2^18: E = 2^19 doubled edges, so the ruling-set walk runs
        ("20 kbp genome, 30x, k = 31", simulate_reads(g20, 100, 30, seed=100, circular=True), K, 100, 1 << 18),
        ("20 kbp genome, 30x, 120 bp reads, k = 41", simulate_reads(g20, 120, 30, seed=101, circular=True), K41, 120, 1 << 18),
        ("20 kbp genome, 30x, k = 63", simulate_reads(g20, 100, 30, seed=102, circular=True), K63, 100, 1 << 18),
        ("repeat genome, k = 31", [grep[i : i + 100] for i in range(0, len(grep) - 99, 3)] + [grep[-100:]], K, 100, 1 << 14),
    ]
    for name, reads, k, read_len, cap in cases:
        cfg = AssemblyConfig(k=k, read_batch=4096, read_len=read_len, spectrum_capacity=cap)
        got = assemble_reads(reads, cfg, dev)
        only_got, only_exp = diff_contig_sets(got.contig_strings, assemble_oracle(reads, k))
        if only_got or only_exp:
            raise AssertionError(f"{name}: {len(only_got)} extra, {len(only_exp)} missing contigs")
        print(f"{name}: {len(got.contigs)} contigs == oracle (lengths {sorted(len(c) for c in got.contigs)[-3:]})")


@contextlib.contextmanager
def call_counts(targets, summaries=None, seconds=None):
    """Count calls of module functions that the pipeline looks up at call
    time (for the group count and the walk), without changing them. Where
    given, ``seconds`` collects each call's host time by function name, and
    ``summaries`` maps a function name to a summary of its return value,
    whose results replace the function under that name, call by call (a
    summary, so that no tensor outlives its call)."""
    import importlib

    counts = {name: 0 for _, name in targets}
    summarize = dict(summaries or {})
    if summaries is not None:
        summaries.clear()
    saved = []
    try:
        for mod_name, name in targets:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, name)
            saved.append((mod, name, fn))

            def wrapped(*a, _fn=fn, _name=name, **kw):
                counts[_name] += 1
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                if seconds is not None:
                    seconds.setdefault(_name, []).append(time.perf_counter() - t0)
                if _name in summarize:
                    summaries.setdefault(_name, []).append(summarize[_name](out))
                return out

            setattr(mod, name, wrapped)
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def phase_config2(dev, genome, codes, cfg):
    """SPEC config 2's reads at ``cfg.k``: warm-up + timed run. Returns the
    extract kernel's launches in the timed run, and its result."""
    import torch

    from tpu_euler_torch.pipeline.assemble import assemble_codes
    from tpu_euler_torch.verify.compare import check_one_contig

    name = f"config 2, k={cfg.k}"
    t0 = time.perf_counter()
    assemble_codes(codes, cfg, dev)
    print(f"{name}: warm-up run {time.perf_counter() - t0:.3f} s")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    result = assemble_codes(codes, cfg, dev)
    wall = time.perf_counter() - t0
    launches = path_launches(name)
    peak = torch.cuda.max_memory_allocated(dev)

    contigs = list(result.contigs)
    print(
        f"{name}: timed run wall {wall:.4f} s; stages "
        + json.dumps({k: round(v, 4) for k, v in result.stage_seconds.items()})
    )
    print(
        f"{name}: {result.n_reads} reads, {result.n_kmers_counted} windows, "
        f"{result.n_distinct_kmers} distinct k-mers, {len(contigs)} contigs "
        f"of {[len(c) for c in contigs[:3]]} bases; peak device memory "
        f"{peak / 2**30:.3f} GiB; extract kernel launches {launches} (packed loader)"
    )
    print(split_line(name, result))
    check_one_contig(name, contigs, genome, cfg.k)
    n_batches = -(-codes.shape[0] // cfg.read_batch)
    if launches != n_batches:
        raise AssertionError(f"extract kernel launched {launches} times, expected {n_batches}")
    return launches, result


def phase_routes(dev, codes, cfg, oneshot) -> dict:
    """Config 2's reads at ``cfg.k`` through the grouped route (four
    batches a group: groups of 4, 4 and 1) and the per-batch route; each
    must give the one-shot run's counts and contig. Returns each route's
    extract launches."""
    import torch

    from tpu_euler_torch.pipeline.assemble import assemble_codes

    Wb = cfg.read_batch * cfg.windows_per_read
    n_batches = -(-codes.shape[0] // cfg.read_batch)
    launches = {}
    for route, rows, drains in (("grouped", 4 * Wb, -(-n_batches // 4)), ("per-batch", 0, 0)):
        torch.cuda.synchronize()
        with call_counts([("tpu_euler_torch.pipeline.assemble", "arena_drain")]) as calls:
            reset_launches()
            t0 = time.perf_counter()
            res = assemble_codes(codes, dataclasses.replace(cfg, oneshot_rows=rows), dev)
            wall = time.perf_counter() - t0
            launches[route] = path_launches(f"config 2 {route} route")
        print(
            f"config 2, k={cfg.k}, {route} route (oneshot_rows = {rows}): wall {wall:.4f} s; "
            f"{calls['arena_drain']} arena drains; stages "
            + json.dumps({k: round(v, 4) for k, v in res.stage_seconds.items()})
        )
        same = (res.n_kmers_counted, res.n_distinct_kmers, res.contigs) == (
            oneshot.n_kmers_counted, oneshot.n_distinct_kmers, oneshot.contigs
        )
        if not same or calls["arena_drain"] != drains or launches[route] != n_batches:
            raise AssertionError(
                f"config 2 {route} route: counts {res.n_kmers_counted}/{res.n_distinct_kmers}, "
                f"{len(res.contigs)} contigs, {calls['arena_drain']} drains, "
                f"{launches[route]} launches differ from the one-shot run's"
            )
        print(f"config 2, k={cfg.k}, {route} route == one-shot route: counts and contig")
    return launches


def walk_state(succ, valid, t):
    """A walk's state before its first round, as ``ranking._run_walk``
    makes it: (succ2, the t it reads, owner_off, frontier, tables); the
    cycle walk's with ``t`` (succ2 and t in one record), the rank walk's (no
    minimum, no self-loop rulers) without."""
    from tpu_euler_torch.euler import ranking

    succ2, t_walk, owner_off, frontier = ranking._walk_start(succ, valid, t, t is not None)
    tabs = ranking._empty_tables(ranking._pow2(2 * frontier.shape[0]), succ.device, t is not None)
    return succ2, t_walk, owner_off, frontier, tabs


def held_chains(name, succ0, valid, t, min_edges: int) -> float:
    """``chains_from_t`` through the kernels with every walk round and
    doubling held to its plain version from the same state (on the walk
    route, ``min_edges`` < E, also the rank walk, no minimum, on the cut
    list); then the chains against the all-plain run's. Returns the chains'
    max abs difference (0)."""
    import torch

    from tpu_euler_torch import microbench
    from tpu_euler_torch.euler import ranking
    from tpu_euler_torch.euler.unitigs import _apply_cut, chains_from_t

    with microbench.held_rounds() as held:
        got = chains_from_t(t, valid, succ0, min_edges)
        if min_edges < succ0.shape[0]:  # the walk route: hold the rank walk too
            res = ranking.cycle_min_ruling_tables(succ0, valid, t)
            if res is None or ranking.rank_chains_ruling(_apply_cut(succ0, t, res[0], res[1])[0], valid) is None:
                raise AssertionError(f"{name}: the walk overflowed or broke an invariant")
            del res
    with microbench.plain_route():
        want = chains_from_t(t, valid, succ0, min_edges)
    torch.cuda.synchronize()
    err = max(max_abs_err(getattr(got, f), getattr(want, f)) for f in got._fields)
    if err or not all(torch.equal(getattr(got, f), getattr(want, f)) for f in got._fields):
        raise AssertionError(f"{name}: the chains through the kernels != the all-plain run's")
    print(
        f"{name}: {held['walk_rounds']} walk rounds and {held['jumps']} doublings, kernel == plain bit for bit "
        f"(owner words, succ2, tables, continuations; final states); chain ids, positions and lengths == the "
        f"all-plain run's ({int(got.is_start.sum())} chains of {int(valid.sum())} edges, min_edges {min_edges})"
    )
    if not held["jumps"] or (min_edges < succ0.shape[0]) != bool(held["walk_rounds"]):
        raise AssertionError(f"{name}: {held} held on the {'walk' if min_edges < succ0.shape[0] else 'doubling'} route")
    return err


def reset_ms(fn, reset, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms by CUDA events around each call,
    with ``reset()`` (not timed) before each."""
    import torch

    total = 0.0
    for i in range(warmup + iters):
        reset()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i >= warmup:
            total += start.elapsed_time(end)
    return total / iters


def time_walk_kernels(dev, succ0, valid, t) -> tuple[dict, dict]:
    """Config 2's walk at k = 31, kernel against plain: the first round of
    the cycle walk from the same state (the minimum tracked, and not), the
    kernel alone (CUDA events around its launch) and with the
    continuations' compaction and host read; every round of the cycle walk
    the same two ways; a doubling of each kind (one launch of every round)
    and one round at the contracted list's size and at E; and the whole
    walk's cycle and rank phases, with each route's launches under the
    profiler. Returns the two kernels' records."""
    import torch

    from tpu_euler_torch import microbench
    from tpu_euler_torch.euler import ranking
    from tpu_euler_torch.euler import ranking_kernel as rk
    from tpu_euler_torch.euler.unitigs import _apply_cut
    from tpu_euler_torch.profile_config2 import device_profile

    E = succ0.shape[0]
    walk = {"library_ms": None}  # no single PyTorch call walks
    for track, sfx in ((t, ""), (None, "_no_min")):
        succ2, t_walk, owner, frontier, tabs = walk_state(succ0, valid, track)
        succ2_0, owner_0 = succ2.clone(), owner.clone()

        def reset():
            succ2.copy_(succ2_0)
            owner.copy_(owner_0)

        args = (succ2, t_walk, frontier, 0, owner, ranking.WALK_CAP, tabs)
        times = {
            route: reset_ms(lambda: fn(*args), reset, iters=iters)
            for route, fn, iters in (("ms", rk.walk_launch, 10), ("round_ms", rk.walk_round, 10),
                                     ("plain_ms", rk.walk_round_plain, 3))
        }
        reset()
        _, n_cont = rk.walk_round(*args)
        covered = int((owner[:E] >= 0).sum())
        s_cap = frontier.shape[0]
        b = bound((24 if track is not None else 16) * covered + (56 if track is not None else 48) * s_cap, 0)
        walk.update({k + sfx: v for k, v in times.items()})
        walk.update({**{k + sfx: v for k, v in b.items()},
                     "round1" + sfx: {"E": E, "s_cap": s_cap, "covered": covered, "continuations": n_cont}})
        print(
            f"walk round 1 of config 2's cycle walk{' (no minimum)' if sfx else ''}, E = {E}, s_cap = {s_cap}: "
            f"{covered} elements covered, {n_cont} continuations; kernel alone {times['ms']:.4f} ms, with the "
            f"continuations' compaction and its host read {times['round_ms']:.4f} ms, plain {times['plain_ms']:.4f} "
            f"ms; {b['bytes']} bytes, bound {b['bound_ms']:.4f} ms by {b['bound_by']}, kernel at "
            f"{100 * b['bound_ms'] / times['ms']:.1f}% of it"
        )
        del succ2_0, t_walk, owner_0, succ2, owner, frontier, tabs, args

    rounds = []
    real = rk.walk_round

    def timed(succ2, t_, frontier, base, owner_off, walk_cap, tabs):
        s2, oo = succ2.clone(), owner_off.clone()

        def reset():
            succ2.copy_(s2)
            owner_off.copy_(oo)

        args = (succ2, t_, frontier, base, owner_off, walk_cap, tabs)
        row = {"s_cap": frontier.shape[0], "kernel_ms": reset_ms(lambda: rk.walk_launch(*args), reset, iters=3),
               "round_ms": reset_ms(lambda: real(*args), reset, iters=3)}
        reset()
        got = real(*args)
        rounds.append({**row, "continuations": got[1]})
        return got

    rk.walk_round = timed
    try:
        res = ranking.cycle_min_ruling_tables(succ0, valid, t)
    finally:
        rk.walk_round = real
    walk["cycle_walk_rounds"] = rounds
    print(
        f"config 2's cycle walk, {len(rounds)} rounds, kernel alone / with the compaction (ms): "
        + ", ".join(f"{r['kernel_ms']:.4f} / {r['round_ms']:.4f}" for r in rounds)
        + f"; sums {sum(r['kernel_ms'] for r in rounds):.4f} / {sum(r['round_ms'] for r in rounds):.4f} ms"
    )

    on_cycle, cyc_min, owner_off, tabs, succ_c = res
    cut, is_cut = _apply_cut(succ0, t, on_cycle, cyc_min)
    S = succ_c.shape[0]
    jump = {"library_ms": None}  # no single PyTorch call jumps
    states = {
        "": ("min", (succ_c, tabs["mmin"])),
        "_rank": ("rank", (succ_c, tabs["hops"], torch.where(succ_c >= 0, succ_c, torch.arange(S, device=dev)))),
        "_E": ("min", (succ0, t)),
        "_rank_E": ("rank", (cut, (cut >= 0).long(), torch.where(cut >= 0, cut, torch.arange(E, device=dev)))),
    }
    for sfx, (kind, state) in states.items():
        fn, plain = (rk.jump_min, rk.jump_min_plain) if kind == "min" else (rk.jump_rank, rk.jump_rank_plain)
        n = state[0].shape[0]
        n_rounds = ranking._log2_ceil(n) + 1
        ms = reset_ms(lambda: fn(*state, n_rounds), lambda: None, iters=10)
        round_ms = reset_ms(lambda: fn(*state, 1), lambda: None, iters=20)
        plain_ms = reset_ms(lambda: plain(*state, n_rounds), lambda: None, iters=3)
        # each input read once and each output written once: a doubling's
        # bytes, and a round's
        b = bound((32 if kind == "min" else 48) * n, 0)
        jump.update({"ms" + sfx: ms, "plain_ms" + sfx: plain_ms, "rounds" + sfx: n_rounds, "n" + sfx: n,
                     "ms_a_round" + sfx: ms / n_rounds, "one_round_ms" + sfx: round_ms,
                     **{k + sfx: v for k, v in b.items()}})
        print(
            f"pointer-jump doubling ({kind}) over {n} elements ({'the contracted list' if n == S else 'E'}), "
            f"{n_rounds} rounds in one launch: kernel {ms:.4f} ms ({ms / n_rounds:.4f} ms a round; one round alone "
            f"{round_ms:.4f} ms), plain {plain_ms:.4f} ms; {b['bytes']} bytes, bound {b['bound_ms']:.4f} ms by "
            f"{b['bound_by']}: the doubling at {100 * b['bound_ms'] / ms:.1f}% of it, a round at "
            f"{100 * b['bound_ms'] * n_rounds / ms:.1f}%"
        )
    del res, on_cycle, cyc_min, owner_off, tabs, succ_c, cut, is_cut, states

    bench = microbench.Bench("cuda")
    whole = {}
    for route, ctx in (("kernel", contextlib.nullcontext), ("plain", microbench.plain_route)):
        with ctx():
            cyc, rank = [], []
            for i in range(4):
                e = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                e[0].record()
                on_cycle, cyc_min, owner_off, tabs, succ_c = ranking.cycle_min_ruling_tables(succ0, valid, t)
                e[1].record()
                cut, is_cut = _apply_cut(succ0, t, on_cycle, cyc_min)
                e[2].record()
                ranking.rank_chains_with_cut(cut, valid, is_cut, owner_off, tabs, succ_c)
                e[3].record()
                e[3].synchronize()
                if i:  # the first is a warm-up
                    cyc.append(e[0].elapsed_time(e[1]))
                    rank.append(e[2].elapsed_time(e[3]))
                del on_cycle, cyc_min, owner_off, tabs, succ_c, cut, is_cut
            prof = device_profile(lambda: microbench.walk_once(bench, succ0, valid, t))
        whole[route] = {
            "cycle_ms": sorted(cyc)[1], "rank_ms": sorted(rank)[1], "launches": prof["kernel_launches"],
            "idle_share": prof["device_idle_share"], "profiled_wall_s": prof["profiled_wall_s"],
            "top_device_ms": prof["top_device_ms"][:6],
        }
        print(
            f"config 2's walk at k = {K}, {route} route: cycle phase {whole[route]['cycle_ms']:.4f} ms, rank "
            f"phase {whole[route]['rank_ms']:.4f} ms (median of 3 by CUDA events); profiled walk: "
            f"{prof['kernel_launches']} launches, {prof['profiled_wall_s']:.4f} s, device idle "
            f"{100 * prof['device_idle_share']:.1f}%; top device time (ms, op, calls) "
            + json.dumps([[round(ms, 4), op[:60], n] for ms, op, n in prof["top_device_ms"][:6]])
        )
    walk["whole_walk"] = whole
    return walk, jump


def held_doublings(name, succ, t) -> int:
    """Both doublings on one graph's successors, every round count r from 0
    to log2_ceil(E) + 1 in one launch each, against r plain rounds, bit for
    bit. Returns the doublings held."""
    import torch

    from tpu_euler_torch.euler import ranking
    from tpu_euler_torch.euler import ranking_kernel as rk

    E = succ.shape[0]
    d = torch.arange(E, device=succ.device) % 5
    q = torch.where(succ >= 0, succ, torch.arange(E, device=succ.device))
    held = 0
    for kind, state, fn, plain in (("min", (succ, t), rk.jump_min, rk.jump_min_plain),
                                   ("rank", (succ, d, q), rk.jump_rank, rk.jump_rank_plain)):
        for r in range(ranking._log2_ceil(E) + 2):
            if not all(torch.equal(a, b) for a, b in zip(fn(*state, r), plain(*state, r))):
                raise AssertionError(f"{name}: the {kind} doubling over {r} rounds != {r} plain rounds")
            held += 1
    return held


def phase_walk_kernels(dev, codes, cfg) -> tuple[dict, dict]:
    """Phase 5e: the walk and pointer-jump kernels against their plain
    versions on config 2's graph at k = 31 and 41 and on the five random
    functional graphs; then their times at k = 31. Returns the two
    kernels' records."""
    import torch

    from tpu_euler_torch import convert
    from tpu_euler_torch.bench_tour import tour_graph
    from tpu_euler_torch.euler.unitigs import successor, transition_keys
    from tpu_euler_torch.simulate import FUNCTIONAL_GRAPHS, functional_graph_inputs

    t0 = time.perf_counter()
    err = 0.0
    recs = None
    for k in (K, K41):
        g = tour_graph(codes, dataclasses.replace(cfg, k=k), dev)
        succ0 = successor(g)
        valid, t = g.edge_valid, transition_keys(g, succ0, k)
        del g
        name = f"config 2's graph, k = {k}"
        err = max(err, held_chains(name, succ0, valid, t, 1 << 17))
        err = max(err, held_chains(name + ", the doubling route", succ0, valid, t, succ0.shape[0]))
        if k == K:
            recs = time_walk_kernels(dev, succ0, valid, t)
        del succ0, valid, t
        torch.cuda.empty_cache()
    for case in FUNCTIONAL_GRAPHS:
        succ, valid, t = functional_graph_inputs(*case)
        succ, valid = torch.from_numpy(succ).to(dev), torch.from_numpy(valid).to(dev)
        t = convert.tkeys_from_limbs(t, dev)
        for min_edges in (0, succ.shape[0]):
            err = max(err, held_chains(f"functional graph {case}", succ, valid, t, min_edges))
        n = held_doublings(f"functional graph {case}", succ, t)
        print(f"functional graph {case}: {n} doublings of every round count, kernel == plain bit for bit")
    for rec in recs:
        rec["max_abs_err"] = err
    print(f"phase 5e in {time.perf_counter() - t0:.2f} s")
    return recs


def phase_config5(dev):
    """SPEC config 5 at full size, once (the kernels are warm from config
    2). Returns (the extract kernel's launches in the run, its result,
    genome, codes, config)."""
    import torch

    from tpu_euler_torch.pipeline.assemble import assemble_codes
    from tpu_euler_torch.simulate import config5_inputs
    from tpu_euler_torch.verify.compare import check_one_contig

    t0 = time.perf_counter()
    genome, codes, cfg = config5_inputs()
    sim_s = time.perf_counter() - t0
    Wb = cfg.read_batch * cfg.windows_per_read
    bpg = cfg.oneshot_rows // Wb
    n_batches = -(-codes.shape[0] // cfg.read_batch)
    print(
        f"config 5: simulated {len(genome)} bp, {codes.shape[0]} reads in {sim_s:.2f} s; "
        f"{n_batches} batches, {bpg} a group, arena of "
        f"{cfg.spectrum_capacity + bpg * Wb} rows"
    )
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    targets = [
        ("tpu_euler_torch.pipeline.assemble", "arena_drain"),
        ("tpu_euler_torch.pipeline.assemble", "chains_from_t"),
    ]
    with call_counts(targets) as calls:
        reset_launches()
        t0 = time.perf_counter()
        result = assemble_codes(codes, cfg, dev)
        wall = time.perf_counter() - t0
        launches = path_launches("config 5")
    peak = torch.cuda.max_memory_allocated(dev)
    print(
        f"config 5: wall {wall:.4f} s (simulation {sim_s:.2f} s apart); stages "
        + json.dumps({k: round(v, 4) for k, v in result.stage_seconds.items()})
    )
    print(split_line("config 5", result))
    print(
        f"config 5: {result.n_reads} reads, {result.n_kmers_counted} windows, "
        f"{result.n_distinct_kmers} distinct k-mers, {len(result.contigs)} contigs; "
        f"{calls['arena_drain']} groups; {calls['chains_from_t']} walk with the t handoff; "
        f"peak device memory {peak / 2**30:.3f} GiB "
        f"(max_memory_allocated {peak} B); extract kernel launches {launches}"
    )
    check_one_contig("config 5", result.contigs, genome, cfg.k)
    n_groups = -(-n_batches // bpg)
    if (launches, calls["arena_drain"], calls["chains_from_t"]) != (n_batches, n_groups, 1):
        raise AssertionError(
            f"config 5: {launches} launches, {calls['arena_drain']} groups, "
            f"{calls['chains_from_t']} walks; expected {n_batches}, {n_groups}, 1"
        )
    return launches, result, genome, codes, cfg


def phase_cleaning_small(dev) -> None:
    """Cutoff + tips + bubbles on the card vs the CPU oracle, the
    validators on the cleaned graph, and the device emission vs the host
    emission."""
    from tpu_euler_torch import trace
    from tpu_euler_torch.config import AssemblyConfig
    from tpu_euler_torch.euler import extract
    from tpu_euler_torch.euler.clean import clip_tips, pop_bubbles
    from tpu_euler_torch.euler.extract import chains_to_contigs, chains_to_contigs_device
    from tpu_euler_torch.euler.unitigs import unitig_chains
    from tpu_euler_torch.graph.build import build_graph
    from tpu_euler_torch.graph.validate import validate_chains, validate_graph
    from tpu_euler_torch.io.encode import decode_read
    from tpu_euler_torch.kmer.count import apply_cutoff
    from tpu_euler_torch.oracle import assemble_oracle, diff_contig_sets
    from tpu_euler_torch.pipeline.assemble import assemble_codes, count_spectrum, right_size_spectrum
    from tpu_euler_torch.simulate import adversarial_genome, random_genome, simulate_read_codes

    g20 = random_genome(20_000, seed=199)
    cases = [
        ("20 kbp circular genome, 40x, 0.4% errors, k = 31", g20, True, 100, 0.004, K, 4),
        ("20 kbp circular genome, 40x 120 bp reads, 0.4% errors, k = 41", g20, True, 120, 0.004, K41, 4),
        ("30 kbp repeat genome, linear, 40x, 0.3% errors, k = 31", adversarial_genome(30_000, 5150), False, 100, 0.003, K, 3),
    ]
    for name, genome, circular, read_len, err, k, min_count in cases:
        codes = simulate_read_codes(genome, read_len, 40, seed=200, error_rate=err, circular=circular)
        cfg = AssemblyConfig(
            k=k, min_count=min_count, tip_rounds=3, bubble_rounds=2,
            read_batch=4096, read_len=read_len, spectrum_capacity=1 << 19,
        )
        got = assemble_codes(codes, cfg, dev)
        reads = [decode_read(c) for c in codes]
        want = assemble_oracle(reads, k, min_count, tip_rounds=3, bubble_rounds=2)
        only_got, only_exp = diff_contig_sets(got.contig_strings, want)
        if only_got or only_exp:
            raise AssertionError(f"{name}: {len(only_got)} extra, {len(only_exp)} missing contigs")
        # the same cleaning by hand, to look at the cleaned graph
        spec, _ = count_spectrum(codes, cfg, dev)
        spec = right_size_spectrum(apply_cutoff(right_size_spectrum(spec), min_count))
        spec, n_tips = clip_tips(spec, k, 3)
        spec, n_bubbles = pop_bubbles(spec, k, 2)
        g = build_graph(spec, k)
        chains = unitig_chains(g, k)
        problems = validate_graph(g, k) + validate_chains(g, chains, k)
        if problems:
            raise AssertionError(f"{name}: the cleaned graph fails its validators: {problems}")
        host = chains_to_contigs(g, chains, k)
        if host != got.contigs or chains_to_contigs_device(g, chains, k) != host:
            raise AssertionError(f"{name}: device and host emissions differ")
        # capacities too small for the output: the rerun with exact ones
        before = trace.totals()
        if extract.chains_to_contigs_device_spec(spec.words, chains, k, 8, 1) != host or trace.since(before)["emit_reruns"] != 1:
            raise AssertionError(f"{name}: the emission's rerun with exact capacities failed")
        print(
            f"cleaning, {name}: {len(got.contigs)} contigs == oracle; tips removed {n_tips} k-mers, "
            f"bubbles {n_bubbles}; validators clean; device emission == host emission, "
            f"also through its rerun with exact capacities"
        )


def phase_cleaned_full(dev, name, inputs, circular, min_coverage, min_contigs) -> int:
    """A full-size run with cleaning, against the substring gate (at least
    ``min_contigs`` contigs; every one of 150 bases or more an exact
    substring; those cover ``min_coverage`` of the genome). A warm-up run,
    then the timed one. Returns the extract kernel's launches in the
    timed run, its result, and the genome, codes and config."""
    import torch

    from tpu_euler_torch.pipeline.assemble import assemble_codes
    from tpu_euler_torch.verify.compare import check_substring_gate, n50

    t0 = time.perf_counter()
    genome, codes, cfg = inputs()
    sim_s = time.perf_counter() - t0
    n_batches = -(-codes.shape[0] // cfg.read_batch)
    rows = n_batches * cfg.read_batch * cfg.windows_per_read
    route = "one-shot" if rows <= cfg.oneshot_rows else "grouped"
    print(
        f"{name}: simulated {len(genome)} bp, {codes.shape[0]} reads in {sim_s:.2f} s; "
        f"{n_batches} batches, {rows} window rows ({route} route), spectrum capacity {cfg.spectrum_capacity}"
    )
    t0 = time.perf_counter()
    assemble_codes(codes, cfg, dev)
    print(f"{name}: warm-up run {time.perf_counter() - t0:.3f} s")

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    targets = [
        ("tpu_euler_torch.pipeline.assemble", "clip_tips"),
        ("tpu_euler_torch.pipeline.assemble", "pop_bubbles"),
        ("tpu_euler_torch.pipeline.assemble", "arena_drain"),
        ("tpu_euler_torch.pipeline.assemble", "right_size_spectrum"),
        ("tpu_euler_torch.euler.clean", "round_graph"),
        ("tpu_euler_torch.euler.extract", "_emission_to_contigs"),
    ]
    seconds = {}
    results = {
        "clip_tips": lambda out: out[1],
        "pop_bubbles": lambda out: out[1],
        "right_size_spectrum": lambda spec: (spec.n, spec.words.shape[0]),
    }
    with call_counts(targets, results, seconds) as calls:
        reset_launches()
        t0 = time.perf_counter()
        res = assemble_codes(codes, cfg, dev)
        wall = time.perf_counter() - t0
        launches = path_launches(name)
    reruns = launched()["emit_reruns"]
    peak = torch.cuda.max_memory_allocated(dev)
    n_tips, n_bubbles, sized = results["clip_tips"][0], results["pop_bubbles"][0], results["right_size_spectrum"]
    lens = [len(c) for c in res.contigs]
    print(
        f"{name}: timed run wall {wall:.4f} s (simulation apart); stages "
        + json.dumps({k: round(v, 4) for k, v in res.stage_seconds.items()})
    )
    print(
        f"{name}: {res.n_reads} reads, {res.n_kmers_counted} windows; distinct k-mers (rows kept) "
        f"{sized[0][0]} ({sized[0][1]}) counted, {sized[1][0]} ({sized[1][1]}) after the cutoff, "
        f"{res.n_distinct_kmers} after cleaning; tips removed {n_tips} k-mers, bubbles {n_bubbles}, "
        f"in {calls['round_graph']} graph-and-walk rounds "
        f"({', '.join(f'{x:.3f}' for x in seconds['round_graph'])} s); {calls['arena_drain']} arena drains"
    )
    print(
        f"{name}: {len(lens)} contigs, {sum(lens)} bases, longest {max(lens)}, N50 {n50(lens)}; "
        f"the emission reran with exact capacities: {'yes' if reruns else 'no'} ({reruns}); "
        f"the emission's pinned copy and host tail {sum(seconds['_emission_to_contigs']):.4f} s; "
        f"peak device memory {peak / 2**30:.3f} GiB (max_memory_allocated {peak} B); "
        f"extract kernel launches {launches}"
    )
    check_substring_gate(name, res.contigs, genome, circular, min_coverage, min_contigs)
    if launches != n_batches:
        raise AssertionError(f"{name}: extract kernel launched {launches} times, expected {n_batches}")
    return launches, res, genome, codes, cfg


def phase_cli(dev, n_gpus: int) -> int:
    """The command line on the default device: assemble with cleaning and
    both checkpoints, both resumes, ``--mesh`` at the GPU count (the command
    starts one NCCL rank a GPU), tour. Returns the extract kernel's
    launches over the phase, the ranks' apart."""
    import io

    from tpu_euler_torch import cli
    from tpu_euler_torch.io import native
    from tpu_euler_torch.io.fastx import read_fasta
    from tpu_euler_torch.oracle import assemble_oracle, diff_contig_sets
    from tpu_euler_torch.simulate import random_genome, simulate_reads

    if not native.native_available():
        raise AssertionError("the native FASTA/FASTQ codec did not build")
    reads = simulate_reads(random_genome(50_000, seed=77), 100, 40, seed=78, error_rate=0.004, circular=True)
    want = assemble_oracle(reads, K, 4, tip_rounds=3, bubble_rounds=2)

    def run(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        if rc != 0:
            raise AssertionError(f"cli {argv[:2]} exited {rc}")
        return json.loads(out.getvalue().strip().splitlines()[-1])

    reset_launches()
    with tempfile.TemporaryDirectory() as d, call_counts([("tpu_euler_torch.io.native", "encode_file_native")]) as calls:
        fq = os.path.join(d, "reads.fq")
        with open(fq, "w") as f:
            for i, r in enumerate(reads):
                f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
        clean = ["-k", str(K), "--min-count", "4", "--tip-rounds", "3", "--bubble-rounds", "2"]
        out = [os.path.join(d, n) for n in ("a.fa", "b.fa", "c.fa", "mesh.fa", "mesh_st.fa")]
        spec, graph = os.path.join(d, "spec.npz"), os.path.join(d, "graph.npz")
        m = run(["assemble", fq, "-o", out[0], "--save-spectrum", spec, "--save-graph", graph] + clean)
        launches = launched()["extract_launches"]
        m_spec = run(["assemble", fq, "-o", out[1], "--resume-spectrum", spec] + clean)
        m_graph = run(["assemble", fq, "-o", out[2], "--resume-graph", graph, "-k", str(K)])
        t0 = time.perf_counter()
        m_mesh = run(["assemble", fq, "-o", out[3], "--mesh", str(n_gpus)] + clean)
        mesh_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        m_st = run(["assemble", fq, "-o", out[4], "--mesh", str(n_gpus), "--shard-traversal"] + clean)
        st_s = time.perf_counter() - t0
        texts = [open(p).read() for p in out]
        contigs = [s for _, s in read_fasta(out[0])]
        tour = run(["tour", fq, "-k", "21", "--min-count", "4"])
        sizes = os.path.getsize(spec), os.path.getsize(graph)
    if len(set(texts)) != 1:
        raise AssertionError("cli: the resumed runs or a --mesh run wrote other contigs than the first run")
    for mm in (m_mesh, m_st):
        if (mm["reads"], mm["kmers_counted"], mm["distinct_kmers"]) != (m["reads"], m["kmers_counted"], m["distinct_kmers"]):
            raise AssertionError("cli: a --mesh run reports other counts")
    if m_st["stages_s"]["gather"] != 0 or "tips" in m_st["stages_s"]:
        raise AssertionError("cli: --shard-traversal gathered the spectrum")
    only_got, only_exp = diff_contig_sets(contigs, want)
    if only_got or only_exp:
        raise AssertionError(f"cli: {len(only_got)} extra, {len(only_exp)} missing contigs against the oracle")
    if calls["encode_file_native"] != 3 or m["reads"] != len(reads):  # the first run and the --mesh runs parse
        raise AssertionError("cli: the input did not go through the native codec")
    total = path_launches("cli")  # the --mesh runs' ranks are processes of their own
    if not (launches > 0 and total > launches):
        raise AssertionError("cli: the extract kernel's launch counter did not move")
    if m_spec["kmers_counted"] != m["kmers_counted"] or m_graph["distinct_kmers"] != m["distinct_kmers"]:
        raise AssertionError("cli: the resumed runs report other counts")
    if not tour["every_edge_once"]:
        raise AssertionError("cli tour: an edge was not used exactly once")
    print("cli assemble: " + json.dumps(m))
    print(
        f"cli: {len(contigs)} contigs == oracle from the first run, --resume-spectrum, --resume-graph, --mesh {n_gpus} "
        f"and --mesh {n_gpus} --shard-traversal "
        f"(checkpoints of {sizes[0]} and {sizes[1]} bytes); input of {len(reads)} reads through the native codec "
        f"({native.SOURCE.name}); packed loader launches {launches} (assemble) + {total - launches} (tour)"
    )
    print(f"cli assemble --mesh {n_gpus} (NCCL ranks started by the command, {mesh_s:.2f} s with their start): " + json.dumps(m_mesh))
    print(f"cli assemble --mesh {n_gpus} --shard-traversal ({st_s:.2f} s with the ranks' start): " + json.dumps(m_st))
    print("cli tour: " + json.dumps(tour))
    return total


def phase_config4(dev):
    """SPEC config 4 at full size on one device: warm-up + timed run.
    Returns (extract launches in the timed run, its result, genome, codes,
    config)."""
    import torch

    from tpu_euler_torch.pipeline.assemble import assemble_codes
    from tpu_euler_torch.simulate import config4_inputs
    from tpu_euler_torch.verify.compare import check_one_contig

    t0 = time.perf_counter()
    genome, codes, cfg = config4_inputs()
    sim_s = time.perf_counter() - t0
    Wb = cfg.read_batch * cfg.windows_per_read
    bpg = cfg.oneshot_rows // Wb
    n_batches = -(-codes.shape[0] // cfg.read_batch)
    print(
        f"config 4: simulated {len(genome)} bp, {codes.shape[0]} paired-end reads in {sim_s:.2f} s; "
        f"{n_batches} batches, {n_batches * Wb} window rows (grouped route), {bpg} batches a group, "
        f"arena of {cfg.spectrum_capacity + bpg * Wb} rows"
    )
    t0 = time.perf_counter()
    assemble_codes(codes, cfg, dev)
    print(f"config 4: warm-up run {time.perf_counter() - t0:.3f} s")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with call_counts([("tpu_euler_torch.pipeline.assemble", "arena_drain")]) as calls:
        reset_launches()
        t0 = time.perf_counter()
        result = assemble_codes(codes, cfg, dev)
        wall = time.perf_counter() - t0
        launches = path_launches("config 4, one device")
    peak = torch.cuda.max_memory_allocated(dev)
    print(
        f"config 4, one device: timed run wall {wall:.4f} s (simulation apart); stages "
        + json.dumps({k: round(v, 4) for k, v in result.stage_seconds.items()})
    )
    print(
        f"config 4, one device: {result.n_reads} reads, {result.n_kmers_counted} windows, "
        f"{result.n_distinct_kmers} distinct k-mers, {len(result.contigs)} contigs; "
        f"{calls['arena_drain']} groups; peak device memory {peak / 2**30:.3f} GiB "
        f"(max_memory_allocated {peak} B); extract kernel launches {launches}"
    )
    check_one_contig("config 4, one device", result.contigs, genome, cfg.k)
    n_groups = -(-n_batches // bpg)
    if (launches, calls["arena_drain"]) != (n_batches, n_groups):
        raise AssertionError(
            f"config 4: {launches} launches, {calls['arena_drain']} groups; expected {n_batches}, {n_groups}"
        )
    return launches, result, genome, codes, cfg


GiB = 2**30


def reckon(cfg, n_reads: int, world: int, on_card: int, shard_traversal: bool) -> dict:
    """The sharded run's largest resident arrays, in bytes, from the
    pipeline's own sizes (``dist/pipeline.py``; ``slab_sizes`` of
    ``dist/traverse_dist.py``), for the ``on_card`` ranks that share one
    card: what must fit before any sort's workspace. ``count`` = a rank's
    spectrum shard, its group buffer and one step's send and receive slabs;
    ``traversal`` = the gathered spectrum (the replicated traversal, which
    then runs the one-device code), or the cut shard, the doubled edges and
    the node-record slabs sent and received (the sharded one)."""
    from tpu_euler_torch.dist.traverse_dist import slab_sizes
    from tpu_euler_torch.kmer import keys

    key_b = 8 * keys.nwords(cfg.k)
    c_dest = int(2.0 * cfg.read_batch * cfg.windows_per_read / world + 256)
    c_local = cfg.spectrum_capacity // world
    n_steps = -(-n_reads // (cfg.read_batch * world))
    bpg = max(1, min(n_steps, cfg.oneshot_rows // (world * c_dest)))
    rec = {
        "c_dest": c_dest, "c_local": c_local, "steps": n_steps, "steps_a_group": bpg,
        "shard": c_local * (key_b + 4),
        "group_buffer": bpg * world * c_dest * key_b,
        "step_slabs": 2 * world * c_dest * key_b,
    }
    rec["count"] = on_card * (rec["shard"] + rec["group_buffer"] + rec["step_slabs"])
    if shard_traversal:
        c_node, _ = slab_sizes(c_local, world, SLAB_FACTORS[0])
        rec.update(c_node=c_node, el_cap=2 * c_local, edges=2 * c_local * (key_b + 1),
                   node_slabs=2 * world * c_node * (key_b + 8))
        rec["traversal"] = on_card * (rec["shard"] + rec["edges"] + rec["node_slabs"])
    else:
        rec["traversal"] = world * c_local * (key_b + 4)
    return rec


def reckon_line(name: str, r: dict, on_card: int, shard_traversal: bool) -> str:
    gib = lambda b: f"{b / GiB:.2f} GiB"  # noqa: E731
    line = (
        f"{name}: reckoned before the run: {r['steps']} steps, {r['steps_a_group']} a group; a rank's shard of "
        f"{r['c_local']} rows {gib(r['shard'])}, group buffer {gib(r['group_buffer'])}, a step's send + receive "
        f"slabs ({r['c_dest']} rows a destination) {gib(r['step_slabs'])}; counting holds {gib(r['count'])} on the "
        f"card ({on_card} rank(s) there); "
    )
    if shard_traversal:
        return line + (
            f"the sharded traversal: el_cap {r['el_cap']} edges a rank ({gib(r['edges'])}), node-record slabs of "
            f"{r['c_node']} rows a destination sent + received {gib(r['node_slabs'])} a rank, "
            f"{gib(r['traversal'])} on the card, before the sorts' workspace"
        )
    return line + f"the gathered spectrum {gib(r['traversal'])} on every rank, then the one-device traversal"


def phase_loopback(name, dev, genome, codes, cfg, single, world: int = 4, warm_up: bool = True):
    """``cfg`` at full size, sharded over ``world`` ranks that this process
    holds on the one card, with the replicated traversal: a warm-up run if
    asked, then the timed run, held to the one-device run ``single``, with
    the reckoned bytes beside the peak. Returns the extract kernel's
    launches in the timed run, and its result."""
    import torch

    from tpu_euler_torch.dist.mesh import LoopbackComm
    from tpu_euler_torch.dist.pipeline import assemble_reads_distributed
    from tpu_euler_torch.verify.compare import check_one_contig, same_assembly

    name = f"{name}, loopback n = {world}"
    comm = LoopbackComm(world, dev)
    r = reckon(cfg, codes.shape[0], world, world, False)
    print(reckon_line(name, r, world, False))
    if warm_up:
        t0 = time.perf_counter()
        assemble_reads_distributed(None, cfg, comm, codes=codes)
        print(f"{name}: warm-up run {time.perf_counter() - t0:.3f} s")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    shard_rows = {"dist_drain_step": lambda out: list(out[0].n)}
    seconds = {}
    with call_counts([("tpu_euler_torch.dist.pipeline", "dist_drain_step")], shard_rows, seconds) as calls:
        reset_launches()
        t0 = time.perf_counter()
        res = assemble_reads_distributed(None, cfg, comm, codes=codes)
        wall = time.perf_counter() - t0
        launches = path_launches(name, sharded=True)
    peak = torch.cuda.max_memory_allocated(dev)
    per_shard = shard_rows["dist_drain_step"][-1]
    print(
        f"{name}: timed run wall {wall:.4f} s{'' if warm_up else ' (no warm-up: the kernels are warm)'}; stages "
        + json.dumps({k: round(v, 4) for k, v in res.stage_seconds.items()})
    )
    print(
        f"{name}: {res.n_reads} reads, {res.n_kmers_counted} windows, "
        f"{res.n_distinct_kmers} distinct k-mers, {len(res.contigs)} contigs; no key dropped in the exchange; "
        f"{calls['dist_drain_step']} group drains ({', '.join(f'{x:.3f}' for x in seconds['dist_drain_step'])} s, host clock); "
        f"k-mers a shard {per_shard} (max / mean {max(per_shard) * world / sum(per_shard):.4f}); "
        f"peak device memory {peak / GiB:.3f} GiB (max_memory_allocated {peak} B) against {r['count'] / GiB:.2f} GiB "
        f"reckoned for counting; extract kernel launches {launches}; "
        f"{res.n_reads / wall:.0f} reads/s, {res.n_kmers_counted / wall:.0f} k-mers/s on the one card"
    )
    check_one_contig(name, res.contigs, genome, cfg.k)
    same_assembly(name, res, single)
    if sum(per_shard) != single.n_distinct_kmers:
        raise AssertionError(f"{name}: the shards hold {sum(per_shard)} k-mers, not {single.n_distinct_kmers}")
    if (launches, calls["dist_drain_step"]) != (r["steps"] * world, -(-r["steps"] // r["steps_a_group"])):
        raise AssertionError(
            f"{name}: {launches} launches, {calls['dist_drain_step']} drains; "
            f"expected {r['steps'] * world}, {-(-r['steps'] // r['steps_a_group'])}"
        )
    return launches, res


SLAB_FACTORS = (2.0, 4.0, 8.0)  # the pipeline's own


def run_sharded_traversal(name, dev, codes, cfg, world: int):
    """One timed run of ``cfg`` over ``world`` loopback ranks with
    ``shard_traversal=True`` (the kernels and the allocator are warm from
    the phases before). Prints its stages, peak and slab sizes. Returns
    (result, extract launches)."""
    import torch

    from tpu_euler_torch.dist.mesh import LoopbackComm
    from tpu_euler_torch.dist.pipeline import assemble_reads_distributed
    from tpu_euler_torch.dist.traverse_dist import _log2_ceil, slab_sizes
    from tpu_euler_torch.profile_config2 import slab_retries

    c_local = cfg.spectrum_capacity // world
    r = reckon(cfg, codes.shape[0], world, world, True)
    print(reckon_line(name, r, world, True))
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    targets = [
        ("tpu_euler_torch.dist.pipeline", "dist_chains_step"),
        ("tpu_euler_torch.dist.pipeline", "dist_tip_step"),
        ("tpu_euler_torch.dist.pipeline", "dist_bubble_step"),
        ("tpu_euler_torch.dist.traverse_dist", "exchange_gather"),
        ("tpu_euler_torch.dist.traverse_dist", "exchange_push"),
    ]
    removed = {"dist_tip_step": lambda out: out[1:], "dist_bubble_step": lambda out: out[1:]}
    seconds = {}
    with slab_retries() as retries, call_counts(targets, removed, seconds) as calls:
        reset_launches()
        t0 = time.perf_counter()
        res = assemble_reads_distributed(None, cfg, LoopbackComm(world, dev), codes=codes, shard_traversal=True)
        wall = time.perf_counter() - t0
        launches = path_launches(name, sharded=True)
    peak = torch.cuda.max_memory_allocated(dev)
    held = SLAB_FACTORS[len(retries)]
    c_node, c_req = slab_sizes(c_local, world, held)
    print(
        f"{name}: timed run wall {wall:.4f} s; stages "
        + json.dumps({k: round(v, 4) for k, v in res.stage_seconds.items()})
    )
    print(
        f"{name}: {res.n_reads} reads, {res.n_kmers_counted} windows, {res.n_distinct_kmers} distinct k-mers, "
        f"{len(res.contigs)} contigs; slab factor {held} held ({len(retries)} retries), so no record or request was "
        f"dropped; el_cap {2 * c_local} edges a rank, E_global {2 * c_local * world}, up to {_log2_ceil(2 * c_local * world) + 1} "
        f"rounds a doubling pass, c_node {c_node}, c_req {c_req}; {calls['dist_chains_step']} chains steps "
        f"({', '.join(f'{x:.3f}' for x in seconds['dist_chains_step'])} s, host clock), {calls['exchange_gather']} request/reply "
        f"gathers and {calls['exchange_push']} pushes; tip steps (edges, drops) {removed.get('dist_tip_step', [])}, "
        f"bubble steps {removed.get('dist_bubble_step', [])}; peak device memory {peak / GiB:.3f} GiB "
        f"(max_memory_allocated {peak} B) against {max(r['count'], r['traversal']) / GiB:.2f} GiB reckoned; "
        f"extract kernel launches {launches}; {res.n_reads / wall:.0f} reads/s, "
        f"{res.n_kmers_counted / wall:.0f} k-mers/s on the one card"
    )
    n_steps = -(-codes.shape[0] // (cfg.read_batch * world))
    if launches != n_steps * world:
        raise AssertionError(f"{name}: extract kernel launched {launches} times, expected {n_steps * world}")
    if res.stage_seconds["gather"] != 0 or "tips" in res.stage_seconds:
        raise AssertionError(f"{name}: the sharded traversal gathered the spectrum")
    return res, launches


def phase_config4_sharded_traversal(dev, genome, codes, cfg, single, replicated, world: int = 4) -> int:
    """Config 4 at full size over ``world`` loopback ranks with the
    traversal sharded, against the one-device run's counts and the
    replicated loopback run's contigs. Returns the extract launches."""
    from tpu_euler_torch.verify.compare import check_one_contig, same_assembly

    name = f"config 4, loopback n = {world}, sharded traversal"
    res, launches = run_sharded_traversal(name, dev, codes, cfg, world)
    check_one_contig(name, res.contigs, genome, cfg.k)
    same_assembly(name, res, single)
    if res.contigs != replicated.contigs:
        raise AssertionError(f"{name}: other contigs than the replicated traversal's")
    print(
        f"{name}: graph {res.stage_seconds['graph']:.4f} s and extract {res.stage_seconds['extract']:.4f} s, against "
        f"the replicated traversal's gather {replicated.stage_seconds['gather']:.4f} + graph "
        f"{replicated.stage_seconds['graph']:.4f} and extract {replicated.stage_seconds['extract']:.4f} s"
    )
    return launches


CONFIG5_CUT_BP = 25_000_000  # config 5's shape with the sharded traversal on one card


def phase_config5_cut_sharded(dev, world: int = 4) -> int:
    """SPEC config 5's shape (k = 41, 40x, its capacity rule) at a genome cut
    to ``CONFIG5_CUT_BP``, on one device and then over ``world`` loopback
    ranks with the traversal sharded: one contig of G + k - 1 bases and the
    one-device run's counts and contig. The full genome's node slabs do not
    fit four ranks on one card. Returns the int8 loader's launches."""
    from tpu_euler_torch.pipeline.assemble import assemble_codes
    from tpu_euler_torch.simulate import config5_inputs
    from tpu_euler_torch.verify.compare import check_one_contig, same_assembly

    name = f"config 5 reduced to {CONFIG5_CUT_BP} bp (genome cut; k, coverage and reads as config 5)"
    t0 = time.perf_counter()
    genome, codes, cfg = config5_inputs(CONFIG5_CUT_BP)
    print(f"{name}: simulated {len(genome)} bp, {codes.shape[0]} reads in {time.perf_counter() - t0:.2f} s; {cfg}")
    t0 = time.perf_counter()
    reset_launches()
    single = assemble_codes(codes, cfg, dev)
    one_s = time.perf_counter() - t0
    path_launches(f"{name}, one device")
    check_one_contig(f"{name}, one device", single.contigs, genome, cfg.k)
    print(
        f"{name}, one device: wall {one_s:.4f} s; stages "
        + json.dumps({k: round(v, 4) for k, v in single.stage_seconds.items()})
    )
    name = f"{name}, loopback n = {world}, sharded traversal"
    res, launches = run_sharded_traversal(name, dev, codes, cfg, world)
    check_one_contig(name, res.contigs, genome, cfg.k)
    same_assembly(name, res, single)
    return launches


def phase_config3_sharded_traversal(dev, genome, codes, cfg, single, world: int = 4) -> int:
    """SPEC config 3 at full size over ``world`` loopback ranks with the
    cutoff, tips, bubbles and traversal sharded: phase 8's gate, and phase
    8's contig set and counts. Returns the extract launches."""
    from tpu_euler_torch.verify.compare import check_substring_gate, same_assembly

    name = f"config 3, loopback n = {world}, sharded traversal"
    res, launches = run_sharded_traversal(name, dev, codes, cfg, world)
    check_substring_gate(name, res.contigs, genome, True, 0.99, 1)
    same_assembly(name, res, single)
    t = single.stage_seconds
    print(
        f"{name}: graph {res.stage_seconds['graph']:.4f} s and extract {res.stage_seconds['extract']:.4f} s, against "
        f"the one-device run's tips {t['tips']:.4f} + graph {t['graph']:.4f} and extract {t['extract']:.4f} s; "
        f"{len(res.contigs)} contigs == the one-device run's"
    )
    return launches


def phase_entry(dev, world: int = 4) -> int:
    """The multi-rank dry run over ``world`` loopback ranks on the card:
    three small assemblies equal to the oracle, the first through a slab
    overflow and its retry. Returns the extract launches."""
    from tpu_euler_torch import entry
    from tpu_euler_torch.dist.mesh import LoopbackComm

    reset_launches()
    t0 = time.perf_counter()
    summary = entry.dryrun_multichip(world, comm=LoopbackComm(world, dev))
    launches = path_launches("entry", sharded=True)
    if summary["retries"] < 1:
        raise AssertionError("entry: the slab overflow's retry did not run")
    if launches == 0:
        raise AssertionError("entry: the extract kernel never launched")
    print(f"entry.dryrun_multichip({world}) on the card in {time.perf_counter() - t0:.2f} s: " + json.dumps(summary))
    return launches


def phase_nccl(genome4, codes4, cfg4, single4) -> int:
    """One rank a GPU over NCCL, at world size ``torch.cuda.device_count()``:
    two small inputs on every rank against the oracle and, with two GPUs
    or more, config 4 against the one-device run. Returns the world size."""
    import numpy as np
    import torch

    from tpu_euler_torch import entry
    from tpu_euler_torch.config import AssemblyConfig
    from tpu_euler_torch.dist.launch import assemble_rank, spawn_ranks
    from tpu_euler_torch.io.encode import encode_reads
    from tpu_euler_torch.oracle import assemble_oracle, diff_contig_sets
    from tpu_euler_torch.simulate import random_genome, simulate_reads
    from tpu_euler_torch.verify.compare import check_one_contig, same_assembly

    world = torch.cuda.device_count()
    small = [
        # the errored input of tests/integration/test_distributed.py:47-58
        ("2.5 kbp genome, 35x, 0.4% errors, k = 21, cutoff 4",
         simulate_reads(random_genome(2500, seed=203), 100, 35, seed=204, circular=True, error_rate=0.004),
         AssemblyConfig(k=21, min_count=4, read_batch=128, read_len=100, spectrum_capacity=1 << 15)),
        ("20 kbp genome, 30x 120 bp reads, k = 41",
         simulate_reads(random_genome(20_000, seed=99), 120, 30, seed=101, circular=True),
         AssemblyConfig(k=K41, read_batch=1024, read_len=120, spectrum_capacity=1 << 18)),
    ]
    with tempfile.TemporaryDirectory() as d:
        for i, (name, reads, cfg) in enumerate(small):
            path = os.path.join(d, f"small{i}.npy")
            np.save(path, encode_reads(reads, cfg.read_len))
            t0 = time.perf_counter()
            results = spawn_ranks(world, "cuda", assemble_rank, (path, cfg), timeout_s=300.0)
            want = assemble_oracle(reads, cfg.k, cfg.min_count)
            for rank, got in enumerate(results):
                only_got, only_exp = diff_contig_sets(got.contig_strings, want)
                if only_got or only_exp or got.n_reads != len(reads):
                    raise AssertionError(f"NCCL, {name}, rank {rank}: {len(only_got)} extra, {len(only_exp)} missing contigs")
            print(
                f"NCCL, world size {world}, {name}: {len(results[0].contigs)} contigs == oracle on every rank "
                f"({results[0].n_kmers_counted} windows; ranks started and joined in {time.perf_counter() - t0:.2f} s)"
            )
        t0 = time.perf_counter()
        summaries = spawn_ranks(world, "cuda", entry.dryrun_rank, timeout_s=600.0)
        if any(sm != summaries[0] or sm["retries"] < 1 for sm in summaries):
            raise AssertionError(f"NCCL: the dry run's ranks disagree or did not retry: {summaries}")
        print(
            f"NCCL, world size {world}: entry.dryrun_multichip == oracle on every rank, through the slab retry "
            f"({time.perf_counter() - t0:.2f} s with the ranks' start): " + json.dumps(summaries[0])
        )
        if world < 2:
            print("NCCL: one GPU, so the collectives ran at world size 1 and config 4 was not run over NCCL")
            return world
        path = os.path.join(d, "config4.npy")
        np.save(path, codes4)
        t0 = time.perf_counter()
        results = spawn_ranks(world, "cuda", assemble_rank, (path, cfg4, False, True), timeout_s=600.0)
        total = time.perf_counter() - t0
        for rank, got in enumerate(results):
            same_assembly(f"config 4, NCCL, rank {rank} of {world}", got, single4)
        check_one_contig(f"config 4, NCCL, world size {world}", results[0].contigs, genome4, cfg4.k)
        print(
            f"config 4, NCCL, world size {world}: every rank == the one-device run; rank 0's stages "
            + json.dumps({k: round(v, 4) for k, v in results[0].stage_seconds.items()})
            + f"; {total:.2f} s with the ranks' start and a warm-up run"
        )
        t0 = time.perf_counter()
        results = spawn_ranks(world, "cuda", assemble_rank, (path, cfg4, False, True, True), timeout_s=900.0)
        total = time.perf_counter() - t0
        for rank, got in enumerate(results):
            same_assembly(f"config 4, NCCL, sharded traversal, rank {rank} of {world}", got, single4)
        print(
            f"config 4, NCCL, world size {world}, sharded traversal: every rank == the one-device run; rank 0's stages "
            + json.dumps({k: round(v, 4) for k, v in results[0].stage_seconds.items()})
            + f"; {total:.2f} s with the ranks' start and a warm-up run"
        )
    return world


def held_labels(dev) -> tuple[dict, dict]:
    """Phase 5b's label kernels on ``bench_tour``'s graph: a whole tour with
    every label call held to the plain doubling at full rounds on the same
    inputs; then, on the paired successors, the ruling label kernels and
    the doubling label kernel held to it, and each timed against the plain
    version and the bound (the ruling set's phases, by the card's clock,
    the median of 5 calls). Returns the two kernels' records for the
    kernels line."""
    import statistics

    import torch

    from tpu_euler_torch import bench_tour, microbench
    from tpu_euler_torch.euler import ranking_kernel as rk
    from tpu_euler_torch.euler.tour import _pair_successors, eulerian_tour

    codes, cfg = bench_tour.tour_inputs()
    g = bench_tour.tour_graph(codes, cfg, dev)
    del codes
    with microbench.held_rounds() as held:
        tour = eulerian_tour(g)
    torch.cuda.synchronize()
    if held["labels"] != tour.merge_rounds + 1:
        raise AssertionError(f"bench_tour graph: {held['labels']} label calls held, {tour.merge_rounds} merge rounds")
    E = g.tail.shape[0]
    rounds = rk.full_label_rounds(E)
    succ, valid = _pair_successors(g), g.edge_valid
    want = rk.jump_labels_plain(succ, valid, rounds)
    recs = {}
    for name, fn in (("ruling_labels", rk.ruling_labels), ("pointer_jump_labels", rk.jump_labels)):
        got = fn(succ, valid, rounds)
        err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
        if err or not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"bench_tour graph: {name} != the plain doubling")
        recs[name] = {"max_abs_err": err, "ms": reset_ms(lambda: fn(succ, valid, rounds), lambda: None, iters=10)}
    plain_ms = reset_ms(lambda: rk.jump_labels_plain(succ, valid, rounds), lambda: None, iters=3)
    b = bound(18 * E, 0)  # succ and valid read once, label and on_cycle written once
    calls = []
    for _ in range(5):
        rk.ruling_labels(succ, valid, rounds)
        calls.append(rk.label_stats())
    stats = {key: calls[0][key] for key in ("rulers", "uncovered", "longest_sublist", "row_rounds", "uncovered_rounds")}
    stats["phase_ms"] = {k: statistics.median(c["phase_ms"][k] for c in calls) for k in calls[0]["phase_ms"]}
    stats["stamped_ms"] = statistics.median(c["stamped_ms"] for c in calls)
    ruling, doubling = recs["ruling_labels"]["ms"], recs["pointer_jump_labels"]["ms"]
    print(
        f"bench_tour graph, E = {E}: {held['labels']} label calls of a tour (the merge rounds' and the cut's) "
        f"== the plain doubling at {rounds} rounds bit for bit (label, on_cycle); {int(want[1].sum())} edges on a "
        f"cycle. ruling_labels {ruling:.4f} ms (1 in {rk.label_stride(E)} ids sampled: "
        f"{stats['rulers']} rulers, longest sublist {stats['longest_sublist']}, {stats['uncovered']} uncovered, "
        f"{stats['row_rounds']} row rounds; phases by the card's clock, ms, median of 5: "
        + json.dumps({k: round(v, 4) for k, v in stats["phase_ms"].items()})
        + f", stamped {stats['stamped_ms']:.4f}); pointer_jump_labels {doubling:.4f} ms ({rounds} rounds); "
        f"plain {plain_ms:.4f} ms; {b['bytes']} bytes, bound {b['bound_ms']:.4f} ms by {b['bound_by']}: "
        f"ruling_labels at {100 * b['bound_ms'] / ruling:.2f}% of it, the doubling at {100 * b['bound_ms'] / doubling:.2f}%"
    )
    common = {"plain_ms": plain_ms, "library_ms": None, "E": E, **b}
    return ({**recs["ruling_labels"], **common, **stats, "ruler_stride": rk.label_stride(E)},
            {**recs["pointer_jump_labels"], **common, "rounds_a_launch": rounds, "ms_a_round": doubling / rounds})


def phase_bench_tour(dev) -> tuple[int, tuple[dict, dict]]:
    """Phase 5b: ``bench_tour`` at full size, against the gate and
    tour_results.json, then the label kernels on its graph
    (``held_labels``). Returns the packed loader's launches (two runs) and
    the label kernels' records."""
    from tpu_euler_torch import bench_tour

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tour_results.json")) as f:
        ref = json.load(f)
    reset_launches()
    t0 = time.perf_counter()
    recs = bench_tour.run(bench_tour.GENOME_BP, dev.type, emit=lambda line: print("bench_tour: " + line))
    phase_s = time.perf_counter() - t0
    launches = path_launches("bench_tour")
    timed = recs[-1]
    if not bench_tour.passed(timed):
        raise AssertionError(f"bench_tour: the tour fails its gate: {timed}")
    for key in ("genome_bp", "edges", "chains", "merge_rounds", "every_edge_once"):
        if timed[key] != ref[key]:
            raise AssertionError(f"bench_tour: {key} {timed[key]} != {ref[key]} (tour_results.json)")
    batches = -(-timed["reads"] // timed["read_batch"])
    if launches != len(recs) * batches:
        raise AssertionError(f"bench_tour: {launches} packed launches, expected {len(recs)} x {batches}")
    print(
        f"bench_tour: {timed['edges']} edges, {timed['chains']} chains, {timed['merge_rounds']} merge round(s), "
        f"every edge once == tour_results.json; edge capacity {timed['edge_capacity']} "
        f"(the reference's {ref['edge_capacity']}); tour {timed['tour_wall_s']:.4f} s (pair "
        f"{timed['pair_s']:.4f}, merge {[round(x, 4) for x in timed['merge_s']]}, cut + rank "
        f"{timed['cut_rank_s']:.4f} s in the split run); {launches} packed launches; phase {phase_s:.2f} s"
    )
    return launches, held_labels(dev)


def phase_microbench_quick(dev) -> None:
    """Phase 5c: every section of ``microbench --quick``; its checks raise."""
    from tpu_euler_torch import microbench

    rec = microbench.run(quick=True, device=dev.type, emit=lambda line: None)
    got = rec["summary"]["sections"]
    missing = [name for name in microbench.SECTIONS if not got.get(name, {}).get("rows")]
    if missing:
        raise AssertionError(f"microbench --quick: no rows from {missing}")
    print(f"microbench --quick: {len(rec['rows'])} rows, {rec['summary']['checks_passed']} checks passed, "
          f"{rec['summary']['wall_s']:.2f} s; rows and seconds a section: "
          + json.dumps({k: [v["rows"], round(v["wall_s"], 2)] for k, v in got.items()}))


def phase_bench_entry(counts: tuple, n_batches: int) -> int:
    """Phase 5d: ``python3 bench_torch.py --reps 1`` from the root, in a
    process of its own, held to phase 4's (reads, windows, distinct k-mers)
    ``counts``. Returns the packed loader's launches in its timed run."""
    import torch

    torch.cuda.empty_cache()  # this process's cached blocks would crowd the bench on the card
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "bench_torch.py", "--reps", "1"], cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=600,
    )
    phase_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"bench_torch.py exited with code {proc.returncode}: {proc.stdout[-1000:]}{proc.stderr[-3000:]}")
    line = proc.stdout.strip().splitlines()[-1]
    print(f"bench_torch.py --reps 1 in {phase_s:.2f} s: {line}")
    rec = json.loads(line)
    d = rec["detail"]
    got = {
        "metric": rec["metric"], "transport": d["transport"], "extract_launches": d["extract_launches"],
        "new_build_files": [r["new_build_files"] for r in d["runs"]],
        "counts": (d["reads"], d["kmers_counted"], d["distinct_kmers"]),
    }
    want = {
        "metric": "wall_clock_4.6Mbp_50x_k31_1xH100", "transport": "packed", "extract_launches": n_batches,
        "new_build_files": [0], "counts": tuple(counts),
    }
    if got != want:
        raise AssertionError(f"bench_torch.py: {got} != {want}")
    print(f"bench_torch.py: {rec['metric']} {rec['value']:.4f} s == phase 4's counts; {n_batches} packed launches, "
          f"no build in the timed run")
    return d["extract_launches"]


def phases_config5(dev, n_gpus: int):
    """Phase 6 (SPEC config 5 on one device), 6b (the same input over four
    loopback ranks, replicated traversal) and 6c (config 5's shape at a cut
    genome, sharded traversal). Returns (the extract kernel's launches on
    each path, and the full-size genome, codes, config and one-device
    result where phase 13b will need them: four GPUs or more; else None)."""
    launches, single, genome, codes, cfg = phase_config5(dev)
    loopback, _ = phase_loopback("config 5", dev, genome, codes, cfg, single, warm_up=False)
    out = {"one_device": launches, "loopback": loopback}
    keep = (genome, codes, cfg, single) if n_gpus >= 4 else None
    del genome, codes, single
    out["reduced_sharded_traversal"] = phase_config5_cut_sharded(dev)
    return out, keep


def phase_nccl_config5(genome, codes, cfg, single, world: int = 4) -> dict:
    """SPEC config 5 at full size over NCCL, one rank a GPU on ``world``
    GPUs: the replicated traversal, then the sharded one (the SPEC's
    config 5 as stated). Every rank must equal the one-device run ``single``
    and launch the int8 loader once a step; the sharded run prints the slab
    factor that held. Each run is a warm-up, a timed run and a profiled run
    (``profile_config2.mesh_rank``). With fewer GPUs it prints that it did
    not run, and why. Returns the int8 loader's launches a rank a run."""
    import numpy as np
    import torch

    from tpu_euler_torch.dist.launch import spawn_ranks
    from tpu_euler_torch.profile_config2 import mesh_rank
    from tpu_euler_torch.verify.compare import check_one_contig, same_assembly

    n_gpus = torch.cuda.device_count()
    if n_gpus < world:
        print(
            f"NCCL, config 5 at full size over {world} GPUs (replicated and sharded traversal): not run: "
            f"{n_gpus} GPU(s) visible"
        )
        return {}
    torch.cuda.empty_cache()  # this process's cached blocks on GPU 0 would crowd rank 0
    n_steps = -(-codes.shape[0] // (cfg.read_batch * world))
    launches = {}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "config5.npy")
        np.save(path, codes)
        for shard_traversal in (False, True):
            name = f"config 5, NCCL, world size {world}" + (", sharded traversal" if shard_traversal else "")
            r = reckon(cfg, codes.shape[0], world, 1, shard_traversal)
            print(reckon_line(name, r, 1, shard_traversal))
            t0 = time.perf_counter()
            ranks = spawn_ranks(world, "cuda", mesh_rank, (path, cfg, shard_traversal), timeout_s=1800.0)
            total = time.perf_counter() - t0
            for rk in ranks:
                same_assembly(f"{name}, rank {rk['rank']}", rk["result"], single)
                if rk["launches"] != [n_steps]:
                    raise AssertionError(f"{name}, rank {rk['rank']}: int8 loader launches {rk['launches']}, expected {n_steps}")
            check_one_contig(name, ranks[0]["result"].contigs, genome, cfg.k)
            res, wall = ranks[0]["result"], ranks[0]["walls"][0]
            held = SLAB_FACTORS[len(ranks[0]["retries"])]
            print(
                f"{name}: every rank == the one-device run; rank 0's timed run wall {wall:.4f} s, stages "
                + json.dumps({k: round(v, 4) for k, v in res.stage_seconds.items()})
            )
            print(
                f"{name}: walls {[round(rk['walls'][0], 4) for rk in ranks]} s; peak device memory a rank "
                f"{[round(rk['peak_gib'], 3) for rk in ranks]} GiB against "
                f"{max(r['count'], r['traversal']) / GiB:.2f} GiB reckoned; device idle share a rank "
                f"{[round(rk['device']['device_idle_share'], 4) for rk in ranks]}; int8 loader launches {n_steps} a rank; "
                f"{res.n_reads / wall / world:.0f} reads/s and {res.n_kmers_counted / wall / world:.0f} k-mers/s a GPU"
                + (f"; slab factor {held} held ({len(ranks[0]['retries'])} retries), so no record or request was dropped"
                   if shard_traversal else "")
                + f"; {total:.2f} s with the ranks' start, a warm-up, the timed and the profiled run"
            )
            launches["sharded" if shard_traversal else "replicated"] = n_steps
            del ranks, res
    return launches


# the single-device paths that walk, by their names in WALK_LAUNCHES, and
# the key of each in the kernels line; the tour ranks by doubling only
WALK_PATHS = {
    "config 2, k=31": "launches", "config 2, k=41": "launches_config2_k41", "config 3": "launches_config3",
    "12 Mbp repeat genome": "launches_repeat_genome", "config 4, one device": "launches_config4",
    "config 5": "launches_config5", "config 4, loopback n = 4": "launches_config4_loopback4",
    "config 5, loopback n = 4": "launches_config5_loopback4", "cli": "launches_cli",
}
JUMP_ONLY_PATHS = {"bench_tour": "launches_bench_tour"}
# the paths that run the tour, by their names in WALK_LAUNCHES, and the key
# of each in the kernels line
LABEL_PATHS = {"bench_tour": "launches_bench_tour", "cli": "launches_cli"}


def walk_kernel_entries(walk_rec: dict, jump_rec: dict) -> list[dict]:
    """The walk and jump kernels' entries of the kernels line, with their
    launches on every path that walks (and the jump kernel's doubling
    rounds); a path on which either never launched fails the run."""
    walk = {key: WALK_LAUNCHES[path][0] for path, key in WALK_PATHS.items()}
    jump_paths = {**WALK_PATHS, **JUMP_ONLY_PATHS}
    jump = {key: WALK_LAUNCHES[path][1] for path, key in jump_paths.items()}
    rounds = {"rounds_jump" + key[len("launches"):]: WALK_LAUNCHES[path][2] for path, key in jump_paths.items()}
    idle = [key for key, n in [*walk.items(), *jump.items()] if n == 0]
    if idle:
        raise AssertionError(f"the walk or pointer-jump kernel never launched on {idle}")
    return [
        {"name": "ruling_walk_round", "route": "cuda", "source": WALK_SOURCE, "replaces": WALK_REPLACES, **walk, **walk_rec},
        {"name": "pointer_jump_doubling", "route": "cuda", "source": WALK_SOURCE, "replaces": JUMP_REPLACES, **jump,
         **rounds, **jump_rec},
    ]


def emit_kernel_entry(emit_rec: dict) -> dict:
    """The canonical emission kernel's entry of the kernels line, with its
    launches on every path that walks but the tour's (which emits no
    contig); a path on which it never launched fails the run."""
    emit = {key: WALK_LAUNCHES[path][6] for path, key in WALK_PATHS.items()}
    idle = [key for key, n in emit.items() if n == 0]
    if idle:
        raise AssertionError(f"the canonical emission kernel never launched on {idle}")
    return {"name": "emit_canonical", "route": "cuda", "source": EMIT_SOURCE, "replaces": EMIT_REPLACES, **emit,
            **emit_rec}


def label_kernel_entries(ruling_rec: dict, doubling_rec: dict) -> list[dict]:
    """The label kernels' entries of the kernels line, with their launches
    on the tour's paths: the ruling label kernels' calls (a path on which
    they never launched fails the run), and the doubling label kernel's
    launches and rounds there (none: the tour takes the ruling set; phase 5b
    holds and times it directly)."""
    ruling = {key: WALK_LAUNCHES[path][5] for path, key in LABEL_PATHS.items()}
    idle = [key for key, n in ruling.items() if n == 0]
    if idle:
        raise AssertionError(f"the ruling label kernels never launched on {idle}")
    doubling = {key: WALK_LAUNCHES[path][3] for path, key in LABEL_PATHS.items()}
    rounds = {"rounds_labels" + key[len("launches"):]: WALK_LAUNCHES[path][4] for path, key in LABEL_PATHS.items()}
    return [
        {"name": "ruling_labels", "route": "cuda", "source": WALK_SOURCE, "replaces": LABELS_REPLACES,
         "launches": ruling["launches_bench_tour"], **ruling, **ruling_rec},
        {"name": "pointer_jump_labels", "route": "cuda", "source": WALK_SOURCE, "replaces": LABELS_REPLACES,
         "launches": doubling["launches_bench_tour"], **doubling, **rounds, **doubling_rec},
    ]


def main(argv=None) -> int:
    import argparse

    t_start = time.perf_counter()
    import torch

    import_s = time.perf_counter() - t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sharded-only", action="store_true", help="run the command-line, config-4 and NCCL phases alone")
    ap.add_argument("--emit-only", action="store_true", help="run the canonical emission kernel's phase (1c) alone")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_euler_torch import _build, probes
    from tpu_euler_torch.euler import ranking_kernel
    from tpu_euler_torch.kmer import extract_kernel
    from tpu_euler_torch.io import native
    from tpu_euler_torch.simulate import adversarial_coverage_floor, adversarial_inputs, config2_inputs, config3_inputs

    dev = torch.device("cuda:0")
    n_gpus = torch.cuda.device_count()
    print(json.dumps({"gpus": {"count": n_gpus, "names": [torch.cuda.get_device_name(i) for i in range(n_gpus)]}}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # one nvcc per source and one g++, started together
    t_build = time.perf_counter()
    builds = (extract_kernel.build, probes.build, ranking_kernel.build, native.native_available)
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        for fut in [pool.submit(b) for b in builds]:
            fut.result()
    if not native.native_available():
        raise SystemExit("chip_smoke: the native FASTA/FASTQ codec did not build")
    builds_s = time.perf_counter() - t_build
    libs = ("extract_canonical", "probes", "ruling_walk", "emit_canonical", "fastx_codec")
    for name in libs:
        info = _build.build_info[name]
        print(f"built {info['path']} in {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print("  " + line.strip())
    # the cold start: nothing is built before this run
    print(json.dumps({"cold_start": {
        "import_torch_s": import_s, "builds_wall_s": builds_s, "to_kernels_ready_s": time.perf_counter() - t_start,
        **{name + "_build_s": _build.build_info[name]["seconds"] for name in libs},
    }}))

    if args.emit_only:
        print(json.dumps({"kernels": [{"name": "emit_canonical", "route": "cuda", "source": EMIT_SOURCE,
                                       "replaces": EMIT_REPLACES, **phase_emit_kernel(dev)}]}))
        print(smi)
        return 0
    if args.sharded_only:
        phase_cli(dev, n_gpus)
        _, single3, genome3, codes3, cfg3 = phase_cleaned_full(
            dev, "config 3", config3_inputs, circular=True, min_coverage=0.99, min_contigs=1
        )
        phase_config3_sharded_traversal(dev, genome3, codes3, cfg3, single3)
        del single3, genome3, codes3
        _, single4, genome4, codes4, cfg4 = phase_config4(dev)
        _, replicated4 = phase_loopback("config 4", dev, genome4, codes4, cfg4, single4)
        phase_config4_sharded_traversal(dev, genome4, codes4, cfg4, single4, replicated4)
        del replicated4
        config5 = phases_config5(dev, n_gpus)[1]
        phase_entry(dev)
        phase_nccl(genome4, codes4, cfg4, single4)
        del single4, genome4, codes4
        if config5 is not None:
            phase_nccl_config5(*config5)
        print(smi)
        return 0

    batch = config2_batch()
    rec = phase_kernel(dev, batch)
    packed_rec = phase_packed_kernel(dev, batch)
    emit_rec = phase_emit_kernel(dev)
    probe_recs = phase_probes(dev, batch)
    del batch
    phase_small_genomes(dev)
    fuzz_launches = phase_fuzz(dev)
    genome, codes, cfg = config2_inputs()
    launches, oneshot = phase_config2(dev, genome, codes, cfg)
    launches_k41, _ = phase_config2(dev, genome, codes, dataclasses.replace(cfg, k=K41))
    route_launches = phase_routes(dev, codes, cfg, oneshot)
    walk_rec, jump_rec = phase_walk_kernels(dev, codes, cfg)
    config2_counts = (oneshot.n_reads, oneshot.n_kmers_counted, oneshot.n_distinct_kmers)
    del genome, codes, oneshot
    launches_tour, label_recs = phase_bench_tour(dev)
    phase_microbench_quick(dev)
    launches_bench = phase_bench_entry(config2_counts, launches)
    launches5, config5 = phases_config5(dev, n_gpus)
    phase_cleaning_small(dev)
    launches_config3, single3, genome3, codes3, cfg3 = phase_cleaned_full(
        dev, "config 3", config3_inputs, circular=True, min_coverage=0.99, min_contigs=1
    )
    launches_repeat = phase_cleaned_full(
        dev, "12 Mbp repeat genome", adversarial_inputs, circular=False,
        min_coverage=adversarial_coverage_floor(), min_contigs=2,
    )[0]
    launches_cli = phase_cli(dev, n_gpus)
    launches_config4, single4, genome4, codes4, cfg4 = phase_config4(dev)
    launches_loopback, replicated4 = phase_loopback("config 4", dev, genome4, codes4, cfg4, single4)
    launches_config4_st = phase_config4_sharded_traversal(dev, genome4, codes4, cfg4, single4, replicated4)
    del replicated4
    launches_config3_st = phase_config3_sharded_traversal(dev, genome3, codes3, cfg3, single3)
    del single3, genome3, codes3
    launches_entry = phase_entry(dev)
    phase_nccl(genome4, codes4, cfg4, single4)
    del single4, genome4, codes4
    nccl5 = phase_nccl_config5(*config5) if config5 is not None else {}
    del config5

    kernels = [
        {
            # the int8 loader: the sharded paths
            "name": "extract_canonical_fill",
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": KERNEL_REPLACES,
            "launches": launches_loopback,
            "launches_config4_loopback4": launches_loopback,
            "launches_config4_sharded_traversal": launches_config4_st,
            "launches_config3_sharded_traversal": launches_config3_st,
            "launches_entry_loopback4": launches_entry,
            "launches_fuzz_skew_loopback4": fuzz_launches["launches_fuzz_skew_loopback4"],
            "launches_config5_loopback4": launches5["loopback"],
            "launches_config5_reduced_sharded_traversal": launches5["reduced_sharded_traversal"],
            **{f"launches_config5_nccl4_{mode}_a_rank": n for mode, n in nccl5.items()},
            **rec,
        },
        {
            # the packed loader: every single-device path
            "name": "extract_canonical_fill_packed",
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": PACKED_REPLACES,
            "launches": launches,
            "launches_k41": launches_k41,
            "launches_grouped": route_launches["grouped"],
            "launches_per_batch": route_launches["per-batch"],
            "launches_bench_tour": launches_tour,
            "launches_bench_entry": launches_bench,
            "launches_config5": launches5["one_device"],
            "launches_config3": launches_config3,
            "launches_repeat_genome": launches_repeat,
            "launches_cli": launches_cli,
            "launches_config4": launches_config4,
            "launches_fuzz": fuzz_launches["launches_fuzz"],
            **packed_rec,
        },
        *walk_kernel_entries(walk_rec, jump_rec),
        *label_kernel_entries(*label_recs),
        emit_kernel_entry(emit_rec),
        *probe_recs,
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": n_gpus}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
