"""Smoke run of the PyTorch port (tpu_euler_torch) on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the fused extract kernel from ``tpu_euler_torch/csrc``, holds it
bit for bit against its plain PyTorch version, assembles two small genomes
and checks them against the port's CPU oracle, then runs SPEC config 2 (4.6
Mbp genome, 50x 100 bp error-free reads, k = 31; the parameters of bench.py)
once to warm up and once timed, and checks that its one contig spells the
genome. Every phase fails by exception, so any fault
gives a non-zero exit and no result line. The last line of output is

    {"ok": true, "device": {"platform": "gpu", "kind": "<card>", "count": 1}}

It imports nothing of JAX or of the reference package ``tpu_euler``, and
needs no network.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

K = 31
KERNEL_SOURCE = "tpu_euler_torch/csrc/extract_canonical.cu"
KERNEL_REPLACES = "tpu_euler/kmer/pallas_extract.py:144"


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


def phase_kernel(dev) -> dict:
    """Kernel vs plain version on the card, bit for bit, and both times."""
    import numpy as np
    import torch

    from tpu_euler_torch.kmer import extract_kernel as xk
    from tpu_euler_torch.pipeline.assemble import encode_reads
    from tpu_euler_torch.simulate import random_genome, simulate_read_codes, simulate_reads

    def compare(codes_np, k, start):
        codes = torch.from_numpy(codes_np).to(dev)
        R, W = codes.shape[0], codes.shape[1] - k + 1
        a = torch.full((start + R * W + 5,), -7, dtype=torch.int64, device=dev)
        b = a.clone()
        na = xk.extract_fill(codes, a, start, k)
        nb = xk.extract_fill_plain(codes, b, start, k)
        torch.cuda.synchronize()
        err = float((a.double() - b.double()).abs().max())
        if not torch.equal(a, b) or int(na) != int(nb):
            raise AssertionError(f"kernel != plain at k={k}, shape {tuple(codes.shape)}")
        return codes, a, err, int(na)

    reads = simulate_reads(random_genome(800, seed=3), read_len=100, coverage=4, seed=4)
    reads[3] = reads[3][:40] + "N" + reads[3][41:]  # an N mid-read
    reads[5] = reads[5][:55]  # a short read, padded with code 4
    small = np.concatenate([encode_reads(reads, 100), np.full((6, 100), 4, np.int8)])
    batch = simulate_read_codes(random_genome(1_000_000, seed=5), 100, (1 << 18) / 10_000, seed=6)
    batch = np.ascontiguousarray(batch[: 1 << 18])
    batch[::997, 50] = 4  # some N
    assert batch.shape == (1 << 18, 100)

    max_err = 0.0
    times = {}
    for k in (21, 31):
        _, _, err, nv = compare(small, k, 37)
        max_err = max(max_err, err)
        print(f"kernel == plain, k={k}, {small.shape[0]} reads incl. N and padding ({nv} valid windows)")
        codes, buf, err, nv = compare(batch, k, 0)
        max_err = max(max_err, err)
        ms = cuda_ms(lambda: xk.extract_fill(codes, buf, 0, k), iters=20)
        plain_ms = cuda_ms(lambda: xk.extract_fill_plain(codes, buf, 0, k), iters=5)
        times[k] = (ms, plain_ms)
        print(
            f"kernel == plain, k={k}, config-2 batch {tuple(batch.shape)} ({nv} valid windows): "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per batch"
        )
    ms, plain_ms = times[K]
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def phase_small_genomes(dev) -> None:
    """Whole port on the card vs the CPU oracle: 20 kbp at 30x, and a
    repeat genome, both at k = 31."""
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
        ("20 kbp genome, 30x", simulate_reads(g20, 100, 30, seed=100, circular=True), 1 << 18),
        ("repeat genome", [grep[i : i + 100] for i in range(0, len(grep) - 99, 3)] + [grep[-100:]], 1 << 14),
    ]
    for name, reads, cap in cases:
        cfg = AssemblyConfig(k=K, read_batch=4096, read_len=100, spectrum_capacity=cap)
        got = assemble_reads(reads, cfg, dev)
        only_got, only_exp = diff_contig_sets(got.contig_strings, assemble_oracle(reads, K))
        if only_got or only_exp:
            raise AssertionError(f"{name}: {len(only_got)} extra, {len(only_exp)} missing contigs")
        print(f"{name}: {len(got.contigs)} contigs == oracle (lengths {sorted(len(c) for c in got.contigs)[-3:]})")


def phase_config2(dev) -> int:
    """SPEC config 2 with bench.py's parameters: warm-up + timed run."""
    import torch

    from tpu_euler_torch.kmer import extract_kernel as xk
    from tpu_euler_torch.oracle import rc
    from tpu_euler_torch.pipeline.assemble import assemble_codes
    from tpu_euler_torch.simulate import config2_inputs

    genome, codes, cfg = config2_inputs()
    t0 = time.perf_counter()
    assemble_codes(codes, cfg, dev)
    print(f"config 2 warm-up run: {time.perf_counter() - t0:.3f} s")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    xk.launches = 0
    t0 = time.perf_counter()
    result = assemble_codes(codes, cfg, dev)
    wall = time.perf_counter() - t0
    launches = xk.launches
    peak = torch.cuda.max_memory_allocated(dev)

    contigs = list(result.contigs)
    print(
        f"config 2 timed run: wall {wall:.4f} s; stages "
        + json.dumps({k: round(v, 4) for k, v in result.stage_seconds.items()})
    )
    print(
        f"config 2: {result.n_reads} reads, {result.n_kmers_counted} windows, "
        f"{result.n_distinct_kmers} distinct k-mers, {len(contigs)} contigs "
        f"of {[len(c) for c in contigs[:3]]} bases; peak device memory "
        f"{peak / 2**30:.3f} GiB; extract kernel launches {launches}"
    )
    if len(contigs) != 1 or len(contigs[0]) != len(genome) + cfg.k - 1:
        raise AssertionError("config 2: expected exactly one contig of G + k - 1 bases")
    # the contig spells the circular genome read from some rotation, on
    # either strand: it, or its reverse complement, lies in genome + genome
    contig, doubled = contigs[0].decode(), genome + genome
    if contig not in doubled and rc(contig) not in doubled:
        raise AssertionError("config 2: the contig does not spell the genome")
    print("config 2: the contig spells the circular genome exactly")
    n_batches = -(-codes.shape[0] // cfg.read_batch)
    if launches != n_batches:
        raise AssertionError(f"extract kernel launched {launches} times, expected {n_batches}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_euler_torch import _build
    from tpu_euler_torch.kmer import extract_kernel

    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    extract_kernel.build()
    info = _build.build_info["extract_canonical"]
    print(f"built {info['path']} in {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    rec = phase_kernel(dev)
    phase_small_genomes(dev)
    launches = phase_config2(dev)

    kernels = [
        {
            "name": "extract_canonical_fill",
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": KERNEL_REPLACES,
            "launches": launches,
            **rec,
        }
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
