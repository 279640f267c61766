"""Smoke run of the PyTorch port (tpu_euler_torch) on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the port's kernels from ``tpu_euler_torch/csrc`` (one nvcc per
source, started together) and then, phase by phase:

1. holds the fused extract kernel bit for bit against its plain PyTorch
   version at k = 21, 31 (one int64 word per key), 33, 41 (two words), 63,
   75 (three) and 95 (four), on reads with an N, a short read and padding
   rows, and at the config-2 batch shape, and times both at k = 31, 41 and
   63;
2. runs the five TPU compiler probes (``python -m tpu_euler_torch.probes``)
   through their kernels against the scripts' own expectations, then holds
   each kernel against its plain version and times both, and probe 3 also at
   the config-2 batch at k = 31 and 41;
3. assembles four small genomes on the card and checks them against the
   port's CPU oracle: 20 kbp at k = 31, 41 and 63, and a repeat genome;
4. runs SPEC config 2 (4.6 Mbp genome, 50x 100 bp error-free reads; the
   parameters of bench.py) at k = 31, then at k = 41 (SPEC config 5's k) on
   the same reads, each once to warm up and once timed, and checks that the
   one contig spells the genome;
5. runs config 2's reads at k = 31 through the grouped counting route
   (groups of 4, 4 and 1 batches) and the per-batch route, each of which
   must give the one-shot run's counts and contig;
6. runs SPEC config 5 at full size (100 Mbp genome, 40x 100 bp reads,
   k = 41; scripts/run_full_configs.py:97-123): 153 batches counted in 13
   arena groups, one walk, one contig of 100,000,040 bases that must spell
   the genome.

Every phase fails by exception, so any fault gives a non-zero exit and no
result line. Kernel launch counts are read from the run each kernel's path
makes (phases 4-6 for the extract kernel, each run on its own; the probes'
own run for the probes), after setting them to 0 just before it. The last
line of output is

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
import time

K = 31
K41 = 41  # SPEC config 5's k: two int64 words per key
K63 = 63  # three words per key
KS_CHECKED = (21, K, 33, K41, K63, 75, 95)  # 95 leaves 6 windows per read, four words
KERNEL_SOURCE = "tpu_euler_torch/csrc/extract_canonical.cu"
KERNEL_REPLACES = "tpu_euler/kmer/pallas_extract.py:144"
PROBE_SOURCE = "tpu_euler_torch/csrc/probes.cu"
PROBE_REPLACES = {
    "lane_slices": "scripts/debug_pallas2.py:33",
    "extract_stages": "scripts/debug_pallas3.py:44",
    "shift_terms": "scripts/debug_pallas4.py:59",
    "u32_shifts": "scripts/debug_pallas5.py:45",
    "hoisted_and_roll": "scripts/debug_pallas6.py:51",
}


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

    max_err = 0.0
    times = {}
    for k in KS_CHECKED:
        _, _, err, nv = compare(small, k, 37)
        max_err = max(max_err, err)
        print(f"kernel == plain, k={k}, {small.shape[0]} reads incl. N and padding ({nv} valid windows)")
        codes, buf, err, nv = compare(batch, k, 0)
        max_err = max(max_err, err)
        if k not in (K, K41, K63):
            print(f"kernel == plain, k={k}, config-2 batch {tuple(batch.shape)} ({nv} valid windows)")
            continue
        ms = cuda_ms(lambda: xk.extract_fill(codes, buf, 0, k), iters=20)
        plain_ms = cuda_ms(lambda: xk.extract_fill_plain(codes, buf, 0, k), iters=5)
        times[k] = (ms, plain_ms)
        print(
            f"kernel == plain, k={k}, config-2 batch {tuple(batch.shape)} ({nv} valid windows): "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per batch"
        )
        del codes, buf
    return {
        "max_abs_err": max_err,
        "ms": times[K][0],
        "plain_ms": times[K][1],
        "ms_k41": times[K41][0],
        "plain_ms_k41": times[K41][1],
        "ms_k63": times[K63][0],
        "plain_ms_k63": times[K63][1],
    }


def phase_probes(dev, batch) -> list[dict]:
    """The probes' own run (kernels vs the scripts' expectations) with the
    launch counts read around it; then each kernel vs its plain version,
    bit for bit, with both times; probe 3 also at the config-2 batch."""
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

    recs = {}
    for name, probe, plain, x, _ in probes.cases((K, K41)):
        xd = torch.from_numpy(x).to(dev)
        got, want = probe(xd), plain(xd)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"probe {name}: kernel != plain")
        ms = cuda_ms(lambda: probe(xd), iters=50)
        plain_ms = cuda_ms(lambda: plain(xd), iters=10)
        print(f"probe {name}: kernel == plain, {tuple(x.shape)}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        key = name.split()[0]
        if key not in recs:
            recs[key] = {"max_abs_err": max_abs_err(got, want), "ms": ms, "plain_ms": plain_ms}
        else:
            recs[key]["max_abs_err"] = max(recs[key]["max_abs_err"], max_abs_err(got, want))
    codes = torch.from_numpy(batch).to(dev)
    for k in (K, K41):
        got = probes.extract_stages(codes, k)
        want = probes.extract_stages_plain(codes, k)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"probe extract_stages: kernel != plain at the config-2 batch, k={k}")
        recs["extract_stages"]["max_abs_err"] = max(recs["extract_stages"]["max_abs_err"], max_abs_err(got, want))
        del got, want
        ms = cuda_ms(lambda: probes.extract_stages(codes, k), iters=10)
        plain_ms = cuda_ms(lambda: probes.extract_stages_plain(codes, k), iters=3)
        recs["extract_stages"][f"ms_config2_k{k}"] = ms
        recs["extract_stages"][f"plain_ms_config2_k{k}"] = plain_ms
        print(
            f"probe extract_stages: kernel == plain, config-2 batch {tuple(batch.shape)}, k={k}: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
        )
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


def check_one_contig(name, contigs, genome, k) -> None:
    """Exactly one contig of G + k - 1 bases that spells the circular genome
    read from some rotation, on either strand: it, or its reverse
    complement, lies in genome + genome."""
    from tpu_euler_torch.oracle import rc

    contigs = list(contigs)
    if len(contigs) != 1 or len(contigs[0]) != len(genome) + k - 1:
        raise AssertionError(f"{name}: expected exactly one contig of G + k - 1 bases")
    contig, doubled = contigs[0].decode(), genome + genome
    if contig not in doubled and rc(contig) not in doubled:
        raise AssertionError(f"{name}: the contig does not spell the genome")
    print(f"{name}: the contig of {len(contig)} bases spells the circular genome exactly")


@contextlib.contextmanager
def call_counts(targets):
    """Count calls of module functions that the pipeline looks up at call
    time (for the group count and the walk), without changing them."""
    import importlib

    counts = {name: 0 for _, name in targets}
    saved = []
    try:
        for mod_name, name in targets:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, name)
            saved.append((mod, name, fn))

            def wrapped(*a, _fn=fn, _name=name, **kw):
                counts[_name] += 1
                return _fn(*a, **kw)

            setattr(mod, name, wrapped)
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def phase_config2(dev, genome, codes, cfg):
    """SPEC config 2's reads at ``cfg.k``: warm-up + timed run. Returns the
    extract kernel's launches in the timed run, and its result."""
    import torch

    from tpu_euler_torch.kmer import extract_kernel as xk
    from tpu_euler_torch.pipeline.assemble import assemble_codes

    t0 = time.perf_counter()
    assemble_codes(codes, cfg, dev)
    print(f"config 2, k={cfg.k}: warm-up run {time.perf_counter() - t0:.3f} s")

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
        f"config 2, k={cfg.k}: timed run wall {wall:.4f} s; stages "
        + json.dumps({k: round(v, 4) for k, v in result.stage_seconds.items()})
    )
    print(
        f"config 2, k={cfg.k}: {result.n_reads} reads, {result.n_kmers_counted} windows, "
        f"{result.n_distinct_kmers} distinct k-mers, {len(contigs)} contigs "
        f"of {[len(c) for c in contigs[:3]]} bases; peak device memory "
        f"{peak / 2**30:.3f} GiB; extract kernel launches {launches}"
    )
    check_one_contig(f"config 2, k={cfg.k}", contigs, genome, cfg.k)
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

    from tpu_euler_torch.kmer import extract_kernel as xk
    from tpu_euler_torch.pipeline.assemble import assemble_codes

    Wb = cfg.read_batch * cfg.windows_per_read
    n_batches = -(-codes.shape[0] // cfg.read_batch)
    launches = {}
    for route, rows, drains in (("grouped", 4 * Wb, -(-n_batches // 4)), ("per-batch", 0, 0)):
        torch.cuda.synchronize()
        with call_counts([("tpu_euler_torch.pipeline.assemble", "arena_drain")]) as calls:
            xk.launches = 0
            t0 = time.perf_counter()
            res = assemble_codes(codes, dataclasses.replace(cfg, oneshot_rows=rows), dev)
            wall = time.perf_counter() - t0
            launches[route] = xk.launches
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


def phase_config5(dev) -> int:
    """SPEC config 5 at full size, once (the kernels are warm from config
    2). Returns the extract kernel's launches in the run."""
    import torch

    from tpu_euler_torch.kmer import extract_kernel as xk
    from tpu_euler_torch.pipeline.assemble import assemble_codes
    from tpu_euler_torch.simulate import config5_inputs

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
        xk.launches = 0
        t0 = time.perf_counter()
        result = assemble_codes(codes, cfg, dev)
        wall = time.perf_counter() - t0
        launches = xk.launches
    peak = torch.cuda.max_memory_allocated(dev)
    print(
        f"config 5: wall {wall:.4f} s (simulation {sim_s:.2f} s apart); stages "
        + json.dumps({k: round(v, 4) for k, v in result.stage_seconds.items()})
    )
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
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_euler_torch import _build, probes
    from tpu_euler_torch.kmer import extract_kernel
    from tpu_euler_torch.simulate import config2_inputs

    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # one nvcc per source, started together
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for fut in [pool.submit(extract_kernel.build), pool.submit(probes.build)]:
            fut.result()
    for name in ("extract_canonical", "probes"):
        info = _build.build_info[name]
        print(f"built {info['path']} in {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print("  " + line.strip())

    batch = config2_batch()
    rec = phase_kernel(dev, batch)
    probe_recs = phase_probes(dev, batch)
    del batch
    phase_small_genomes(dev)
    genome, codes, cfg = config2_inputs()
    launches, oneshot = phase_config2(dev, genome, codes, cfg)
    launches_k41, _ = phase_config2(dev, genome, codes, dataclasses.replace(cfg, k=K41))
    route_launches = phase_routes(dev, codes, cfg, oneshot)
    del genome, codes, oneshot
    launches_config5 = phase_config5(dev)

    kernels = [
        {
            "name": "extract_canonical_fill",
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": KERNEL_REPLACES,
            "launches": launches,
            "launches_k41": launches_k41,
            "launches_grouped": route_launches["grouped"],
            "launches_per_batch": route_launches["per-batch"],
            "launches_config5": launches_config5,
            **rec,
        },
        *probe_recs,
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
