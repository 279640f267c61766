"""The fuzz cases of the reference's ``tests/integration/test_fuzz.py``, run
through the port against its CPU oracle on any device.

* ``PROFILES`` (:21-45): six adversarial genomes of 2,500 bases, each with
  the structure uniform random genomes lack: tandem repeats (plain and
  mutated), homopolymer runs (self-loop edges), a GC skew with errors and
  cleaning, interspersed repeats, a microsatellite (cycles of two k-mers).
* ``trial_case`` (:101-135): eight seeded trials, each drawing its genome
  length, k, coverage, error rate, cleaning rounds, circularity and read
  length from ``default_rng(7000 + trial)`` in the reference's order.
* ``skew_case`` (:68-98): a 3,000-base genome of 88% G + C, sharded over
  four ranks with the traversal sharded, where the key skew would overload
  one hash owner's slab if the scrambling failed.

Each ``run_*`` assembles on ``device`` and raises ``AssertionError`` where
the contig set differs from the oracle's; the CPU tests
(``tests/torch_port/test_torch_fuzz.py``) and ``chip_smoke.py`` both call
them.
"""

from __future__ import annotations

import numpy as np

from tpu_euler_torch import simulate
from tpu_euler_torch.config import AssemblyConfig
from tpu_euler_torch.oracle import assemble_oracle, diff_contig_sets
from tpu_euler_torch.pipeline.assemble import assemble_reads

GENOME_BP = 2500
GENOME_SEED = 4242
READ_SEED = 4300
N_TRIALS = 8

# (name, genome(length, seed), k, coverage, error rate, min_count, tip rounds, bubble rounds)
PROFILES = [
    ("tandem_repeat", lambda n, s: simulate.tandem_repeat_genome(n, unit_len=37, seed=s), 21, 25, 0.0, 1, 0, 0),
    ("tandem_mutated", lambda n, s: simulate.tandem_repeat_genome(n, unit_len=53, seed=s, mutation_rate=0.01),
     25, 30, 0.0, 1, 0, 0),
    ("homopolymer", lambda n, s: simulate.homopolymer_genome(n, seed=s, run_rate=0.03, max_run=40), 21, 25, 0.0, 1, 0, 0),
    ("gc_skew_errored", lambda n, s: simulate.skewed_genome(n, seed=s, gc=0.85), 21, 30, 0.005, 3, 2, 2),
    ("interspersed", lambda n, s: simulate.interspersed_repeat_genome(n, seed=s, repeat_len=200, n_copies=5),
     31, 25, 0.0, 1, 0, 0),
    ("microsatellite", lambda n, s: simulate.dinucleotide_repeat_genome(n, seed=s, array_len=300), 21, 25, 0.0, 1, 0, 0),
]


def _check(name: str, got, reads, cfg: AssemblyConfig) -> set[str]:
    want = assemble_oracle(
        reads, cfg.k, cfg.min_count, tip_rounds=cfg.tip_rounds, bubble_rounds=cfg.bubble_rounds
    )
    extra, missing = diff_contig_sets(got.contig_strings, want)
    if extra or missing or not want:
        raise AssertionError(f"{name}: {len(extra)} extra / {len(missing)} missing of {len(want)} oracle contigs")
    return want


def run_profile(i: int, device) -> int:
    """Profile i at 2,500 bases; returns its contig count."""
    name, genome_fn, k, cov, err, min_count, tips, bubbles = PROFILES[i]
    genome = genome_fn(GENOME_BP, GENOME_SEED)
    reads = simulate.simulate_reads(genome, read_len=100, coverage=cov, seed=READ_SEED, error_rate=err, circular=False)
    cfg = AssemblyConfig(
        k=k, min_count=min_count, tip_rounds=tips, bubble_rounds=bubbles,
        read_batch=512, read_len=100, spectrum_capacity=1 << 16,
    )
    return len(_check(f"profile {name}", assemble_reads(reads, cfg, device), reads, cfg))


def trial_case(trial: int) -> dict:
    """The parameters of seeded trial ``trial``, drawn as the reference
    draws them."""
    rng = np.random.default_rng(7000 + trial)
    glen = int(rng.integers(800, 4000))
    k = int(rng.choice([17, 21, 25, 31, 41]))
    cov = float(rng.integers(12, 35))
    err = float(rng.choice([0.0, 0.0, 0.003, 0.008]))
    min_count = 1 if err == 0.0 else int(rng.integers(3, 5))
    tips = int(rng.choice([0, 0, 2])) if err else 0
    bubbles = int(rng.choice([0, 2, 3])) if err else 0
    circular = bool(rng.integers(0, 2))
    read_len = int(rng.choice([70, 100, 140]))
    if read_len <= k:
        read_len = k + 30
    return dict(
        glen=glen, k=k, cov=cov, err=err, min_count=min_count, tips=tips, bubbles=bubbles,
        circular=circular, read_len=read_len,
    )


def run_trial(trial: int, device) -> int:
    """Seeded trial ``trial``: the oracle's contigs, and for an error-free
    run at 15x or more every contig a substring of the genome (of its
    rotations where it is circular) or of its reverse complement. Returns
    the contig count."""
    c = trial_case(trial)
    genome = simulate.random_genome(c["glen"], seed=8000 + trial)
    reads = simulate.simulate_reads(
        genome, read_len=c["read_len"], coverage=c["cov"], seed=9000 + trial,
        error_rate=c["err"], circular=c["circular"],
    )
    cfg = AssemblyConfig(
        k=c["k"], min_count=c["min_count"], tip_rounds=c["tips"], bubble_rounds=c["bubbles"],
        read_batch=512, read_len=c["read_len"], spectrum_capacity=1 << 16,
    )
    got = assemble_reads(reads, cfg, device)
    _check(f"trial {trial} {c}", got, reads, cfg)
    if c["err"] == 0.0 and c["cov"] >= 15:
        circ = c["circular"]
        ref = genome + genome if circ else genome
        ref_rc = simulate.rc(genome) * (2 if circ else 1)
        for contig in got.contig_strings:
            body = contig[: len(genome)] if circ else contig
            if body not in ref and body not in ref_rc:
                raise AssertionError(f"trial {trial}: a contig of {len(contig)} bases is not in the genome")
    return len(got.contigs)


def run_skew(comm) -> int:
    """The GC-skewed genome sharded over ``comm``'s ranks with the traversal
    sharded; returns its contig count."""
    from tpu_euler_torch.dist.pipeline import assemble_reads_distributed

    genome = simulate.skewed_genome(3000, seed=77, gc=0.88)
    reads = simulate.simulate_reads(genome, read_len=100, coverage=20, seed=78, circular=False)
    cfg = AssemblyConfig(k=21, read_batch=256, read_len=100, spectrum_capacity=1 << 14)
    got = assemble_reads_distributed(reads, cfg, comm, shard_traversal=True)
    return len(_check(f"skew over {comm.world} ranks", got, reads, cfg))
