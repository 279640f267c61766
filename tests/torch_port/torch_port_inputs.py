"""Seeded inputs shared by the port's parity tests (imports JAX)."""

from tpu_euler.config import AssemblyConfig
from tpu_euler.io.encode import encode_reads
from tpu_euler.kmer.count import apply_cutoff
from tpu_euler.pipeline.assemble import count_spectrum, right_size_spectrum
from tpu_euler.reference_impl.simulate import random_genome, simulate_reads


def repeat_genome() -> str:
    """Two copies of a 300 bp repeat in unique sequence (branching graph)."""
    rep = random_genome(300, seed=61)
    return (
        random_genome(800, seed=62) + rep + random_genome(700, seed=63)
        + rep + random_genome(600, seed=64)
    )


def genome(kind: str) -> str:
    return random_genome(2500, seed=13) if kind == "circular" else repeat_genome()


def cut_spectrum(kind: str, k: int, capacity: int, err: float = 0.0, min_count: int = 1):
    """Reference spectrum of reads of ``genome(kind)``, right-sized and cut,
    exactly as ``spectrum_to_contigs`` prepares it for the graph stage."""
    reads = simulate_reads(
        genome(kind), read_len=80, coverage=15, seed=7, error_rate=err,
        circular=kind == "circular",
    )
    cfg = AssemblyConfig(k=k, read_batch=256, read_len=80, spectrum_capacity=capacity)
    acc, _ = count_spectrum(encode_reads(reads, 80), cfg)
    return apply_cutoff(right_size_spectrum(acc), min_count)
