"""Seeded genome and read simulators, and the SPEC config-2 and -5 inputs.

The port's own copies of ``tpu_euler/reference_impl/simulate.py``'s
error-free generators: the same seed gives the same genome, reads and code
matrix as the reference's (``tests/torch_port/test_torch_oracle.py`` checks
it), so a machine without the reference package can make the same inputs.
"""

from __future__ import annotations

import numpy as np

from tpu_euler_torch.config import AssemblyConfig

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP = str.maketrans("ACGT", "TGCA")

# SPEC config 2 with the parameters of bench.py: a 4.6 Mbp random circular
# genome read as 50x error-free 100 bp reads, assembled at k = 31.
CONFIG2_GENOME_BP = 4_600_000
CONFIG2_COVERAGE = 50
CONFIG2_SEED = 2024
CONFIG2 = AssemblyConfig(k=31, read_batch=1 << 18, read_len=100, spectrum_capacity=1 << 23)


def rc(s: str) -> str:
    return s.translate(_COMP)[::-1]


def random_genome(length: int, seed: int = 0) -> str:
    """Seeded uniform-random genome string (A/C/G/T)."""
    rng = np.random.default_rng(seed)
    return bytes(_BASES[rng.integers(0, 4, length)]).decode()


def simulate_reads(
    genome: str, read_len: int = 100, coverage: float = 30.0, seed: int = 0, circular: bool = True
) -> list[str]:
    """Uniform error-free shotgun reads from both strands of ``genome``."""
    rng = np.random.default_rng(seed)
    g = genome + genome[: max(read_len, 300)] if circular else genome
    max_start = len(genome) if circular else len(genome) - read_len + 1
    if max_start <= 0:
        raise ValueError("genome shorter than read length")
    n_frag = int(np.ceil(coverage * len(genome) / read_len))
    starts = rng.integers(0, max_start, n_frag)
    strands = rng.integers(0, 2, n_frag)
    reads = []
    for s, st in zip(starts, strands):
        r = g[s : s + read_len]
        if len(r) == read_len:
            reads.append(rc(r) if st else r)
    return reads


def simulate_read_codes(
    genome: str, read_len: int = 100, coverage: float = 30.0, seed: int = 0, circular: bool = True
) -> np.ndarray:
    """The same read model as ``simulate_reads``, vectorized: [R, read_len]
    int8 codes (A, C, G, T = 0..3)."""
    rng = np.random.default_rng(seed)
    lut = np.full(256, 4, dtype=np.int8)
    lut[_BASES] = np.arange(4, dtype=np.int8)
    g = lut[np.frombuffer(genome.encode(), dtype=np.uint8)]
    G = len(g)
    n_reads = int(np.ceil(coverage * G / read_len))
    max_start = G if circular else G - read_len + 1
    if max_start <= 0:
        raise ValueError("genome shorter than read length")
    starts = rng.integers(0, max_start, n_reads)
    codes = np.empty((n_reads, read_len), np.int8)
    rl = np.arange(read_len)[None, :]
    chunk = 1 << 22  # bounds the int64 offset intermediate
    for lo in range(0, n_reads, chunk):
        s = starts[lo : lo + chunk]
        offs = (s[:, None] + rl) % G if circular else s[:, None] + rl
        codes[lo : lo + len(s)] = g[offs]
    flip = rng.integers(0, 2, n_reads).astype(bool)
    codes[flip] = (3 - codes[flip])[:, ::-1]
    return codes


def config2_inputs(seed: int = CONFIG2_SEED) -> tuple[str, np.ndarray, AssemblyConfig]:
    """(genome, [2.3 M, 100] int8 read codes, config) of SPEC config 2."""
    genome = random_genome(CONFIG2_GENOME_BP, seed=seed)
    codes = simulate_read_codes(
        genome, read_len=CONFIG2.read_len, coverage=CONFIG2_COVERAGE, seed=seed + 1, circular=True
    )
    return genome, codes, CONFIG2


# SPEC config 5 as scripts/run_full_configs.py:97-123 runs it: a 100 Mbp
# random circular genome (C. elegans scale) read as 40x error-free 100 bp
# reads, assembled at k = 41.
CONFIG5_GENOME_BP = 100_000_000
CONFIG5_COVERAGE = 40
CONFIG5_SEED = 505


def config5_cfg(genome_bp: int = CONFIG5_GENOME_BP) -> AssemblyConfig:
    """Config 5's settings: ~G distinct k-mers with a 1.2x margin (not a
    power of two), node arrays at 1.15x the edge count."""
    return AssemblyConfig(
        k=41,
        read_batch=1 << 18,
        read_len=100,
        spectrum_capacity=max(1 << 24, int(1.2 * genome_bp)),
        node_cap_factor=1.15,
    )


def config5_inputs(
    genome_bp: int = CONFIG5_GENOME_BP, seed: int = CONFIG5_SEED
) -> tuple[str, np.ndarray, AssemblyConfig]:
    """(genome, [40 M, 100] int8 read codes, config) of SPEC config 5;
    ``genome_bp`` cuts the genome for tests."""
    genome = random_genome(genome_bp, seed=seed)
    codes = simulate_read_codes(
        genome, read_len=100, coverage=CONFIG5_COVERAGE, seed=seed + 1, circular=True
    )
    return genome, codes, config5_cfg(genome_bp)
