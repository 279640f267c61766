"""Seeded genome and read simulators, and the SPEC config-2, -3, -4 and -5
inputs.

The port's own copies of ``tpu_euler/reference_impl/simulate.py``'s
generators (substitution errors, the repeat genomes and the adversarial
profiles of the fuzz tests included): the same
seed gives the same genome, reads and code matrix as the reference's (``tests/torch_port/test_torch_oracle.py`` checks
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


def random_genome(length: int, seed: int = 0, circular: bool = True) -> str:
    """Seeded uniform-random genome string (A/C/G/T). ``circular`` is
    accepted and not used, as in the reference: a genome is circular by how
    its reads are drawn (``simulate_reads``)."""
    rng = np.random.default_rng(seed)
    return bytes(_BASES[rng.integers(0, 4, length)]).decode()


# SPEC config 1's phiX174 (5386 bp, circular): no network, so a seeded
# random genome of its length stands in for it, as in the reference.
PHIX_LENGTH = 5386
PHIX174 = random_genome(PHIX_LENGTH, seed=174, circular=True)


def simulate_reads(
    genome: str,
    read_len: int = 100,
    coverage: float = 30.0,
    seed: int = 0,
    error_rate: float = 0.0,
    circular: bool = True,
) -> list[str]:
    """Uniform shotgun reads from both strands of ``genome``, with
    substitution errors at ``error_rate`` a base."""
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
    if error_rate > 0.0:
        reads = _add_errors(reads, error_rate, rng)
    return reads


def _add_errors(reads: list[str], rate: float, rng: np.random.Generator) -> list[str]:
    """Each base, with probability ``rate``, becomes a different base. The
    draws follow the reference's order, read by read."""
    lut = np.zeros(256, np.int64)
    lut[_BASES] = np.arange(4)
    out = []
    for r in reads:
        arr = np.frombuffer(r.encode(), dtype=np.uint8).copy()
        mask = rng.random(len(arr)) < rate
        if mask.any():
            shift = rng.integers(1, 4, mask.sum())
            arr[mask] = _BASES[(lut[arr[mask]] + shift) % 4]
        out.append(bytes(arr).decode())
    return out


def simulate_read_codes(
    genome: str,
    read_len: int = 100,
    coverage: float = 30.0,
    seed: int = 0,
    error_rate: float = 0.0,
    circular: bool = True,
) -> np.ndarray:
    """The same read model as ``simulate_reads``, vectorized: [R, read_len]
    int8 codes (A, C, G, T = 0..3). A read is a row gathered from the
    genome's windows (the genome continued cyclically where it is
    circular), so no offset matrix is built."""
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
    windows = np.lib.stride_tricks.sliding_window_view(np.resize(g, G + read_len - 1) if circular else g, read_len)
    codes = windows[starts]
    flip = rng.integers(0, 2, n_reads).astype(bool)
    codes[flip] = (3 - codes[flip])[:, ::-1]
    if error_rate > 0.0:
        chunk = 1 << 22  # bounds the error draws' intermediates
        for lo in range(0, n_reads, chunk):
            c = codes[lo : lo + chunk]
            mask = rng.random(c.shape) < error_rate
            shift = rng.integers(1, 4, c.shape).astype(np.int8)
            codes[lo : lo + chunk] = np.where(mask, (c + shift) % 4, c)
    return codes


def simulate_paired_read_codes(
    genome: str,
    read_len: int = 100,
    coverage: float = 30.0,
    seed: int = 0,
    insert_size: int = 300,
    circular: bool = True,
    chunk: int = 1 << 22,
) -> np.ndarray:
    """Paired-end reads as [2 * n_frag, read_len] int8 codes: a fragment of
    ``insert_size`` bases gives a forward mate (its first ``read_len``
    bases, an even row) and a reverse-complement mate (its last
    ``read_len`` bases, the odd row after it). Fragments are drawn in one
    call and cut in chunks, which bounds the int64 offset intermediate."""
    rng = np.random.default_rng(seed)
    lut = np.full(256, 4, dtype=np.int8)
    lut[_BASES] = np.arange(4, dtype=np.int8)
    g = lut[np.frombuffer(genome.encode(), dtype=np.uint8)]
    G = len(g)
    n_frag = int(np.ceil(coverage * G / (2 * read_len)))
    max_start = G if circular else G - insert_size + 1
    if max_start <= 0:
        raise ValueError("genome shorter than insert size")
    starts = rng.integers(0, max_start, n_frag)
    out = np.empty((2 * n_frag, read_len), np.int8)
    rl = np.arange(read_len)[None, :]
    for lo in range(0, n_frag, chunk):
        s = starts[lo : lo + chunk]
        o1 = s[:, None] + rl
        o2 = o1 + (insert_size - read_len)
        if circular:
            o1, o2 = o1 % G, o2 % G
        out[2 * lo : 2 * lo + 2 * len(s) : 2] = g[o1]
        out[2 * lo + 1 : 2 * lo + 1 + 2 * len(s) : 2] = (3 - g[o2])[:, ::-1]
    return out


def tandem_repeat_genome(
    length: int, unit_len: int = 37, seed: int = 0, mutation_rate: float = 0.0, flank: int = 200
) -> str:
    """Random flanks around a tandem array of one repeat unit; a
    ``mutation_rate`` above 0 puts point mutations into the copies, so that
    near-identical copies make bubbles."""
    rng = np.random.default_rng(seed)
    unit = _BASES[rng.integers(0, 4, unit_len)]
    n_copies = max(1, (length - 2 * flank) // unit_len)
    arr = np.tile(unit, n_copies)
    if mutation_rate > 0.0:
        mask = rng.random(arr.size) < mutation_rate
        shift = rng.integers(1, 4, arr.size)
        lut = np.zeros(256, np.int64)
        lut[_BASES] = np.arange(4)
        arr = np.where(mask, _BASES[(lut[arr] + shift) % 4], arr)
    left = _BASES[rng.integers(0, 4, flank)]
    right = _BASES[rng.integers(0, 4, max(0, length - 2 * flank - arr.size) + flank)]
    return bytes(np.concatenate([left, arr, right])[:length]).decode()


def homopolymer_genome(length: int, seed: int = 0, run_rate: float = 0.02, max_run: int = 30) -> str:
    """Random genome with runs of one base (5 to ``max_run`` bases) that
    start at a base with probability ``run_rate``: k-mers equal to their own
    shift, so self-loop edges and cycles of period one."""
    rng = np.random.default_rng(seed)
    out = np.empty(length + max_run, np.uint8)
    i = 0
    while i < length:
        if rng.random() < run_rate:
            n = int(rng.integers(5, max_run + 1))
            out[i : i + n] = _BASES[rng.integers(0, 4)]
            i += n
        else:
            out[i] = _BASES[rng.integers(0, 4)]
            i += 1
    return bytes(out[:length]).decode()


def skewed_genome(length: int, seed: int = 0, gc: float = 0.8) -> str:
    """A genome of G + C share ``gc``: its k-mers crowd a corner of the key
    space, which loads the hash owners and the sort segments unevenly."""
    rng = np.random.default_rng(seed)
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    return bytes(_BASES[rng.choice(4, size=length, p=p)]).decode()


def dinucleotide_repeat_genome(length: int, seed: int = 0, array_len: int = 400) -> str:
    """Random genome with an (AC)n array of ``array_len`` bases in its
    middle: cycles of two k-mers, each the other's shift, and (GT)n on the
    other strand."""
    rng = np.random.default_rng(seed)
    g = _BASES[rng.integers(0, 4, length)]
    mid = (length - array_len) // 2
    g[mid : mid + array_len] = np.tile(np.frombuffer(b"AC", dtype=np.uint8), array_len // 2 + 1)[:array_len]
    return bytes(g).decode()


def interspersed_repeat_genome(
    length: int, seed: int = 0, repeat_len: int = 300, n_copies: int = 6
) -> str:
    """Random backbone with one ``repeat_len`` element pasted at ``n_copies``
    random loci that do not overlap: each copy's ends are branch nodes."""
    rng = np.random.default_rng(seed)
    g = _BASES[rng.integers(0, 4, length)]
    elem = _BASES[rng.integers(0, 4, repeat_len)]
    population = max(1, (length - repeat_len) // repeat_len)
    slots = rng.choice(population, size=min(n_copies, population), replace=False) * repeat_len
    for s in slots:
        g[s : s + repeat_len] = elem
    return bytes(g).decode()


def adversarial_genome(bp: int, seed: int) -> str:
    """The repeat genome of scripts/fullscale_adversarial.py:32-47: twelve
    copies of a 3 kbp element in a random backbone, then a mutated tandem
    array of a 53-base unit over the last sixtieth; linear."""
    main = interspersed_repeat_genome(bp - bp // 60, seed=seed, repeat_len=3000, n_copies=12)
    return main + tandem_repeat_genome(bp // 60, unit_len=53, seed=seed + 1, mutation_rate=0.01)


def config2_inputs(
    seed: int = CONFIG2_SEED, genome_bp: int = CONFIG2_GENOME_BP
) -> tuple[str, np.ndarray, AssemblyConfig]:
    """(genome, [2.3 M, 100] int8 read codes, config) of SPEC config 2;
    ``genome_bp`` cuts the genome for tests."""
    genome = random_genome(genome_bp, seed=seed)
    codes = simulate_read_codes(
        genome, read_len=CONFIG2.read_len, coverage=CONFIG2_COVERAGE, seed=seed + 1, circular=True
    )
    return genome, codes, CONFIG2


# SPEC config 3 as scripts/run_configs.py:71-73 runs it at scale 1.0: the
# 4.6 Mbp random circular genome (that script's seed for this length), 40x
# 100 bp reads with 0.4% substitution errors, a cutoff of 4, three rounds of
# tip clipping and two of bubble popping at k = 31. The spectrum must hold
# the error k-mers too before the cutoff, about five times the genome's.
CONFIG3_GENOME_BP = 4_600_000
CONFIG3_COVERAGE = 40
CONFIG3_ERROR_RATE = 0.004
CONFIG3_GENOME_SEED = CONFIG3_GENOME_BP % 10000
CONFIG3_READ_SEED = 42
CONFIG3 = AssemblyConfig(
    k=31, min_count=4, tip_rounds=3, bubble_rounds=2,
    read_batch=1 << 18, read_len=100, spectrum_capacity=1 << 25,
)


def config3_inputs(
    genome_bp: int = CONFIG3_GENOME_BP, seed: int | None = None
) -> tuple[str, np.ndarray, AssemblyConfig]:
    """(genome, [1.84 M, 100] int8 read codes, config) of SPEC config 3;
    ``genome_bp`` cuts the genome for tests; ``seed`` seeds the genome and
    ``seed + 1`` the reads in place of the script's two seeds."""
    genome_seed, read_seed = (CONFIG3_GENOME_SEED, CONFIG3_READ_SEED) if seed is None else (seed, seed + 1)
    genome = random_genome(genome_bp, seed=genome_seed)
    codes = simulate_read_codes(
        genome, read_len=CONFIG3.read_len, coverage=CONFIG3_COVERAGE, seed=read_seed,
        error_rate=CONFIG3_ERROR_RATE, circular=True,
    )
    return genome, codes, CONFIG3


# The repeat genome at full size as scripts/fullscale_adversarial.py:157-212
# runs it: 12 Mbp, linear, 40x 100 bp reads with 0.3% errors, cutoff 3,
# three tip and two bubble rounds at k = 31; 336 M window rows, so the
# grouped counting route.
ADVERSARIAL_GENOME_BP = 12_000_000
ADVERSARIAL_SEED = 5150
ADVERSARIAL = AssemblyConfig(
    k=31, min_count=3, tip_rounds=3, bubble_rounds=2,
    read_batch=1 << 18, read_len=100, spectrum_capacity=1 << 26,
)


def adversarial_coverage_floor(genome_bp: int = ADVERSARIAL_GENOME_BP) -> float:
    """The share of the repeat genome that its contigs of 150 bases or more
    must cover: the repeats collapse, the tandem array spells once and
    eleven of the twelve interspersed copies fold into one
    (scripts/fullscale_adversarial.py:205), and 60 kbp more may break at
    them. Not above 0 where the genome is cut below that structure."""
    return 1.0 - (genome_bp // 60 + 11 * 3000 + 60_000) / genome_bp


def adversarial_inputs(
    genome_bp: int = ADVERSARIAL_GENOME_BP, seed: int = ADVERSARIAL_SEED
) -> tuple[str, np.ndarray, AssemblyConfig]:
    """(genome, [4.8 M, 100] int8 read codes, config) of the full-size
    repeat-genome run; ``genome_bp`` cuts the genome."""
    genome = adversarial_genome(genome_bp, seed)
    codes = simulate_read_codes(
        genome, read_len=100, coverage=40, seed=seed + 1, error_rate=0.003, circular=False
    )
    return genome, codes, ADVERSARIAL


# SPEC config 4 as scripts/run_full_configs.py:63-72 runs it: a 12 Mbp random
# circular genome (yeast scale) read as 60x error-free paired-end 100 bp
# reads from 300-base fragments, assembled at k = 31. 7.2 M reads give
# 504 M window rows, beyond ``oneshot_rows``: the grouped counting route at
# one-word keys.
CONFIG4_GENOME_BP = 12_000_000
CONFIG4_COVERAGE = 60
CONFIG4_INSERT = 300
CONFIG4_GENOME_SEED = 404
CONFIG4_READ_SEED = 405
CONFIG4 = AssemblyConfig(k=31, read_batch=1 << 18, read_len=100, spectrum_capacity=1 << 25)


def config4_inputs(
    genome_bp: int = CONFIG4_GENOME_BP, seed: int | None = None
) -> tuple[str, np.ndarray, AssemblyConfig]:
    """(genome, [7.2 M, 100] int8 read codes, config) of SPEC config 4;
    ``genome_bp`` cuts the genome for tests; ``seed`` seeds the genome and
    ``seed + 1`` the reads in place of the script's two seeds."""
    genome_seed, read_seed = (CONFIG4_GENOME_SEED, CONFIG4_READ_SEED) if seed is None else (seed, seed + 1)
    genome = random_genome(genome_bp, seed=genome_seed)
    codes = simulate_paired_read_codes(
        genome, read_len=CONFIG4.read_len, coverage=CONFIG4_COVERAGE, seed=read_seed,
        insert_size=CONFIG4_INSERT,
    )
    return genome, codes, CONFIG4


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


# Random functional graphs for the ruling walk, as (seed, E, n_paths,
# n_cycles, max_len, tbits): sublists longer than the walk's cap, ruler-free
# cycles, several cuts a cycle (a tiny key alphabet), cycles of one or two
# elements and self-loops.
FUNCTIONAL_GRAPHS = (
    (0, 600, 10, 8, 40, 32),
    (1, 3000, 2, 4, 700, 32),  # sublists longer than WALK_CAP
    (2, 1200, 0, 80, 10, 32),  # many ruler-free cycles
    (3, 900, 15, 15, 50, 2),  # tiny key alphabet: several cuts per cycle
    (4, 400, 0, 200, 2, 32),  # hundreds of 1-2 cycles incl. self-loops
)


def functional_graph(rng: np.random.Generator, E: int, n_paths: int, n_cycles: int, max_len: int, n_invalid: int):
    """(succ [E] int64, valid [E] bool): disjoint random paths and cycles
    over a shuffled subset of [0, E), ``n_invalid`` invalid elements after
    them, and up to three self-loops."""
    succ = np.full(E, -1, np.int64)
    valid = np.ones(E, bool)
    perm = rng.permutation(E)
    i = 0
    for cyc, n in ((False, n_paths), (True, n_cycles)):
        for _ in range(n):
            ids = perm[i : i + int(rng.integers(1, max_len + 1))]
            i += ids.size
            succ[ids[:-1]] = ids[1:]
            if cyc:
                succ[ids[-1]] = ids[0]
    valid[perm[i : i + n_invalid]] = False
    for e in np.flatnonzero((succ < 0) & valid)[:3]:
        succ[e] = e  # self-loops
    return succ, valid


def functional_graph_inputs(seed: int, E: int, n_paths: int, n_cycles: int, max_len: int, tbits: int):
    """One case of ``FUNCTIONAL_GRAPHS``: (succ, valid, transition keys as
    [E, 2] uint32 limbs of ``tbits`` random bits each)."""
    rng = np.random.default_rng(seed)
    succ, valid = functional_graph(rng, E, n_paths, n_cycles, max_len, E // 10)
    t = rng.integers(0, 2**tbits, size=(E, 2), dtype=np.uint32)
    return succ, valid, t
