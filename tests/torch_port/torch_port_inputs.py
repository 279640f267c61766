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


def reads_with_tips(genome, n_tips=6, seed=0):
    """Clean circular reads plus repeated chimeric reads (a genome window
    whose tail is random) that survive a cutoff of 3 and form tips
    [tests/integration/test_tips.py]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    reads = simulate_reads(genome, read_len=100, coverage=25, seed=seed + 1, circular=True)
    for _ in range(n_tips):
        pos = int(rng.integers(0, len(genome) - 100))
        junk = "".join("ACGT"[c] for c in rng.integers(0, 4, 30))
        reads.extend([(genome[pos : pos + 70] + junk)[:100]] * 5)
    return reads


def reads_with_bubbles(genome, n_bubbles=4, seed=0, read_len=100, bad_copies=4):
    """Clean circular reads plus repeated reads with one substitution in
    the middle: simple bubbles [tests/integration/test_bubbles.py]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    reads = simulate_reads(genome, read_len=read_len, coverage=25, seed=seed + 1, circular=True)
    for _ in range(n_bubbles):
        pos = int(rng.integers(0, len(genome) - read_len))
        w = list(genome[pos : pos + read_len])
        mid = read_len // 2
        w[mid] = "ACGT"[("ACGT".index(w[mid]) + 1 + int(rng.integers(0, 3))) % 4]
        reads.extend(["".join(w)] * bad_copies)
    return reads


def dirty_reads(seed=0):
    """Tips and bubbles on one 2.5 kbp genome [tests/unit/test_clean_big.py]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    genome = random_genome(2500, seed=seed + 1)
    reads = simulate_reads(genome, read_len=100, coverage=25, seed=seed + 2, circular=True)
    for _ in range(3):
        p = int(rng.integers(0, len(genome) - 100))
        junk = "".join("ACGT"[c] for c in rng.integers(0, 4, 30))
        reads.extend([(genome[p : p + 70] + junk)[:100]] * 5)
    for _ in range(3):
        p = int(rng.integers(0, len(genome) - 100))
        w = list(genome[p : p + 100])
        w[50] = "ACGT"[("ACGT".index(w[50]) + 1) % 4]
        reads.extend(["".join(w)] * 5)
    return reads


def counted_spectrum(reads, k: int, min_count: int, capacity: int = 1 << 13, read_len: int = 100):
    """Reference spectrum of ``reads`` after the cutoff, at ``capacity``."""
    cfg = AssemblyConfig(k=k, read_batch=256, read_len=read_len, spectrum_capacity=capacity, min_count=min_count)
    spec, _ = count_spectrum(encode_reads(reads, read_len), cfg, {})
    return apply_cutoff(spec, min_count)


def sharded_spectrum(reads, k: int, n_dev: int, c_local: int):
    """The k-mer spectrum of ``reads`` as the sharded counting leaves it:
    every canonical k-mer on the rank ``bucket_hash % n_dev``, each shard
    key-sorted and padded with zero rows to ``c_local``. Built from the
    oracle's counter, with no device code.

    Returns numpy (limbs [n_dev * c_local, L] uint32, counts [n_dev *
    c_local] int32, n [n_dev] int32)."""
    import numpy as np

    from tpu_euler.kmer import keys
    from tpu_euler.reference_impl.oracle import count_canonical_kmers

    counter = count_canonical_kmers(reads, k)
    kmers = sorted(counter)  # ACGT order is the key order
    rows = keys.encode_np(kmers, k)
    owner = np.asarray(keys.bucket_hash(rows)) % n_dev
    L = rows.shape[1]
    limbs = np.zeros((n_dev, c_local, L), np.uint32)
    counts = np.zeros((n_dev, c_local), np.int32)
    n = np.zeros(n_dev, np.int32)
    cnt = np.array([counter[s] for s in kmers], np.int32)
    for r in range(n_dev):
        mine = owner == r
        n[r] = mine.sum()
        assert n[r] < c_local
        limbs[r, : n[r]] = rows[mine]
        counts[r, : n[r]] = cnt[mine]
    return limbs.reshape(n_dev * c_local, L), counts.reshape(-1), n


def port_shards(limbs, counts, n, k: int, n_dev: int):
    """``sharded_spectrum``'s arrays (or a reference step's outputs) as the
    port's per-rank lists (words, counts, n)."""
    import numpy as np
    import torch

    from tpu_euler_torch import convert
    from tpu_euler_torch.kmer import keys

    return (
        [convert.limbs_to_words(b, "cpu", keys.nwords(k)) for b in np.split(np.asarray(limbs), n_dev)],
        [torch.from_numpy(np.array(b, dtype=np.int32)) for b in np.split(np.asarray(counts), n_dev)],
        [int(x) for x in np.asarray(n)],
    )


def cycle_and_repeat_reads(err: float = 0.01, seed: int = 31):
    """Reads of a circular genome with a repeat (branching nodes) and of a
    small circular plasmid (a pure cycle in the graph), with errors, so
    that a cutoff matters and tips and bubbles exist without one."""
    rep = random_genome(150, seed=seed)
    genome = random_genome(700, seed=seed + 1) + rep + random_genome(500, seed=seed + 2) + rep
    plasmid = random_genome(260, seed=seed + 3)
    return (
        simulate_reads(genome, read_len=80, coverage=14, seed=seed + 4, error_rate=err, circular=True)
        + simulate_reads(plasmid, read_len=80, coverage=14, seed=seed + 5, circular=True)
    )
