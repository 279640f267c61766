"""The port's own config, encoder, simulators and CPU oracle vs the
reference's: same fields, same codes, same seeded inputs, same contig sets."""

import dataclasses

import numpy as np
import pytest

from tpu_euler.config import AssemblyConfig as RefConfig
from tpu_euler.io.encode import encode_reads as ref_encode_reads
from tpu_euler.reference_impl import oracle as ref_oracle
from tpu_euler.reference_impl import simulate as ref_sim
from tpu_euler_torch import oracle, simulate
from tpu_euler_torch.config import AssemblyConfig
from tpu_euler_torch.pipeline.assemble import encode_reads
from torch_port_inputs import repeat_genome


def test_config_fields_match_reference():
    ref = RefConfig()
    for f in dataclasses.fields(AssemblyConfig):
        assert getattr(AssemblyConfig(), f.name) == getattr(ref, f.name), f.name
    assert AssemblyConfig(k=21, read_len=90).windows_per_read == RefConfig(k=21, read_len=90).windows_per_read
    for bad in ({"k": 22}, {"k": 1}, {"k": 31, "read_len": 30}):
        with pytest.raises(ValueError):
            AssemblyConfig(**bad)


def test_encode_reads_matches_reference():
    reads = ["ACGTN", "acgtacgtTT", "", "GGXCA" * 30, b"TTGCA"]
    np.testing.assert_array_equal(encode_reads(reads, 100), ref_encode_reads(reads, 100))
    np.testing.assert_array_equal(encode_reads(reads, 7), ref_encode_reads(reads, 7))


@pytest.mark.parametrize("circular", [True, False])
@pytest.mark.parametrize("seed", [0, 5])
def test_simulators_match_reference(circular, seed):
    g = simulate.random_genome(3000, seed=seed)
    assert g == ref_sim.random_genome(3000, seed=seed)
    assert simulate.simulate_reads(g, 90, 12, seed=seed + 1, circular=circular) == ref_sim.simulate_reads(
        g, 90, 12, seed=seed + 1, circular=circular
    )
    np.testing.assert_array_equal(
        simulate.simulate_read_codes(g, 90, 12, seed=seed + 2, circular=circular),
        ref_sim.simulate_read_codes(g, 90, 12, seed=seed + 2, circular=circular),
    )


@pytest.mark.parametrize("genome_bp,read_len", [(60, 100), (99, 100), (100, 100), (101, 100), (5000, 150)])
def test_read_codes_wrap_a_circular_genome_like_the_reference(genome_bp, read_len):
    """Reads are rows of the genome's windows, the genome continued
    cyclically: equal to the reference's modular offsets, also where a read
    is longer than the genome and wraps more than once."""
    g = simulate.random_genome(genome_bp, seed=genome_bp)
    got = simulate.simulate_read_codes(g, read_len, 30, seed=7, circular=True)
    np.testing.assert_array_equal(got, ref_sim.simulate_read_codes(g, read_len, 30, seed=7, circular=True))
    assert got.flags["C_CONTIGUOUS"] and got.flags["WRITEABLE"]


@pytest.mark.parametrize("circular", [True, False])
@pytest.mark.parametrize("chunk", [1 << 22, 7])
def test_paired_simulator_matches_reference(circular, chunk):
    """Paired-end codes: the same draws, mates interleaved, also when the
    fragments are cut in several chunks."""
    g = simulate.random_genome(3000, seed=21)
    kw = dict(read_len=90, coverage=12, seed=22, insert_size=260, circular=circular, chunk=chunk)
    got = simulate.simulate_paired_read_codes(g, **kw)
    np.testing.assert_array_equal(got, ref_sim.simulate_paired_read_codes(g, **kw))
    assert got.shape == (2 * 200, 90) and got.dtype == np.int8
    with pytest.raises(ValueError, match="insert size"):
        simulate.simulate_paired_read_codes(g[:200], insert_size=300, circular=False)


def test_config4_inputs_are_run_full_configs_config4():
    """scripts/run_full_configs.py:63-72 at a cut genome length: the same
    genome, paired-end codes and settings; at full size the grouped route."""
    G = 6000
    genome, codes, cfg = simulate.config4_inputs(genome_bp=G)
    assert genome == ref_sim.random_genome(G, seed=404)
    np.testing.assert_array_equal(
        codes, ref_sim.simulate_paired_read_codes(genome, read_len=100, coverage=60, seed=405, insert_size=300)
    )
    ref_cfg = RefConfig(k=31, read_batch=1 << 18, read_len=100, spectrum_capacity=1 << 25)
    for f in dataclasses.fields(AssemblyConfig):
        assert getattr(cfg, f.name) == getattr(ref_cfg, f.name), f.name
    assert simulate.CONFIG4_GENOME_BP == 12_000_000 and codes.shape == (G * 60 // 100, 100)
    n_reads = 12_000_000 * 60 // 100
    n_batches = -(-n_reads // cfg.read_batch)
    assert n_batches == 28 and n_reads * cfg.windows_per_read == 504_000_000
    assert n_batches * cfg.read_batch * cfg.windows_per_read > cfg.oneshot_rows  # the grouped route


def test_config2_inputs_are_bench_config2():
    """The same config-2 arguments as bench.py, at a cut genome length."""
    assert simulate.CONFIG2 == AssemblyConfig(k=31, read_batch=1 << 18, read_len=100, spectrum_capacity=1 << 23)
    g = simulate.random_genome(5000, seed=simulate.CONFIG2_SEED)
    assert g == simulate.random_genome(simulate.CONFIG2_GENOME_BP, seed=simulate.CONFIG2_SEED)[:5000]


def test_config5_inputs_are_run_full_configs_config5():
    """scripts/run_full_configs.py:97-123 at a cut genome length: the same
    genome, read codes and settings."""
    G = 4000
    genome, codes, cfg = simulate.config5_inputs(genome_bp=G)
    assert genome == ref_sim.random_genome(G, seed=505)
    np.testing.assert_array_equal(codes, ref_sim.simulate_read_codes(genome, read_len=100, coverage=40, seed=506, circular=True))
    ref_cfg = RefConfig(k=41, read_batch=1 << 18, read_len=100, spectrum_capacity=max(1 << 24, int(1.2 * G)), node_cap_factor=1.15)
    for f in dataclasses.fields(AssemblyConfig):
        assert getattr(cfg, f.name) == getattr(ref_cfg, f.name), f.name
    full = simulate.config5_cfg()
    assert (full.spectrum_capacity, full.k, full.node_cap_factor) == (120_000_000, 41, 1.15)
    assert simulate.CONFIG5_GENOME_BP == 100_000_000 and codes.shape == (G * 40 // 100, 100)


def _reads(case):
    if case == "circular":
        return ref_sim.simulate_reads(ref_sim.random_genome(2000, seed=3), 80, 20, seed=4)
    if case == "repeat":
        g = repeat_genome()
        return [g[i : i + 100] for i in range(0, len(g) - 99, 3)] + [g[-100:]]
    if case == "errors":
        g = ref_sim.random_genome(1500, seed=5)
        return ref_sim.simulate_reads(g, 80, 30, seed=6, error_rate=0.01)
    if case == "dinucleotide":  # short (AC)n cycles
        return ref_sim.simulate_reads(ref_sim.dinucleotide_repeat_genome(1200, seed=7), 80, 20, seed=8)
    # palindromic cycle: a self-reverse-complement cycle splits into two arcs
    return ["ACGTACGT" * 6 + "N" + "ACGCGT"]


@pytest.mark.parametrize("case", ["circular", "repeat", "errors", "dinucleotide", "palindrome"])
@pytest.mark.parametrize("k", [5, 21])
def test_oracle_matches_reference(case, k):
    reads = _reads(case)
    for min_count in (1, 3):
        got = oracle.assemble_oracle(reads, k, min_count)
        assert got == ref_oracle.assemble_oracle(reads, k, min_count)
    assert oracle.diff_contig_sets(got, [c.encode() for c in got]) == (set(), set())
    assert oracle.diff_contig_sets({oracle.rc(c) for c in got}, got) == (set(), set())


@pytest.mark.parametrize("circular", [True, False])
@pytest.mark.parametrize("rate", [0.004, 0.05])
def test_error_simulators_match_reference(circular, rate):
    """Substitution errors: the same draws in the same order."""
    g = simulate.random_genome(3000, seed=9)
    kw = dict(error_rate=rate, circular=circular)
    assert simulate.simulate_reads(g, 90, 12, seed=10, **kw) == ref_sim.simulate_reads(g, 90, 12, seed=10, **kw)
    got = simulate.simulate_read_codes(g, 90, 12, seed=11, **kw)
    np.testing.assert_array_equal(got, ref_sim.simulate_read_codes(g, 90, 12, seed=11, **kw))
    clean = simulate.simulate_read_codes(g, 90, 12, seed=11, circular=circular)
    assert 0 < (got != clean).mean() < 2 * rate


def test_repeat_genomes_match_reference():
    for kw in ({}, {"mutation_rate": 0.01, "unit_len": 53}, {"flank": 50, "unit_len": 7}):
        assert simulate.tandem_repeat_genome(2000, seed=3, **kw) == ref_sim.tandem_repeat_genome(2000, seed=3, **kw)
    for kw in ({}, {"repeat_len": 3000, "n_copies": 12}, {"repeat_len": 900, "n_copies": 9}):
        assert simulate.interspersed_repeat_genome(40_000, seed=4, **kw) == ref_sim.interspersed_repeat_genome(40_000, seed=4, **kw)
    assert simulate.interspersed_repeat_genome(500, seed=4) == ref_sim.interspersed_repeat_genome(500, seed=4)
    bp = 60_000
    want = ref_sim.interspersed_repeat_genome(bp - bp // 60, seed=5150, repeat_len=3000, n_copies=12) + (
        ref_sim.tandem_repeat_genome(bp // 60, unit_len=53, seed=5151, mutation_rate=0.01)
    )
    assert simulate.adversarial_genome(bp, 5150) == want and len(want) == bp


@pytest.mark.parametrize("seed", [0, 77, 4242])
def test_adversarial_profile_genomes_match_reference(seed):
    """The fuzz profiles' genomes: homopolymer runs, a GC skew, a
    microsatellite array, and the phiX174 stand-in."""
    for kw in ({}, {"run_rate": 0.03, "max_run": 40}):
        assert simulate.homopolymer_genome(2500, seed=seed, **kw) == ref_sim.homopolymer_genome(2500, seed=seed, **kw)
    for gc in (0.8, 0.85, 0.88):
        assert simulate.skewed_genome(3000, seed=seed, gc=gc) == ref_sim.skewed_genome(3000, seed=seed, gc=gc)
    for kw in ({}, {"array_len": 300}):
        assert simulate.dinucleotide_repeat_genome(2500, seed=seed, **kw) == ref_sim.dinucleotide_repeat_genome(
            2500, seed=seed, **kw
        )
    assert simulate.random_genome(900, seed, circular=False) == ref_sim.random_genome(900, seed, circular=False)
    assert simulate.PHIX_LENGTH == ref_sim.PHIX_LENGTH == len(simulate.PHIX174)
    assert simulate.PHIX174 == ref_sim.PHIX174


def test_config3_inputs_are_run_configs_config3():
    """scripts/run_configs.py:71-73 at a cut genome length: that script's
    genome seed for 4.6 Mbp, its read seed, rate, coverage and cleaning."""
    G = 5000
    genome, codes, cfg = simulate.config3_inputs(genome_bp=G)
    assert genome == ref_sim.random_genome(G, seed=hash(4_600_000) % 10000)
    np.testing.assert_array_equal(
        codes, ref_sim.simulate_read_codes(genome, read_len=100, coverage=40, seed=42, error_rate=0.004, circular=True)
    )
    ref_cfg = RefConfig(k=31, min_count=4, tip_rounds=3, bubble_rounds=2, read_batch=1 << 18, read_len=100, spectrum_capacity=1 << 25)
    for f in dataclasses.fields(AssemblyConfig):
        assert getattr(cfg, f.name) == getattr(ref_cfg, f.name), f.name
    assert simulate.CONFIG3_GENOME_BP == 4_600_000
    n_reads = 4_600_000 * 40 // 100
    assert -(-n_reads // cfg.read_batch) == 8  # batches, so kernel launches, at full size
    assert 8 * cfg.read_batch * cfg.windows_per_read <= cfg.oneshot_rows  # the one-shot route


def test_adversarial_inputs_are_fullscale_adversarial_run_full():
    G = 30_000
    genome, codes, cfg = simulate.adversarial_inputs(genome_bp=G)
    assert genome == simulate.adversarial_genome(G, 5150)
    np.testing.assert_array_equal(
        codes, ref_sim.simulate_read_codes(genome, read_len=100, coverage=40, seed=5151, error_rate=0.003, circular=False)
    )
    ref_cfg = RefConfig(k=31, min_count=3, tip_rounds=3, bubble_rounds=2, read_batch=1 << 18, read_len=100, spectrum_capacity=1 << 26)
    for f in dataclasses.fields(AssemblyConfig):
        assert getattr(cfg, f.name) == getattr(ref_cfg, f.name), f.name
    full_rows = -(-(12_000_000 * 40 // 100) // cfg.read_batch) * cfg.read_batch * cfg.windows_per_read
    assert full_rows > cfg.oneshot_rows  # the grouped route at full size


@pytest.mark.parametrize("k", [5, 21])
def test_oracle_with_cleaning_matches_reference(k):
    reads = _reads("errors")
    for kw in ({"tip_rounds": 3}, {"bubble_rounds": 2}, {"tip_rounds": 2, "bubble_rounds": 2, "tip_len": 12, "bubble_len": 30}):
        assert oracle.assemble_oracle(reads, k, 2, **kw) == ref_oracle.assemble_oracle(reads, k, 2, **kw)
