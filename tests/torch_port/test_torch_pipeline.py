"""End to end: the port's assemble_reads vs tpu_euler's assemble_reads vs the
CPU oracle, on the cases of tests/integration/test_pipeline_vs_oracle.py."""

import dataclasses

import pytest

from tpu_euler.config import AssemblyConfig
from tpu_euler.pipeline.assemble import assemble_reads as jax_assemble_reads
from tpu_euler.reference_impl.oracle import assemble_oracle
from tpu_euler.reference_impl.simulate import PHIX174, random_genome, simulate_reads
from tpu_euler.verify.compare import diff_contig_sets
from tpu_euler_torch.pipeline.assemble import assemble_reads
from torch_port_inputs import repeat_genome


def _phix():
    return simulate_reads(PHIX174, read_len=100, coverage=30, seed=42, circular=True)


def _repeat():
    g = repeat_genome()
    return [g[i : i + 100] for i in range(0, len(g) - 100 + 1, 3)] + [g[-100:]]


def _errors():
    g = random_genome(3000, seed=71)
    return simulate_reads(g, read_len=100, coverage=40, seed=72, circular=True, error_rate=0.005)


def _ragged():
    g = random_genome(1000, seed=81)
    return [g[i : i + 60 + (i % 30)][:96] for i in range(0, 900, 7)]


def _k41():
    g = random_genome(2000, seed=91)
    return simulate_reads(g, read_len=120, coverage=25, seed=92, circular=True)


def _long_k(genome_bp, read_len, seed, circular=True):
    g = random_genome(genome_bp, seed=seed)
    return lambda: simulate_reads(g, read_len=read_len, coverage=30, seed=seed + 1, circular=circular)


def _two_components():
    return simulate_reads(random_genome(900, seed=101), 80, 20, seed=103, circular=True) + (
        simulate_reads(random_genome(700, seed=102), 80, 20, seed=104, circular=True)
    )


CASES = {
    "phix_k21": (_phix, AssemblyConfig(k=21, read_batch=512, read_len=100, spectrum_capacity=1 << 14), 1),
    # capacity 2^18: E = 2^19 doubled edges, so the ruling-set walk runs
    "phix_k21_ruling": (_phix, AssemblyConfig(k=21, read_batch=4096, read_len=100, spectrum_capacity=1 << 18), 1),
    "repeat_k31": (_repeat, AssemblyConfig(k=31, read_batch=512, read_len=100, spectrum_capacity=1 << 14), None),
    "errors_cutoff_k21": (_errors, AssemblyConfig(k=21, min_count=4, read_batch=512, read_len=100, spectrum_capacity=1 << 16), None),
    "short_ragged_k21": (_ragged, AssemblyConfig(k=21, read_batch=256, read_len=96, spectrum_capacity=1 << 13), None),
    "two_components_k21": (_two_components, AssemblyConfig(k=21, read_batch=512, read_len=80, spectrum_capacity=1 << 14), 2),
    # SPEC config 5's k: two int64 words per key
    "k41": (_k41, AssemblyConfig(k=41, read_batch=256, read_len=120, spectrum_capacity=1 << 14), 1),
    "repeat_k41_ruling": (_repeat, AssemblyConfig(k=41, read_batch=4096, read_len=100, spectrum_capacity=1 << 18), None),
    # three words per key (k = 63, 75) and four (k = 95, 6 windows per read)
    "k63": (_long_k(3000, 100, 93), AssemblyConfig(k=63, read_batch=256, read_len=100, spectrum_capacity=1 << 14), 1),
    "k75": (_long_k(3000, 120, 95), AssemblyConfig(k=75, read_batch=256, read_len=120, spectrum_capacity=1 << 14), 1),
    "k95": (_long_k(3000, 100, 97), AssemblyConfig(k=95, read_batch=256, read_len=100, spectrum_capacity=1 << 14), None),
    "repeat_k63_ruling": (_repeat, AssemblyConfig(k=63, read_batch=4096, read_len=100, spectrum_capacity=1 << 18), None),
    # the plant cell's shape: k = 77 (three-word keys, 76- and 78-base endpoints and transitions in three
    # words) on 150-base reads (74 windows, 38 packed bytes and a 19-byte N map a read), linear and circular;
    # the linear genome counts in groups of two batches, as the grouped count does at full size
    "k77_150_linear": (
        _long_k(4000, 150, 111, circular=False),
        AssemblyConfig(k=77, read_batch=128, read_len=150, spectrum_capacity=1 << 14, oneshot_rows=2 * 128 * 74),
        1,
    ),
    "k77_150_circular": (
        _long_k(4000, 150, 113),
        AssemblyConfig(k=77, read_batch=256, read_len=150, spectrum_capacity=1 << 14),
        1,
    ),
}


@pytest.mark.parametrize("case", list(CASES))
def test_assemble_reads_matches_reference_and_oracle(case):
    make_reads, cfg, n_contigs = CASES[case]
    reads = make_reads()
    got = assemble_reads(reads, cfg, "cpu")
    ref = jax_assemble_reads(reads, cfg)
    assert got.contigs == ref.contigs
    assert got.n_distinct_kmers == ref.n_distinct_kmers
    assert got.n_kmers_counted == ref.n_kmers_counted
    assert got.n_reads == ref.n_reads
    only_got, only_exp = diff_contig_sets(got.contig_strings, assemble_oracle(reads, cfg.k, cfg.min_count))
    assert not only_got and not only_exp
    if n_contigs is not None:
        assert len(got.contigs) == n_contigs
    assert set(got.stage_seconds) == {"encode", "count", "count_drain", "graph", "extract"}


@pytest.mark.parametrize("case", ["repeat_k41_ruling", "errors_cutoff_k21", "k63"])
def test_walk_takes_the_transition_key_handoff(case, monkeypatch):
    """At every E the walk gets the transition keys as ``[t]`` with a
    factory (the reference's `big` route, which it takes only above 2^26
    doubled edges), and the contigs are those of the reference's other
    route at these small E."""
    from tpu_euler_torch.euler import unitigs
    from tpu_euler_torch.pipeline import assemble as pipe

    make_reads, cfg, _ = CASES[case]
    reads = make_reads()
    taken = []
    real = unitigs.chains_from_t

    def spy(t, *a, t_factory=None, **kw):
        taken.append((isinstance(t, list), t_factory is not None))
        return real(t, *a, t_factory=t_factory, **kw)

    monkeypatch.setattr(pipe, "chains_from_t", spy)
    got = assemble_reads(reads, cfg, "cpu")
    assert taken == [(True, True)]
    ref = jax_assemble_reads(reads, cfg)
    assert got.contigs == ref.contigs and got.n_distinct_kmers == ref.n_distinct_kmers


def test_cleaning_options_raise():
    """The cleaning options once raised NotImplementedError; they run now,
    each alone, and give the oracle's contigs."""
    cfg = AssemblyConfig(k=21, min_count=4, read_batch=512, read_len=100, spectrum_capacity=1 << 16)
    reads = _errors()
    for opt in ("tip_rounds", "bubble_rounds"):
        got = assemble_reads(reads, dataclasses.replace(cfg, **{opt: 1}), "cpu")
        assert not any(diff_contig_sets(got.contig_strings, assemble_oracle(reads, 21, 4, **{opt: 1})))
        assert "tips" in got.stage_seconds


def _errored_circular(read_len):
    g = random_genome(6000, seed=171)
    return lambda: simulate_reads(g, read_len=read_len, coverage=40, seed=172, circular=True, error_rate=0.004)


def _adversarial_codes():
    """The repeat genome of scripts/fullscale_adversarial.py:95-104 (600 kbp
    there), cut to 30 kbp: linear, 40x, 0.3% errors."""
    from tpu_euler.reference_impl.simulate import simulate_read_codes
    from tpu_euler_torch.simulate import adversarial_genome

    return simulate_read_codes(
        adversarial_genome(30_000, seed=5150), read_len=100, coverage=40, seed=5151, error_rate=0.003, circular=False
    )


def _cleaning(**kw):
    return AssemblyConfig(tip_rounds=3, bubble_rounds=2, **{"read_len": 100, **kw})


CLEANING_CASES = {
    "errors_k21": (_errors, _cleaning(k=21, min_count=4, read_batch=512, spectrum_capacity=1 << 16)),
    "errored_circular_k31": (_errored_circular(100), _cleaning(k=31, min_count=4, read_batch=1024, spectrum_capacity=1 << 17)),
    "errored_circular_k41": (_errored_circular(120), _cleaning(k=41, min_count=4, read_batch=1024, read_len=120, spectrum_capacity=1 << 17)),
    "errored_circular_k63": (_errored_circular(120), _cleaning(k=63, min_count=3, read_batch=1024, read_len=120, spectrum_capacity=1 << 17)),
    "errored_circular_k77_150": (
        _errored_circular(150), _cleaning(k=77, min_count=3, read_batch=1024, read_len=150, spectrum_capacity=1 << 17)
    ),
    # explicit thresholds, and the per-batch counting route in front
    "errored_thresholds_per_batch": (
        _errored_circular(100),
        _cleaning(k=31, min_count=4, read_batch=1024, spectrum_capacity=1 << 17, tip_len=20, bubble_len=40, oneshot_rows=0),
    ),
    "adversarial_30kbp": (_adversarial_codes, _cleaning(k=31, min_count=3, read_batch=1 << 13, spectrum_capacity=1 << 18)),
}


@pytest.mark.parametrize("case", list(CLEANING_CASES))
def test_assemble_with_cleaning_matches_reference_and_oracle(case):
    """Cutoff + tips + bubbles: the reference's contig set and the oracle's."""
    from tpu_euler.io.encode import decode_read, encode_reads
    from tpu_euler.pipeline.assemble import assemble_codes as jax_assemble_codes
    from tpu_euler_torch.pipeline.assemble import assemble_codes

    make, cfg = CLEANING_CASES[case]
    made = make()
    codes = encode_reads(made, cfg.read_len) if isinstance(made, list) else made
    reads = made if isinstance(made, list) else [decode_read(c) for c in codes]
    got = assemble_codes(codes, cfg, "cpu")
    ref = jax_assemble_codes(codes, cfg)
    assert got.contigs == ref.contigs and len(got.contigs) >= 1
    assert (got.n_distinct_kmers, got.n_kmers_counted, got.n_reads) == (
        ref.n_distinct_kmers, ref.n_kmers_counted, ref.n_reads
    )
    assert list(got.stage_seconds) == list(ref.stage_seconds)
    want = assemble_oracle(
        reads, cfg.k, cfg.min_count, tip_rounds=3, tip_len=cfg.tip_len, bubble_rounds=2, bubble_len=cfg.bubble_len
    )
    only_got, only_exp = diff_contig_sets(got.contig_strings, want)
    assert not only_got and not only_exp
    if case == "adversarial_30kbp":
        assert len(got.contigs) >= 5  # the repeats split the walk


def test_cleaning_right_sizes_twice(monkeypatch):
    """The cut spectrum is right-sized a second time before the rounds: the
    cleaning graphs have the survivors' capacity, not the raw spectrum's."""
    from tpu_euler_torch.pipeline import assemble as pipe

    make, cfg = CLEANING_CASES["errored_circular_k31"]
    reads = make()
    real, sized = pipe.right_size_spectrum, []

    def fine_grained(acc):
        out = real(acc, granule=1 << 10)
        sized.append((acc.n, out.words.shape[0]))
        return out

    monkeypatch.setattr(pipe, "right_size_spectrum", fine_grained)
    got = assemble_reads(reads, cfg, "cpu")
    (n_raw, cap_raw), (n_cut, cap_cut) = sized
    assert n_raw > 4 * n_cut  # several error k-mers to a surviving one
    assert cap_cut < cap_raw < cfg.spectrum_capacity and cap_cut >= n_cut
    monkeypatch.undo()
    assert got.contigs == assemble_reads(reads, cfg, "cpu").contigs
    assert got.n_distinct_kmers <= n_cut
