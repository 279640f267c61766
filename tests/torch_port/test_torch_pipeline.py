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


def _long_k(genome_bp, read_len, seed):
    g = random_genome(genome_bp, seed=seed)
    return lambda: simulate_reads(g, read_len=read_len, coverage=30, seed=seed + 1, circular=True)


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
    cfg = AssemblyConfig(k=21, read_batch=512, read_len=100, spectrum_capacity=1 << 14)
    for opt in ("tip_rounds", "bubble_rounds"):
        with pytest.raises(NotImplementedError):
            assemble_reads(_phix()[:50], dataclasses.replace(cfg, **{opt: 1}), "cpu")
