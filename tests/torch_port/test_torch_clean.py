"""Graph cleaning: the port's clip_tips / pop_bubbles vs
tpu_euler.euler.clean round by round (spectrum rows, counts, n and the
removed count exactly equal after every round, through the reference's
small route and through its staged route), vs the oracle's
find_tip_kmers / find_bubble_kmers, and the end-to-end cases of
tests/integration/test_tips.py and test_bubbles.py. Tolerance: none."""

import numpy as np
import pytest
import torch

from tpu_euler.config import AssemblyConfig
from tpu_euler.euler import clean as jax_clean
from tpu_euler.pipeline.assemble import assemble_reads as jax_assemble_reads
from tpu_euler.reference_impl import oracle as ref_oracle
from tpu_euler.reference_impl.simulate import random_genome, simulate_reads
from tpu_euler_torch import convert, oracle
from tpu_euler_torch.euler import clean
from tpu_euler_torch.euler.extract import decode_bases_np
from tpu_euler_torch.euler.unitigs import UnitigChains
from tpu_euler_torch.graph.build import DeBruijnGraph
from tpu_euler_torch.kmer import keys
from tpu_euler_torch.kmer.count import Spectrum
from tpu_euler_torch.pipeline.assemble import assemble_reads
from torch_port_inputs import counted_spectrum, dirty_reads, reads_with_bubbles, reads_with_tips


def _reads(kind):
    if kind == "tips":
        return reads_with_tips(random_genome(3000, seed=601), seed=602)
    if kind == "bubbles":
        return reads_with_bubbles(random_genome(3000, seed=701), seed=702)
    return dirty_reads(40)


def _assert_same(got: Spectrum, ref, k):
    n = int(ref.n)
    assert got.n == n
    want = convert.spectrum_from_reference(ref, "cpu", keys.nwords(k))
    assert torch.equal(got.words, want.words)  # rows past n are zero in both
    assert torch.equal(got.counts, want.counts)


ROUND_CASES = [  # (reads, k, capacity, the reference's big_edges)
    ("tips", 21, 1 << 13, None),
    ("tips", 31, 1 << 13, 0),
    ("bubbles", 21, 1 << 13, 0),
    ("bubbles", 31, 1 << 13, None),
    ("dirty", 21, 1 << 13, None),
    ("dirty", 21, 1 << 13, 0),
    ("dirty", 41, 1 << 13, None),  # two words per key
    ("dirty", 63, 1 << 13, 0),  # three
    # E = 2^18 doubled edges: both packages take the ruling-set walk
    ("dirty", 21, 1 << 17, 0),
]


@pytest.mark.parametrize("kind,k,capacity,big_edges", ROUND_CASES)
def test_rounds_match_reference(kind, k, capacity, big_edges):
    """Three tip rounds, then three bubble rounds, one at a time."""
    ref = counted_spectrum(_reads(kind), k, 3, capacity)
    got = convert.spectrum_from_reference(ref, "cpu", keys.nwords(k))
    route = {} if big_edges is None else {"big_edges": big_edges}
    removed = {"tips": 0, "bubbles": 0}
    for name, jax_pass, port_pass in (
        ("tips", jax_clean.clip_tips, clean.clip_tips),
        ("bubbles", jax_clean.pop_bubbles, clean.pop_bubbles),
    ):
        for _ in range(3):
            ref, n_ref = jax_pass(ref, k, 1, **route)
            got, n_got = port_pass(got, k, 1)
            assert n_got == n_ref
            _assert_same(got, ref, k)
            removed[name] += n_got
    if kind != "bubbles":
        assert removed["tips"] > 0
    if kind != "tips" and k < 63:  # a 100 bp read holds no whole 63-edge branch
        assert removed["bubbles"] > 0


def test_whole_passes_match_reference_with_thresholds():
    """Several rounds in one call, explicit thresholds, the early stop."""
    ref = counted_spectrum(dirty_reads(50), 21, 3)
    got = convert.spectrum_from_reference(ref, "cpu", 1)
    ref, n_ref = jax_clean.clip_tips(ref, 21, 5, tip_len=30)
    got, n_got = clean.clip_tips(got, 21, 5, tip_len=30)
    assert n_got == n_ref > 0
    _assert_same(got, ref, 21)
    ref, n_ref = jax_clean.pop_bubbles(ref, 21, 5, bubble_len=60)
    got, n_got = clean.pop_bubbles(got, 21, 5, bubble_len=60)
    assert n_got == n_ref > 0
    _assert_same(got, ref, 21)
    assert clean.clip_tips(got, 21, 0) == (got, 0)


def _kmers(spec: Spectrum, k):
    rows = decode_bases_np(spec.words[: spec.n].numpy(), k, k)
    return {r.tobytes().decode() for r in rows}


@pytest.mark.parametrize("k", [21, 41])
def test_one_round_removes_the_oracles_kmers(k):
    """One round of each pass drops exactly the canonical k-mers the
    oracle's find_tip_kmers / find_bubble_kmers name."""
    reads = dirty_reads(40)
    spec = convert.spectrum_from_reference(counted_spectrum(reads, k, 3), "cpu", keys.nwords(k))
    counts = oracle.count_canonical_kmers(reads, k)
    for find, port_pass in (
        (lambda e: oracle.find_tip_kmers(e, k, 2 * k), clean.clip_tips),
        (lambda e: oracle.find_bubble_kmers(e, counts, k, 2 * k), clean.pop_bubbles),
    ):
        before = _kmers(spec, k)
        edges = before | {oracle.rc(w) for w in before}
        want = {oracle.canon(w) for w in find(edges)}
        spec, n = port_pass(spec, k, 1)
        assert before - _kmers(spec, k) == want and n == len(want) > 0


def test_oracle_cleaning_matches_reference_oracle():
    reads = dirty_reads(40)
    counts = ref_oracle.count_canonical_kmers(reads, 21)
    edges = {w for c, n in counts.items() if n >= 3 for w in (c, ref_oracle.rc(c))}
    assert oracle.find_tip_kmers(edges, 21, 42) == ref_oracle.find_tip_kmers(edges, 21, 42)
    edges -= ref_oracle.find_tip_kmers(edges, 21, 42)
    assert oracle.find_bubble_kmers(edges, counts, 21, 42) == ref_oracle.find_bubble_kmers(edges, counts, 21, 42)
    for kw in ({"tip_rounds": 3}, {"bubble_rounds": 2}, {"tip_rounds": 3, "bubble_rounds": 2, "tip_len": 30, "bubble_len": 50}):
        assert oracle.assemble_oracle(reads, 21, 3, **kw) == ref_oracle.assemble_oracle(reads, 21, 3, **kw)


def _equal_coverage_bubble():
    genome = random_genome(2000, seed=721)
    reads = simulate_reads(genome, read_len=100, coverage=20, seed=723, circular=True)
    w = list(genome[700:800])
    w[50] = "ACGT"[("ACGT".index(w[50]) + 2) % 4]
    return reads + ["".join(w)] * 20, dict(bubble_rounds=2)


def _isolated_short_chain():
    reads = simulate_reads(random_genome(2000, seed=621), read_len=100, coverage=20, seed=623, circular=True)
    return reads + [random_genome(60, seed=622)] * 4, dict(tip_rounds=3)


def _long_parallel_paths():
    a, b = random_genome(300, seed=741), random_genome(300, seed=744)
    reads = simulate_reads(a + random_genome(200, seed=742) + b, read_len=100, coverage=20, seed=745)
    return reads + simulate_reads(a + random_genome(200, seed=743) + b, read_len=100, coverage=10, seed=746), dict(bubble_rounds=2)


def _tips_then_bubbles():
    genome = random_genome(2800, seed=731)
    reads = reads_with_bubbles(genome, n_bubbles=3, seed=732)
    rng = np.random.default_rng(733)
    for _ in range(3):
        p = int(rng.integers(0, len(genome) - 100))
        junk = "".join("ACGT"[c] for c in rng.integers(0, 4, 30))
        reads.extend([(genome[p : p + 70] + junk)[:100]] * 5)
    return reads, dict(min_count=3, tip_rounds=3, bubble_rounds=3)


END_TO_END = {
    "equal_coverage_bubble": _equal_coverage_bubble,
    "isolated_short_chain": _isolated_short_chain,
    "long_parallel_paths": _long_parallel_paths,
    "tips_then_bubbles": _tips_then_bubbles,
}


@pytest.mark.parametrize("case", list(END_TO_END))
def test_cleaning_end_to_end(case):
    reads, opts = END_TO_END[case]()
    cfg = AssemblyConfig(k=21, read_batch=512, read_len=100, spectrum_capacity=1 << 15, **opts)
    got = assemble_reads(reads, cfg, "cpu")
    want = oracle.assemble_oracle(
        reads, 21, cfg.min_count, tip_rounds=cfg.tip_rounds, bubble_rounds=cfg.bubble_rounds
    )
    assert oracle.canonical_contig_set(got.contig_strings) == want
    assert got.contigs == jax_assemble_reads(reads, cfg).contigs
    if case == "isolated_short_chain":  # dead at both ends: a contig, not a tip
        assert any(len(c) == 60 for c in got.contigs)
    if case == "long_parallel_paths":  # branches of ~200 edges are kept
        assert want == oracle.assemble_oracle(reads, 21)


def _synthetic(groups):
    """A hand-made graph of single-edge chains: ``groups`` maps an edge id
    to (start node, end node). C = 4 rows, E = 8 edges; row r underlies
    edges r and r + 4."""
    E = 8
    valid = torch.zeros(E, dtype=torch.bool)
    tail = torch.zeros(E, dtype=torch.int64)
    head = torch.zeros(E, dtype=torch.int64)
    for e, (u, v) in groups.items():
        valid[e], tail[e], head[e] = True, u, v
    eid = torch.arange(E)
    deg = torch.ones(2 * E, dtype=torch.int64)
    g = DeBruijnGraph(valid, tail, head, int(valid.sum()), 8, deg, deg, deg, deg)
    chains = UnitigChains(
        chain=torch.where(valid, eid, -1), pos=torch.zeros(E, dtype=torch.int64),
        length=valid.to(torch.int64), is_start=valid.clone(),
        from_cycle=torch.zeros(E, dtype=torch.bool), in_chain=valid.clone(),
    )
    spec = Spectrum(torch.tensor([11, 22, 33, 44]), torch.tensor([10, 5, 5, 7], dtype=torch.int32), 4)
    return spec, g, chains


@pytest.mark.parametrize(
    "groups,dropped",
    [
        # edges 1 and 5 share row 1, so they tie on coverage and smallest
        # row: behind edge 0 both are popped, in whatever order they sort
        ({0: (0, 1), 1: (0, 1), 5: (0, 1), 2: (2, 3)}, [1]),
        # the same two alone tie at the top: the group is skipped
        ({1: (0, 1), 5: (0, 1), 2: (2, 3)}, []),
        # rows 1 and 2 tie on coverage; the smaller row wins
        ({1: (0, 1), 2: (0, 1), 3: (0, 1)}, [1, 2]),
    ],
)
def test_bubble_ties_do_not_depend_on_sort_order(groups, dropped):
    import jax.numpy as jnp

    from tpu_euler.euler.unitigs import UnitigChains as RefChains
    from tpu_euler.kmer.count import Spectrum as RefSpectrum

    spec, g, chains = _synthetic(groups)
    got, n = clean._bubble_mark(spec, g, chains, 42)
    keep = [r for r in range(4) if r not in dropped]
    assert n == len(dropped)
    assert got.words.tolist() == [spec.words[r].item() for r in keep] + [0] * len(dropped)
    assert got.counts.tolist() == [spec.counts[r].item() for r in keep] + [0] * len(dropped)

    def i32(t):
        return jnp.asarray(t.numpy().astype(np.int32))

    ref_spec = RefSpectrum(
        jnp.asarray(convert.words_to_limbs(spec.words, 2)), i32(spec.counts), jnp.asarray(4, jnp.int32)
    )
    ref_chains = RefChains(
        i32(chains.chain), i32(chains.pos), i32(chains.length),
        *(jnp.asarray(t.numpy()) for t in (chains.is_start, chains.from_cycle, chains.in_chain)),
    )
    ref, n_ref = jax_clean._bubble_mark(ref_spec, i32(g.head), i32(g.tail), i32(g.indeg), i32(g.outdeg), ref_chains, 42)
    assert int(n_ref) == n
    _assert_same(got, ref, 31)
