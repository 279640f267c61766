"""The Eulerian tour: the cases of tests/unit/test_tour.py on the port's
``eulerian_tour``, each also held equal to the reference's ``EulerTour``
field by field (succ, chain, pos, length, n_chains, in_tour, merge_rounds)."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_euler.euler import tour as jax_tour
from tpu_euler.graph.build import build_graph as jax_build_graph
from tpu_euler.io.encode import encode_reads
from tpu_euler.kmer.count import count_batch
from tpu_euler.kmer.extract import extract_canonical_kmers
from tpu_euler.reference_impl.simulate import random_genome, rc, simulate_reads
from tpu_euler_torch import convert
from tpu_euler_torch.euler.extract import decode_bases_np
from tpu_euler_torch.euler.tour import _pair_successors, eulerian_tour
from tpu_euler_torch.graph.build import build_graph
from tpu_euler_torch.kmer import keys


def graphs_from_reads(reads, k, read_len=None):
    """(reference graph, port graph) of one batch of reads."""
    read_len = read_len or max(len(r) for r in reads)
    limbs, valid = extract_canonical_kmers(jnp.asarray(encode_reads(reads, read_len)), k)
    spec = count_batch(limbs, valid)
    return jax_build_graph(spec, k), build_graph(convert.spectrum_from_reference(spec, "cpu", keys.nwords(k)), k)


def tours(reads, k, read_len=None):
    """The port's tour, after checking it against the reference's."""
    ref_g, g = graphs_from_reads(reads, k, read_len)
    ref, got = jax_tour.eulerian_tour(ref_g), eulerian_tour(g)
    r, t = convert.records_to_numpy(ref), convert.records_to_numpy(got)
    for name in ("succ", "chain", "pos", "length", "in_tour"):
        np.testing.assert_array_equal(t[name], r[name], err_msg=name)
    assert got.n_chains == int(ref.n_chains)
    assert got.merge_rounds == int(ref.merge_rounds)
    return g, got


def arrays(g, t):
    return tuple(x.numpy() for x in (t.succ, t.chain, t.pos, t.length, t.in_tour, g.tail, g.head))


def assert_valid_tour(g, t):
    """Unique (chain, pos) slots, succ a partial injection that respects
    adjacency, consecutive edges of a chain adjacent."""
    succ, chain, pos, length, valid, tail, head = arrays(g, t)
    idx = np.flatnonzero(valid)
    assert len({(chain[e], pos[e]) for e in idx}) == idx.size
    assert ((pos[idx] >= 0) & (pos[idx] < length[idx])).all()
    taken = succ[succ >= 0]
    assert taken.size == np.unique(taken).size
    linked = idx[succ[idx] >= 0]
    assert (tail[succ[linked]] == head[linked]).all()
    order = idx[np.lexsort((pos[idx], chain[idx]))]
    same = chain[order][1:] == chain[order][:-1]
    assert (head[order][:-1][same] == tail[order][1:][same]).all()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_pairing_is_valid_partial_permutation(seed):
    reads = simulate_reads(random_genome(500, seed=seed), read_len=80, coverage=10, seed=seed + 10)
    ref_g, g = graphs_from_reads(reads, 21)
    succ = _pair_successors(g).numpy()
    np.testing.assert_array_equal(succ, np.asarray(jax_tour._pair_successors(ref_g)))
    valid, tail, head = g.edge_valid.numpy(), g.tail.numpy(), g.head.numpy()
    linked = np.flatnonzero(valid & (succ >= 0))
    assert valid[succ[linked]].all() and (tail[succ[linked]] == head[linked]).all()
    assert (succ[~valid] == -1).all()
    assert linked.size == np.unique(succ[linked]).size


@pytest.mark.parametrize("k,glen,seed", [(21, 800, 5), (21, 2000, 6), (31, 1500, 7), (41, 1500, 8)])
def test_tour_covers_every_edge_once(k, glen, seed):
    reads = simulate_reads(random_genome(glen, seed=seed), read_len=100, coverage=15, seed=seed + 20)
    g, t = tours(reads, k)
    assert_valid_tour(g, t)


def test_eulerian_component_single_circuit():
    """A circular genome of unique k-mers: one circuit a strand."""
    reads = simulate_reads(random_genome(1200, seed=11), read_len=100, coverage=20, seed=12, circular=True)
    g, t = tours(reads, 21)
    assert t.n_chains == 2
    assert_valid_tour(g, t)
    assert int(t.length[t.in_tour][0]) == g.n_edges // 2


def test_tour_spells_genome_rotation():
    k = 21
    genome = random_genome(700, seed=21)
    reads = simulate_reads(genome, read_len=80, coverage=20, seed=22, circular=True)
    g, t = tours(reads, k)
    succ, chain, pos, length, valid, tail, head = arrays(g, t)
    words = g.edge_words.numpy()
    lastb = np.frombuffer(b"ACGT", np.uint8)[words & 3]
    idx = np.flatnonzero(valid)
    order = idx[np.lexsort((pos[idx], chain[idx]))]
    seqs = []
    for cid in np.unique(chain[order]):
        edges = order[chain[order] == cid]
        seqs.append(decode_bases_np(words[edges[:1]], k - 1, k).tobytes().decode() + lastb[edges].tobytes().decode())
    assert len(seqs) == 2
    for s in seqs:
        assert len(s) == len(genome) + k - 1
        assert s[: len(genome)] in genome + genome or s[: len(genome)] in rc(genome) + rc(genome)


def test_non_eulerian_graph_path_cover():
    """A linear genome: unbalanced ends give one path a strand."""
    genome = random_genome(600, seed=31)
    reads = [genome[i : i + 60] for i in range(0, len(genome) - 59, 5)] + [genome[-60:]]
    g, t = tours(reads, 21, read_len=60)
    assert_valid_tour(g, t)
    assert t.n_chains == 2


def _round_bound(g):
    return 2 * max(1, (g.tail.shape[0] - 1).bit_length()) + 4


@pytest.mark.parametrize("m,seed", [(64, 41), (200, 42)])
def test_adversarial_tangent_circuits(m, seed):
    """Many circuits through one hub repeat: the rotation merge converges
    within the round bound."""
    k = 21
    hub = random_genome(k + 4, seed=seed)
    genome = "".join(hub + random_genome(40, seed=seed + 100 + i) for i in range(m))
    gg = genome + genome
    reads = [gg[i : i + 80] for i in range(0, len(genome), 7)]
    g, t = tours(reads, k, read_len=80)
    assert_valid_tour(g, t)
    assert t.merge_rounds <= _round_bound(g)


def test_adversarial_multi_hub_interleaved():
    k = 21
    rng = np.random.default_rng(77)
    hubs = [random_genome(k + 2, seed=500 + h) for h in range(4)]
    parts = []
    for i in range(120):
        parts += [hubs[int(rng.integers(0, 4))], random_genome(30, seed=600 + i)]
    genome = "".join(parts)
    gg = genome + genome
    reads = [gg[i : i + 80] for i in range(0, len(genome), 6)]
    g, t = tours(reads, k, read_len=80)
    assert_valid_tour(g, t)
    assert t.merge_rounds <= _round_bound(g)


def _balanced_hubs(n_hubs):
    """Reads over a circular genome of ``n_hubs`` repeats of k - 1 bases,
    each followed four times by blocks that start and end with four
    different bases: every repeat is one node of in- and out-degree 4, the
    graph is Eulerian, and the pairing leaves circuits that share the hubs."""
    parts = []
    for h in range(n_hubs):
        hub = random_genome(20, seed=41 + h)
        for i in range(4):
            parts.append(hub + "ACGT"[i] + random_genome(38, seed=141 + 4 * h + i) + "ACGT"[i])
    genome = "".join(parts)
    gg = genome + genome
    return [gg[i : i + 60] for i in range(len(genome))]


@pytest.mark.parametrize("n_hubs", [1, 6])
def test_circuits_through_shared_nodes_merge_into_one(n_hubs):
    g, t = tours(_balanced_hubs(n_hubs), 21, read_len=60)
    assert_valid_tour(g, t)
    assert t.merge_rounds == 2  # one round that merges, one that finds nothing
    assert t.n_chains == 2  # one circuit a strand
    assert int(t.length[t.in_tour][0]) == g.n_edges // 2


def test_max_rounds_bounds_the_merge():
    ref_g, g = graphs_from_reads(_balanced_hubs(2), 21, read_len=60)
    got, ref = eulerian_tour(g, max_rounds=1), jax_tour.eulerian_tour(ref_g, max_rounds=1)
    assert got.merge_rounds == int(ref.merge_rounds) == 1
    np.testing.assert_array_equal(got.succ.numpy(), np.asarray(ref.succ))
    assert got.n_chains == int(ref.n_chains)
