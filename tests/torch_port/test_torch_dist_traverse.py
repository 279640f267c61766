"""The sharded traversal over a ``LoopbackComm`` against the reference's
``shard_map`` blocks on the CPU mesh: the same sharded spectrum in, the
cutoff's shards, the node-record exchange's seven outputs and every field of
``ShardChains`` equal shard by shard, on reads of a genome with a repeat and
a plasmid that is a pure cycle; then the fragment emission against the full
fetch. Exact (integers), through ``convert``'s limb/word mapping."""

import functools

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

from tpu_euler.dist import traverse_dist as ref_td
from tpu_euler.dist.mesh import AXIS, make_mesh
from tpu_euler.euler.extract import assemble_contig_bytes as ref_assemble_contig_bytes
from tpu_euler.kmer import keys as jax_keys
from tpu_euler_torch import convert
from tpu_euler_torch.dist import traverse_dist as td
from tpu_euler_torch.dist.mesh import LoopbackComm, fetch_global
from tpu_euler_torch.euler.extract import assemble_contig_bytes
from tpu_euler_torch.kmer import keys

from torch_port_inputs import cycle_and_repeat_reads, port_shards, sharded_spectrum

C_LOCAL = {2: 1 << 12, 8: 1 << 10}
FIELDS = ("valid", "chain", "pos", "is_start", "tail_dead", "head_dead", "on_cycle")


@functools.lru_cache(maxsize=None)
def _reads():
    return tuple(cycle_and_repeat_reads())


@functools.lru_cache(maxsize=None)
def _both(k, n_dev, min_count):
    """(reference cutoff shards, port cutoff shards) of the same spectrum."""
    c_local = C_LOCAL[n_dev]
    limbs, counts, n = sharded_spectrum(list(_reads()), k, n_dev, c_local)
    ref_cut = ref_td.make_dist_cutoff_step(min_count, make_mesh(n_dev))(limbs, counts, n)
    cut = td.dist_cutoff_step(*port_shards(limbs, counts, n, k, n_dev), min_count)
    return ref_cut, cut


def _assert_chains(sc, ref, k, n_dev, what):
    want = convert.shard_chains_from_reference(ref, "cpu", keys.nwords(k), n_dev)
    assert [int(d) for d in sc.dropped] == [int(d) for d in want.dropped], what
    for r in range(n_dev):
        assert torch.equal(sc.edge_words[r], want.edge_words[r]), (what, "edge_words", r)
        for name in FIELDS:
            got, exp = getattr(sc, name)[r], getattr(want, name)[r]
            assert got.dtype == exp.dtype and torch.equal(got, exp), (what, name, r)


@pytest.mark.parametrize("min_count", [1, 3], ids=["no_cutoff", "cutoff_3"])
@pytest.mark.parametrize("n_dev", [2, 8])
@pytest.mark.parametrize("k", [21, 41])
def test_chains_step_matches_reference_shards(k, n_dev, min_count):
    c_local = C_LOCAL[n_dev]
    (rl, rc, rn), (words, counts, n) = _both(k, n_dev, min_count)
    # the cutoff's shards
    want_w, want_c, want_n = port_shards(rl, rc, rn, k, n_dev)
    assert n == want_n and min(n) > 0
    for r in range(n_dev):
        assert torch.equal(words[r], want_w[r]) and torch.equal(counts[r], want_c[r]), r
    ref = ref_td.make_dist_chains_step(k, n_dev, c_local, make_mesh(n_dev))(rl, rc, rn)
    sc = td.dist_chains_step(words, n, LoopbackComm(n_dev, "cpu"), k, c_local)
    _assert_chains(sc, ref, k, n_dev, (k, n_dev, min_count))
    # the input has what it was made for: a pure cycle, chains longer than an
    # edge, branching nodes, dead ends
    assert sum(int(d) for d in sc.dropped) == 0
    assert any(c.any() for c in sc.on_cycle) and not all(c[v].all() for c, v in zip(sc.on_cycle, sc.valid))
    assert max(int(p.max()) for p in sc.pos) > 100
    n_chains = sum(int((s & v).sum()) for s, v in zip(sc.is_start, sc.valid))
    assert n_chains > 4
    assert min_count > 1 or any(t.any() for t in sc.tail_dead)


@pytest.mark.parametrize("n_dev", [2, 8])
@pytest.mark.parametrize("k", [21, 41])
def test_chains_step_counts_the_reference_drops(k, n_dev):
    """At a slab factor that drops records and requests, every rank counts
    the reference's drops, and what the surviving rows say is the same."""
    c_local = C_LOCAL[n_dev]
    (rl, rc, rn), (words, _, n) = _both(k, n_dev, 1)
    ref = ref_td.make_dist_chains_step(k, n_dev, c_local, make_mesh(n_dev), slab_factor=0.01)(rl, rc, rn)
    sc = td.dist_chains_step(words, n, LoopbackComm(n_dev, "cpu"), k, c_local, slab_factor=0.01)
    assert [int(d) for d in sc.dropped] == [int(d) for d in np.asarray(ref.dropped)]
    assert min(int(d) for d in sc.dropped) > 0
    _assert_chains(sc, ref, k, n_dev, (k, n_dev, "drops"))


def _ref_node_exchange(edge_limbs, valid, k, n_dev, el_cap, c_node):
    def local(e, v):
        out = ref_td._node_record_exchange(e, v, k, n_dev, el_cap, c_node)
        return out[:6] + (out[6][None],)

    step = jax.jit(jax.shard_map(local, mesh=make_mesh(n_dev), in_specs=(P(AXIS), P(AXIS)), out_specs=(P(AXIS),) * 7))
    return [np.asarray(x) for x in step(edge_limbs, valid)]


@pytest.mark.parametrize("c_node_factor", [2.0, 0.6], ids=["roomy", "dropping"])
@pytest.mark.parametrize("n_dev", [2, 8])
@pytest.mark.parametrize("k", [21, 41])
def test_node_record_exchange_matches_reference(k, n_dev, c_node_factor):
    """succ_gid, succ_lastb, has_pred, pred_gid, tail_dead, head_dead and
    the drop count, each apart, also with slabs too small for the records."""
    c_local = C_LOCAL[n_dev]
    el_cap = 2 * c_local
    c_node = int(c_node_factor * 4 * c_local / n_dev) + 16
    (rl, _, rn), (words, _, n) = _both(k, n_dev, 1)
    rl, rn = np.asarray(rl), np.asarray(rn)
    # the reference's edges: each shard's rows, then their reverse complements
    blocks, valids = [], []
    for r in range(n_dev):
        rows = rl[r * c_local : (r + 1) * c_local]
        blocks.append(np.concatenate([rows, np.asarray(jax_keys.revcomp(rows, k))]))
        valids.append(np.tile(np.arange(c_local) < rn[r], 2))
    want = _ref_node_exchange(np.concatenate(blocks), np.concatenate(valids), k, n_dev, el_cap, c_node)
    edge_words = [torch.cat([w, keys.revcomp(w, k)]) for w in words]
    valid = [torch.from_numpy(v) for v in valids]
    got = td._node_record_exchange(edge_words, valid, LoopbackComm(n_dev, "cpu"), k, el_cap, c_node)
    names = ("succ_gid", "succ_lastb", "has_pred", "pred_gid", "tail_dead", "head_dead")
    for name, g, w in zip(names, got, want):
        for r in range(n_dev):
            np.testing.assert_array_equal(g[r].numpy(), w[r * el_cap : (r + 1) * el_cap], err_msg=f"{name} rank {r}")
    drops = [int(d) for d in got[6]]
    assert drops == [int(d) for d in want[6]]
    assert (sum(drops) > 0) == (c_node_factor < 1)
    assert any((g >= 0).any() for g in got[0]) and any(p.any() for p in got[2])


def test_pair_hash_is_the_reference_fold_over_both_keys():
    """``bucket_hash(v, L, bucket_hash(u, L))`` is the reference's hash of
    the 2L limbs (u, v): the owner of a bubble's group."""
    rng = np.random.default_rng(5)
    for k in (15, 21, 41, 63):
        L = jax_keys.nlimbs(k)
        mask = np.asarray(jax_keys.key_mask(k - 1) if jax_keys.nlimbs(k - 1) == L else np.concatenate(
            [np.zeros(L - jax_keys.nlimbs(k - 1), np.uint32), jax_keys.key_mask(k - 1)]))
        u = rng.integers(0, 1 << 32, (200, L), dtype=np.uint64).astype(np.uint32) & mask
        v = rng.integers(0, 1 << 32, (200, L), dtype=np.uint64).astype(np.uint32) & mask
        want = np.asarray(jax_keys.bucket_hash(np.concatenate([u, v], axis=1))).astype(np.int64)
        W = keys.nwords(k)
        uw, vw = convert.limbs_to_words(u, "cpu", W), convert.limbs_to_words(v, "cpu", W)
        got = keys.bucket_hash(vw, L, keys.bucket_hash(uw, L))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_dev", [2, 8])
@pytest.mark.parametrize("k", [21, 41])
def test_fragment_emission_matches_full_fetch(k, n_dev):
    """The fragments of the held shards give the contigs of the whole
    fetched arrays and of the reference's emission, and account the bytes
    they copied: less than the arrays they were selected from."""
    c_local = C_LOCAL[n_dev]
    (rl, rc, rn), (words, _, n) = _both(k, n_dev, 3)
    comm = LoopbackComm(n_dev, "cpu")
    sc = td.dist_chains_step(words, n, comm, k, c_local)
    frag = td.local_chain_fragments(sc, k)
    new = td.assemble_contig_fragments([frag], k)
    idx = np.flatnonzero(fetch_global(comm, sc.valid))
    old = assemble_contig_bytes(
        fetch_global(comm, sc.chain)[idx], fetch_global(comm, sc.pos)[idx], fetch_global(comm, sc.edge_words)[idx], k
    )
    assert new == old and len(new) > 2
    assert td.shard_chains_to_contigs(sc, comm, k) == new
    ref = ref_td.make_dist_chains_step(k, n_dev, c_local, make_mesh(n_dev))(rl, rc, rn)
    assert new == ref_td.shard_chains_to_contigs(ref, k)
    ref_frag = ref_td.local_chain_fragments(ref, k)
    for name in ("chain", "pos", "base", "start_chain", "start_prefix"):
        np.testing.assert_array_equal(frag[name], ref_frag[name], err_msg=name)
    full = sum(x.numel() * x.element_size() for name in ("edge_words", "valid", "chain", "pos", "is_start") for x in getattr(sc, name))
    compact = frag["chain"].nbytes + frag["pos"].nbytes + frag["base"].nbytes
    assert 0 < compact < frag["d2h_bytes"] < full
    # two processes' fragments merge to the same set
    half = len(frag["chain"]) // 2
    sh = len(frag["start_chain"]) // 2
    parts = [
        {key: (v[:cut] if first else v[cut:]) for key, v, cut in (
            ("chain", frag["chain"], half), ("pos", frag["pos"], half), ("base", frag["base"], half),
            ("start_chain", frag["start_chain"], sh), ("start_prefix", frag["start_prefix"], sh))}
        for first in (True, False)
    ]
    assert td.assemble_contig_fragments(parts, k) == new


class _TwoProcessComm:
    """A comm of two processes that hold a rank each, of which this is one:
    the collectives pair this process's tensors with the other's, given."""

    def __init__(self, rank, other):
        self.world, self.ranks, self.device, self.other = 2, [rank], torch.device("cpu"), other

    def _both(self, mine, theirs):
        return [mine, theirs] if self.ranks[0] == 0 else [theirs, mine]

    def process_allgather(self, values):
        return np.asarray(self._both(list(values), self.other["sizes"]), dtype=np.int64)

    def all_gather(self, xs):
        theirs = self.other["tensors"].pop(0)
        pad = torch.zeros((xs[0].shape[0] - theirs.shape[0],) + tuple(theirs.shape[1:]), dtype=theirs.dtype)
        return [torch.cat(self._both(xs[0], torch.cat([theirs, pad])))]


def test_allgather_fragments_pads_and_cuts_ragged_parts():
    k = 21
    (_, _, _), (words, _, n) = _both(k, 2, 3)
    comm = LoopbackComm(2, "cpu")
    sc = td.dist_chains_step(words, n, comm, k, C_LOCAL[2])
    frags = [td.local_chain_fragments(td.ShardChains(*[[f[r]] for f in sc]), k) for r in range(2)]
    assert len(frags[0]["chain"]) != len(frags[1]["chain"])
    want = td.shard_chains_to_contigs(sc, comm, k)
    for rank in range(2):
        mine, theirs = frags[rank], frags[1 - rank]
        other = {
            "sizes": [theirs["chain"].size, theirs["start_chain"].size],
            "tensors": [
                torch.from_numpy(np.stack([theirs["chain"], theirs["pos"]], 1)), torch.from_numpy(theirs["base"]),
                torch.from_numpy(theirs["start_chain"]), torch.from_numpy(theirs["start_prefix"]),
            ],
        }
        got = td._allgather_fragments(mine, _TwoProcessComm(rank, other))
        for g, w in zip(got, frags):
            for name in ("chain", "pos", "base", "start_chain", "start_prefix"):
                np.testing.assert_array_equal(g[name], w[name], err_msg=name)
        assert td.assemble_contig_fragments(got, k) == want
