"""Staged graph build: port vs tpu_euler.graph.build_graph_staged, exact,
on a reference spectrum carried across by ``convert``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_euler.euler.unitigs import successor as jax_successor
from tpu_euler.graph.build import build_graph_staged as jax_build
from tpu_euler.graph.build import gather_edge_rows as jax_gather
from tpu_euler_torch import convert
from tpu_euler_torch.euler.unitigs import successor
from tpu_euler_torch.graph.build import build_graph_staged, gather_edge_rows
from tpu_euler_torch.kmer import keys
from torch_port_inputs import cut_spectrum

CASES = [  # (genome, k, err, min_count, node_cap)
    ("circular", 21, 0.0, 1, 0),
    ("repeat", 31, 0.0, 1, 0),
    ("circular", 31, 0.004, 1, 0),  # errors kept: tips and bubbles
    ("repeat", 21, 0.0, 1, 3 << 14),  # trimmed node arrays
    ("repeat", 41, 0.0, 1, 0),  # two-word keys: 80-bit endpoints
    ("circular", 33, 0.004, 1, 0),  # 64-bit endpoints in two words
    ("repeat", 63, 0.004, 1, 0),  # three words; endpoints with an empty word 0
]


@pytest.mark.parametrize("kind,k,err,min_count,node_cap", CASES)
def test_build_graph_staged(kind, k, err, min_count, node_cap):
    ref_spec = cut_spectrum(kind, k, 1 << 14, err, min_count)
    spec = convert.spectrum_from_reference(ref_spec, "cpu", keys.nwords(k))
    ref = jax_build(ref_spec, k, node_cap)
    got = build_graph_staged(spec, k, node_cap)
    assert got.n_nodes == int(ref.n_nodes)
    assert got.n_edges == int(ref.n_edges)
    r, g = convert.records_to_numpy(ref), convert.records_to_numpy(got)
    for name in ("edge_valid", "tail", "head", "indeg", "outdeg", "out_first", "succ_cand"):
        np.testing.assert_array_equal(g[name], r[name], err_msg=name)
    assert (r["succ_cand"] >= 0).any()
    assert (r["indeg"] > 1).any() == (kind == "repeat" or err > 0)
    np.testing.assert_array_equal(
        successor(got).numpy(), np.asarray(jax_successor(ref, k)), err_msg="successor"
    )


@pytest.mark.parametrize("k", [21, 31, 33, 41, 63])
def test_gather_edge_rows(k):
    ref_spec = cut_spectrum("repeat", k, 1 << 14)
    spec = convert.spectrum_from_reference(ref_spec, "cpu", keys.nwords(k))
    E = 2 * spec.words.shape[0]
    idx = np.arange(-3, E + 3, dtype=np.int32)  # out-of-range ids are clipped
    want = jax_gather(ref_spec.limbs, jnp.asarray(idx), k)
    got = gather_edge_rows(spec.words, torch.from_numpy(idx.astype(np.int64)), k)
    assert torch.equal(got, convert.limbs_to_words(np.asarray(want), "cpu", keys.nwords(k)))


def test_node_capacity_overflow_raises():
    spec = convert.spectrum_from_reference(cut_spectrum("repeat", 21, 1 << 14), "cpu", 1)
    with pytest.raises(RuntimeError, match="node capacity"):
        build_graph_staged(spec, 21, node_cap=1024)


BUILD_CASES = [("circular", 21, 0.0), ("repeat", 31, 0.0), ("circular", 31, 0.004), ("repeat", 41, 0.0), ("repeat", 63, 0.004)]


@pytest.mark.parametrize("kind,k,err", BUILD_CASES)
def test_build_graph_matches_reference_and_staged(kind, k, err):
    """``build_graph``: the reference's fields one by one, the edge keys
    after the limb/word mapping, and the port's staged build plus keys."""
    from tpu_euler.graph.build import build_graph as jax_build_graph
    from tpu_euler_torch.graph.build import build_graph, doubled_edges

    ref_spec = cut_spectrum(kind, k, 1 << 13, err)
    spec = convert.spectrum_from_reference(ref_spec, "cpu", keys.nwords(k))
    ref = jax_build_graph(ref_spec, k)
    got = build_graph(spec, k)
    assert (got.n_nodes, got.n_edges) == (int(ref.n_nodes), int(ref.n_edges))
    r, g = convert.records_to_numpy(ref), convert.records_to_numpy(got)
    valid = r["edge_valid"]
    for name in ("edge_valid", "indeg", "outdeg", "out_first", "succ_cand"):
        np.testing.assert_array_equal(g[name], r[name], err_msg=name)
    for name in ("tail", "head"):  # the reference leaves garbage on invalid edges
        np.testing.assert_array_equal(g[name][valid], r[name][valid], err_msg=name)
    want = convert.limbs_to_words(r["edge_limbs"], "cpu", keys.nwords(k))
    assert torch.equal(got.edge_words[torch.from_numpy(valid.copy())], want[torch.from_numpy(valid.copy())])
    staged = build_graph_staged(spec, k)
    assert staged.edge_words is None
    for name in staged._fields[:-1]:
        a, b = getattr(staged, name), getattr(got, name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, name
    words, edge_valid = doubled_edges(spec, k)
    assert torch.equal(words, got.edge_words) and torch.equal(edge_valid, got.edge_valid)
    idx = torch.arange(words.shape[0])
    assert torch.equal(gather_edge_rows(spec.words, idx, k), words)


@pytest.mark.parametrize("kind,k,err", BUILD_CASES)
def test_unitig_chains_matches_reference(kind, k, err):
    from tpu_euler.euler.unitigs import transition_keys as jax_transition_keys
    from tpu_euler.euler.unitigs import unitig_chains as jax_unitig_chains
    from tpu_euler.graph.build import build_graph as jax_build_graph
    from tpu_euler_torch.euler.unitigs import transition_keys, unitig_chains
    from tpu_euler_torch.graph.build import build_graph

    ref_spec = cut_spectrum(kind, k, 1 << 13, err)
    ref = jax_build_graph(ref_spec, k)
    got = build_graph(convert.spectrum_from_reference(ref_spec, "cpu", keys.nwords(k)), k)
    t_ref = jax_transition_keys(ref, jax_successor(ref, k), k)
    t = transition_keys(got, successor(got), k)
    assert torch.equal(t, convert.tkeys_from_limbs(np.asarray(t_ref), "cpu"))
    r = convert.records_to_numpy(jax_unitig_chains(ref, k))
    c = convert.records_to_numpy(unitig_chains(got, k))
    for name in r:
        np.testing.assert_array_equal(c[name], r[name], err_msg=name)


def _real_graph(k=21):
    from tpu_euler_torch.euler.unitigs import unitig_chains
    from tpu_euler_torch.graph.build import build_graph

    spec = convert.spectrum_from_reference(cut_spectrum("repeat", k, 1 << 13, 0.004), "cpu", keys.nwords(k))
    g = build_graph(spec, k)
    return spec, g, unitig_chains(g, k)


def test_validators_clean_on_real_graph_and_equal_reference():
    from tpu_euler.euler.unitigs import unitig_chains as jax_unitig_chains
    from tpu_euler.graph import validate as jax_validate
    from tpu_euler.graph.build import build_graph as jax_build_graph
    from tpu_euler_torch.graph.validate import validate_chains, validate_graph

    _, g, chains = _real_graph()
    assert validate_graph(g, 21) == [] and validate_chains(g, chains, 21) == []
    ref = jax_build_graph(cut_spectrum("repeat", 21, 1 << 13, 0.004), 21)
    assert jax_validate.validate_graph(ref, 21) == []
    assert jax_validate.validate_chains(ref, jax_unitig_chains(ref, 21), 21) == []


@pytest.mark.parametrize(
    "field,message",
    [
        ("n_edges", "edge_valid sum"),
        ("tail", "tail ids out of range"),
        ("head", "head ids out of range"),
        ("indeg", "degree sums != edge count"),
        ("outdeg", "in/out degree multisets differ"),
    ],
)
def test_validate_graph_names_a_corrupted_graph(field, message):
    from tpu_euler_torch.graph.validate import validate_graph

    _, g, _ = _real_graph()
    if field == "n_edges":
        bad = g._replace(n_edges=g.n_edges + 1)
    elif field in ("tail", "head"):
        t = getattr(g, field).clone()
        t[0] = g.n_nodes
        bad = g._replace(**{field: t})
    else:
        t = getattr(g, field).clone()
        t[0] += 1
        bad = g._replace(**{field: t})
    assert any(message in e for e in validate_graph(bad, 21))


@pytest.mark.parametrize(
    "field,message",
    [("pos_dup", "duplicate (chain, pos)"), ("pos_gap", "non-contiguous positions"),
     ("head", "non-adjacent consecutive edges"), ("length", "pos out of range")],
)
def test_validate_chains_names_corrupted_chains(field, message):
    from tpu_euler_torch.graph.validate import validate_chains

    _, g, chains = _real_graph()
    long_chain = int(chains.chain[torch.argmax(chains.length)])
    members = torch.nonzero(chains.chain == long_chain).squeeze(1)
    e = int(members[chains.pos[members] == 1])
    if field == "pos_dup":
        pos = chains.pos.clone()
        pos[e] = 0
        chains = chains._replace(pos=pos)
    elif field == "pos_gap":
        pos = chains.pos.clone()
        pos[members] = torch.where(chains.pos[members] >= 1, chains.pos[members] + 1, chains.pos[members])
        chains = chains._replace(pos=pos, length=chains.length + 1)
    elif field == "head":
        head = g.head.clone()
        head[e] = (head[e] + 1) % g.n_nodes
        g = g._replace(head=head)
    else:
        length = chains.length.clone()
        length[e] = 1
        chains = chains._replace(length=length)
    assert any(message in m for m in validate_chains(g, chains, 21))
