"""Unitig chains: port vs tpu_euler.euler.unitigs.chains_from_successors_spec,
exact, on both the ruling-set walk (E > min_edges) and the doubling path
(E <= min_edges), plus the ranking module on random functional graphs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_euler.euler import ranking as jax_ranking
from tpu_euler.euler import unitigs as jax_unitigs
from tpu_euler.graph.build import build_graph_staged as jax_build
from tpu_euler_torch import convert
from tpu_euler_torch.euler import ranking
from tpu_euler_torch.euler.unitigs import (
    _apply_cut,
    chains_from_successors_spec,
    chains_from_t,
    successor,
    transition_keys_spec,
)
from tpu_euler_torch.graph.build import build_graph_staged
from tpu_euler_torch.kmer import keys
from tpu_euler_torch.simulate import FUNCTIONAL_GRAPHS, functional_graph, functional_graph_inputs
from torch_port_inputs import cut_spectrum

FIELDS = ("chain", "pos", "length", "is_start", "from_cycle", "in_chain")


# capacity 2^18 -> E = 2^19 > 2^17: the ruling walk at the default min_edges;
# capacity 2^14 -> E = 2^15: doubling by default, the walk with min_edges=0
# k = 41, 63: multi-word keys, transition keys compared as dense ranks
@pytest.mark.parametrize("k", [31, 41, 63])
@pytest.mark.parametrize("kind", ["circular", "repeat"])
@pytest.mark.parametrize(
    "capacity,min_edges", [(1 << 18, 1 << 17), (1 << 14, 1 << 17), (1 << 14, 0)],
    ids=["ruling", "doubling", "ruling-small"],
)
def test_chains_from_successors_spec(kind, capacity, min_edges, k):
    ref_spec = cut_spectrum(kind, k, capacity)
    spec = convert.spectrum_from_reference(ref_spec, "cpu", keys.nwords(k))
    E = 2 * spec.words.shape[0]
    assert (E > min_edges) == (min_edges == 0 or capacity == 1 << 18)
    ref_g = jax_build(ref_spec, k)
    ref_succ = jax_unitigs.successor(ref_g, k)
    ref = jax_unitigs.chains_from_successors_spec(
        ref_spec.limbs, ref_g.edge_valid, ref_succ, k, min_edges
    )
    g = build_graph_staged(spec, k)
    succ = successor(g)
    np.testing.assert_array_equal(succ.numpy(), np.asarray(ref_succ))
    t_ref = jax_unitigs.transition_keys_spec(ref_spec.limbs, ref_succ, k)
    assert torch.equal(
        transition_keys_spec(spec.words, succ, k), convert.tkeys_from_limbs(t_ref, "cpu")
    )
    got = chains_from_successors_spec(spec.words, g.edge_valid, succ, k, min_edges)
    r, c = convert.records_to_numpy(ref), convert.records_to_numpy(got)
    for name in FIELDS:
        np.testing.assert_array_equal(c[name], r[name], err_msg=name)
    # at k = 63 the 80 bp reads (18 windows each) at 15x leave gaps in
    # the circle, so no cycle survives
    assert r["from_cycle"].any() == (kind == "circular" and k < 63)


@pytest.mark.parametrize("seed,E,n_paths,n_cycles,max_len,tbits", FUNCTIONAL_GRAPHS)
def test_ruling_walk_matches_reference(seed, E, n_paths, n_cycles, max_len, tbits):
    succ, valid, t = functional_graph_inputs(seed, E, n_paths, n_cycles, max_len, tbits)
    js, jv, jt = jnp.asarray(succ.astype(np.int32)), jnp.asarray(valid), jnp.asarray(t)
    ref = jax_ranking.cycle_min_ruling_tables(js, jv, jt)
    ps, pv = torch.from_numpy(succ), torch.from_numpy(valid)
    pt = convert.tkeys_from_limbs(t, "cpu")
    got = ranking.cycle_min_ruling_tables(ps, pv, pt)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    assert torch.equal(got[1], convert.tkeys_from_limbs(ref[1], "cpu"))

    ref_cut, ref_is_cut = jax_unitigs._apply_cut(js, jt, ref[0], ref[1])
    cut, is_cut = _apply_cut(ps, pt, got[0], got[1])
    np.testing.assert_array_equal(cut.numpy(), np.asarray(ref_cut))
    rr_ref = jax_ranking.rank_chains_with_cut(ref_cut, jv, ref_is_cut, *ref[2:])
    rr = ranking.rank_chains_with_cut(cut, pv, is_cut, *got[2:])
    r2_ref = jax_ranking.rank_chains_ruling(ref_cut, jv)
    r2 = ranking.rank_chains_ruling(cut, pv)
    for a, b in ((rr, rr_ref), (r2, r2_ref)):
        assert b is not None and a is not None
        np.testing.assert_array_equal(a[0].numpy()[valid], np.asarray(b[0])[valid])
        np.testing.assert_array_equal(a[1].numpy()[valid], np.asarray(b[1])[valid])


@pytest.mark.parametrize("walk_fails", [False, True])
def test_chains_from_t_ownership_handoff(walk_fails, monkeypatch):
    """``[t]`` is popped; with a factory, t is dropped after the cycle cut
    and recomputed only when the walk reports a failure, and the chains are
    those of the bare call either way."""
    ref_spec = cut_spectrum("circular", 41, 1 << 18)
    spec = convert.spectrum_from_reference(ref_spec, "cpu", keys.nwords(41))
    g = build_graph_staged(spec, 41)
    succ = successor(g)
    want = chains_from_successors_spec(spec.words, g.edge_valid, succ, 41)
    if walk_fails:
        monkeypatch.setattr(ranking, "rank_chains_with_cut", lambda *a: None)
        monkeypatch.setattr(ranking, "rank_chains_ruling", lambda *a: None)
    made = []

    def factory():
        made.append(1)
        return transition_keys_spec(spec.words, succ, 41)

    holder = [transition_keys_spec(spec.words, succ, 41)]
    got = chains_from_t(holder, g.edge_valid, succ, t_factory=factory)
    assert holder == [] and len(made) == int(walk_fails)
    for name in FIELDS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_rank_chains_ruling_detects_cycle():
    succ, valid = functional_graph(np.random.default_rng(7), 400, 5, 2, 50, 0)
    assert ranking.rank_chains_ruling(torch.from_numpy(succ), torch.from_numpy(valid)) is None
