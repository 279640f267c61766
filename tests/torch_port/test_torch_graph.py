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
