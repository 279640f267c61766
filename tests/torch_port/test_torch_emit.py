"""Contig emission: port vs tpu_euler.euler.extract.chains_to_contigs_device_spec,
exact, on chains that are first checked equal to the reference's."""

import numpy as np
import pytest

from tpu_euler.euler import extract as jax_extract
from tpu_euler.euler import unitigs as jax_unitigs
from tpu_euler.graph.build import build_graph_staged as jax_build
from tpu_euler_torch import convert, trace
from tpu_euler_torch.euler.extract import chains_to_contigs_device_spec
from tpu_euler_torch.euler.unitigs import chains_from_successors_spec, successor
from tpu_euler_torch.graph.build import build_graph_staged
from tpu_euler_torch.kmer import keys
from torch_port_inputs import cut_spectrum


@pytest.mark.parametrize(
    "kind,k,err",
    [("circular", 31, 0.0), ("repeat", 21, 0.0), ("circular", 21, 0.004),
     ("circular", 41, 0.0), ("repeat", 33, 0.004), ("repeat", 63, 0.004)],
)
def test_emission_matches_reference(kind, k, err):
    ref_spec = cut_spectrum(kind, k, 1 << 14, err)
    spec = convert.spectrum_from_reference(ref_spec, "cpu", keys.nwords(k))
    ref_g = jax_build(ref_spec, k)
    ref_chains = jax_unitigs.chains_from_successors_spec(
        ref_spec.limbs, ref_g.edge_valid, jax_unitigs.successor(ref_g, k), k
    )
    g = build_graph_staged(spec, k)
    chains = chains_from_successors_spec(spec.words, g.edge_valid, successor(g), k)
    r, c = convert.records_to_numpy(ref_chains), convert.records_to_numpy(chains)
    for name in r:
        np.testing.assert_array_equal(c[name], r[name], err_msg=name)

    want = jax_extract.chains_to_contigs_device_spec(ref_spec.limbs, ref_chains, k)
    got = chains_to_contigs_device_spec(spec.words, chains, k)
    assert got == want and len(got) >= 1
    assert (len(got) > 1) == (kind == "repeat" or err > 0)
    # capacities too small for the output: the exact-capacity rerun
    assert chains_to_contigs_device_spec(spec.words, chains, k, 8, 1) == want


@pytest.mark.parametrize("kind,k,err", [("repeat", 21, 0.004), ("circular", 31, 0.0), ("repeat", 41, 0.004), ("repeat", 63, 0.0)])
def test_host_and_materialized_emissions_match_reference(kind, k, err):
    """The host path and the emission over materialized edge keys give the
    reference's contigs and the virtual-array emission's."""
    from tpu_euler.graph.build import build_graph as jax_build_graph
    from tpu_euler_torch.euler import extract
    from tpu_euler_torch.euler.unitigs import unitig_chains
    from tpu_euler_torch.graph.build import build_graph

    ref_spec = cut_spectrum(kind, k, 1 << 13, err)
    ref_g = jax_build_graph(ref_spec, k)
    ref_chains = jax_unitigs.unitig_chains(ref_g, k)
    want = jax_extract.chains_to_contigs(ref_g, ref_chains, k)
    assert jax_extract.chains_to_contigs_device(ref_g, ref_chains, k) == want

    spec = convert.spectrum_from_reference(ref_spec, "cpu", keys.nwords(k))
    g = build_graph(spec, k)
    chains = unitig_chains(g, k)
    assert extract.chains_to_contigs(g, chains, k) == want
    assert extract.chains_to_contigs(g.edge_words, chains, k) == want
    assert extract.chains_to_contigs_device(g, chains, k) == want
    assert chains_to_contigs_device_spec(spec.words, chains, k) == want
    before = trace.totals()
    assert extract.chains_to_contigs_device(g.edge_words, chains, k, 8, 1) == want
    assert trace.since(before)["emit_reruns"] == 1


def test_emission_of_no_chain_is_empty():
    from tpu_euler_torch.euler import extract
    from tpu_euler_torch.euler.unitigs import unitig_chains
    from tpu_euler_torch.graph.build import build_graph
    from tpu_euler_torch.kmer.count import empty_spectrum

    g = build_graph(empty_spectrum(16, 21, "cpu"), 21)
    chains = unitig_chains(g, 21)
    assert extract.chains_to_contigs(g, chains, 21) == set()
    assert extract.chains_to_contigs_device(g, chains, 21) == set()
