"""Contig emission: port vs tpu_euler.euler.extract.chains_to_contigs_device_spec,
exact, on chains that are first checked equal to the reference's."""

import numpy as np
import pytest

from tpu_euler.euler import extract as jax_extract
from tpu_euler.euler import unitigs as jax_unitigs
from tpu_euler.graph.build import build_graph_staged as jax_build
from tpu_euler_torch import convert
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
