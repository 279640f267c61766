"""Checkpoints: round trips in the port, and across packages both ways:
the port loads a spectrum and a graph checkpoint that the reference wrote,
and the reference loads the port's. Exact equality after the limb/word
mapping."""

import numpy as np
import pytest
import torch

from tpu_euler.euler import extract as jax_extract
from tpu_euler.euler.unitigs import unitig_chains as jax_unitig_chains
from tpu_euler.graph.build import build_graph as jax_build_graph
from tpu_euler.pipeline import checkpoint as jax_ckpt
from tpu_euler_torch import convert
from tpu_euler_torch.euler import extract
from tpu_euler_torch.euler.unitigs import chains_from_successors_spec, successor, unitig_chains
from tpu_euler_torch.graph.build import build_graph, build_graph_staged
from tpu_euler_torch.kmer import keys
from tpu_euler_torch.pipeline import checkpoint as ckpt
from torch_port_inputs import cut_spectrum

KS = [31, 41]


def _spectra(k):
    ref = cut_spectrum("repeat", k, 1 << 13, 0.004)
    return ref, convert.spectrum_from_reference(ref, "cpu", keys.nwords(k))


def _assert_spec_equal(a, b):
    assert a.n == b.n
    assert torch.equal(a.words[: a.n], b.words[: b.n]) and torch.equal(a.counts[: a.n], b.counts[: b.n])
    assert not a.words[a.n :].any() and not a.counts[a.n :].any()


@pytest.mark.parametrize("k", KS + [63])
def test_spectrum_round_trip(tmp_path, k):
    _, spec = _spectra(k)
    path = str(tmp_path / "s.npz")
    ckpt.save_spectrum(path, spec, k)
    got, k2 = ckpt.load_spectrum(path, "cpu")
    assert k2 == k and got.words.shape[0] == spec.n
    _assert_spec_equal(got, spec)
    padded, _ = ckpt.load_spectrum(path, "cpu", capacity=spec.n + 100)
    assert padded.words.shape[0] == spec.n + 100
    _assert_spec_equal(padded, spec)
    with pytest.raises(ValueError, match="capacity"):
        ckpt.load_spectrum(path, "cpu", capacity=spec.n - 1)


@pytest.mark.parametrize("k", KS)
def test_spectrum_crosses_packages_both_ways(tmp_path, k):
    ref, spec = _spectra(k)
    theirs, ours = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    jax_ckpt.save_spectrum(theirs, ref, k)
    ckpt.save_spectrum(ours, spec, k)
    with np.load(theirs) as a, np.load(ours) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype and np.array_equal(a[name], b[name]), name
    got, k2 = ckpt.load_spectrum(theirs, "cpu")
    assert k2 == k
    _assert_spec_equal(got, spec)
    back, k3 = jax_ckpt.load_spectrum(ours)
    assert k3 == k and int(back.n) == int(ref.n)
    np.testing.assert_array_equal(np.asarray(back.limbs), np.asarray(ref.limbs)[: int(ref.n)])
    np.testing.assert_array_equal(np.asarray(back.counts), np.asarray(ref.counts)[: int(ref.n)])


def _graphs(k):
    ref_spec, spec = _spectra(k)
    ref_g = jax_build_graph(ref_spec, k)
    g = build_graph(spec, k)
    return spec, ref_g, jax_unitig_chains(ref_g, k), g, unitig_chains(g, k)


@pytest.mark.parametrize("k", KS)
def test_graph_crosses_packages_both_ways(tmp_path, k):
    spec, ref_g, ref_chains, g, chains = _graphs(k)
    want = jax_extract.chains_to_contigs(ref_g, ref_chains, k)
    theirs, ours = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    jax_ckpt.save_graph(theirs, ref_g, ref_chains, k)
    ckpt.save_graph(ours, g, chains, k)
    with np.load(theirs) as a, np.load(ours) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype and np.array_equal(a[name], b[name]), name
    # the port loads the reference's file
    g2, chains2, k2 = ckpt.load_graph(theirs, "cpu")
    assert k2 == k and g2.n_edges == g.n_edges
    valid = g.edge_valid
    assert torch.equal(g2.edge_words, g.edge_words[valid])
    for name in ("pos", "length", "is_start", "from_cycle"):
        assert torch.equal(getattr(chains2, name), getattr(chains, name)[valid]), name
    assert extract.chains_to_contigs_device(g2, chains2, k) == want
    assert extract.chains_to_contigs(g2, chains2, k) == want
    # the reference loads the port's file
    g3, chains3, k3 = jax_ckpt.load_graph(ours)
    assert k3 == k
    assert jax_extract.chains_to_contigs_device(g3, chains3, k) == want


@pytest.mark.parametrize("k", KS)
def test_graph_checkpoint_from_the_staged_route(tmp_path, k):
    """The pipeline's form: tail/head and chains of the staged build, edge
    keys gathered from the spectrum for the valid edges only."""
    import types

    spec, _, _, g, chains = _graphs(k)
    staged = build_graph_staged(spec, k)
    walked = chains_from_successors_spec(spec.words, staged.edge_valid, successor(staged), k)
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    ckpt.save_graph(a, g, chains, k)
    ends = types.SimpleNamespace(tail=staged.tail, head=staged.head)
    ckpt.save_graph(b, ends, walked, k, spec_words=spec.words)
    with np.load(a) as za, np.load(b) as zb:
        for name in za.files:
            assert np.array_equal(za[name], zb[name]), name
        assert za["edge_limbs"].shape[0] == 2 * spec.n < 2 * spec.words.shape[0]


def test_unknown_versions_are_refused(tmp_path):
    spec, _, _, g, chains = _graphs(31)
    s, gpath = str(tmp_path / "s.npz"), str(tmp_path / "g.npz")
    ckpt.save_spectrum(s, spec, 31)
    ckpt.save_graph(gpath, g, chains, 31)
    for path, load in ((s, ckpt.load_spectrum), (gpath, ckpt.load_graph)):
        with np.load(path) as z:
            fields = {name: z[name] for name in z.files}
        fields["version"] = np.asarray(99)
        np.savez_compressed(path, **fields)
        with pytest.raises(ValueError, match="version"):
            load(path, "cpu")
