"""Contig emission: port vs tpu_euler.euler.extract.chains_to_contigs_device_spec,
exact, on chains that are first checked equal to the reference's; and the
canonical emission kernel's plain version (``emit_kernel``) and its g++ host
build (``csrc/emit_canonical_host.cpp``) against the numpy canonicalization
of the port and of the reference, bit for bit between the two."""

import ctypes

import numpy as np
import pytest
import torch

from tpu_euler.euler import extract as jax_extract
from tpu_euler.euler import unitigs as jax_unitigs
from tpu_euler.graph.build import build_graph_staged as jax_build
from tpu_euler.euler.extract import canonicalize_contig_buffer as jax_canonicalize
from tpu_euler_torch import _build, convert, trace
from tpu_euler_torch.euler import emit_kernel
from tpu_euler_torch.euler.extract import canonicalize_contig_buffer
from tpu_euler_torch.euler.extract import chains_to_contigs_device_spec
from tpu_euler_torch.euler.unitigs import chains_from_successors_spec, successor
from tpu_euler_torch.graph.build import build_graph_staged
from tpu_euler_torch.kmer import keys
from emit_inputs import TWIN_CASES, contig_cases, emission_inputs
from torch_port_inputs import cut_spectrum

KS = (21, 31, 41, 63)
CASE_NAMES = list(contig_cases(21))


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


def _case(k, case):
    """A case's kernel inputs and its contigs; its twins where it has them."""
    contigs = contig_cases(k)[case]
    codes, off, sw, n, total = emission_inputs(contigs, k, junk_seed=k)
    twin = torch.tensor(TWIN_CASES[case]) if case in TWIN_CASES else None
    return contigs, (codes, off, sw, n, total, k, twin)


def _expected_repeats(contigs, twin):
    """The twin where it is lower and its canonical form is the same."""
    canon = [min(c, c.translate(str.maketrans("ACGT", "TGCA"))[::-1]) for c in contigs]
    if twin is None:
        return [-1] * len(contigs)
    return [t if 0 <= t < c and canon[t] == canon[c] else -1 for c, t in enumerate(twin.tolist())]


def _expected_second_pass(contigs):
    """Contigs longer than twice the window whose first PREFIX_WINDOW
    positions mirror themselves."""
    w = emit_kernel.PREFIX_WINDOW
    return sum(
        (len(c) + 1) // 2 > w and all(c[j] == "ACGT"["TGCA".index(c[len(c) - 1 - j])] for j in range(w))
        for c in contigs
    )


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", CASE_NAMES)
def test_plain_canonical_bytes_match_numpy_and_reference(k, case):
    """The plain version's buffer: the offsets as laid out, the second
    pass's count, the twins that repeat, and the contig set (repeats left
    out) of the port's and the reference's ``canonicalize_contig_buffer``
    over the same contigs."""
    contigs, args = _case(k, case)
    codes, off, sw, n, total, _, twin = args
    buf = emit_kernel.canonical_bytes(*args)
    assert buf.dtype == torch.uint8 and buf.shape == (8 * emit_kernel.header_words(n) + total,)
    got_off, mirrored, rep, body = emit_kernel.split(buf, n)
    assert got_off == off.tolist() + [total]
    assert mirrored == _expected_second_pass(contigs)
    assert rep == _expected_repeats(contigs, twin)
    ascii_buf = np.frombuffer("".join(contigs).encode(), dtype=np.uint8)
    offsets = np.array(got_off, dtype=np.int64)
    want = canonicalize_contig_buffer(ascii_buf, offsets)
    assert want == jax_canonicalize(ascii_buf, offsets)
    assert {bytes(body[a:b]) for a, b in zip(got_off, got_off[1:])} == want
    assert emit_kernel.contig_set(buf, n) == (want, mirrored)
    if case.startswith(("own_rc", "mirror")):
        assert mirrored >= 1 or case == "own_rc_short"
    if case == "twins":
        assert sum(r >= 0 for r in rep) == 6


@pytest.fixture(scope="module")
def host():
    lib = _build.load_cpp(
        "emit_canonical_host", _build.CSRC / "emit_canonical_host.cpp", headers=(_build.CSRC / "emit_canonical.cuh",)
    )
    lib.emit_canonical_host.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
    lib.emit_canonical_host.restype = ctypes.c_int
    return lib


def host_canonical_bytes(lib, codes, off, sw, n, total, k, twin=None):
    """The host build with ``canonical_bytes``' contract, into a buffer
    filled with junk first."""
    emit_kernel._check(codes, off, sw, n, total, k, twin)
    h = 8 * emit_kernel.header_words(n)
    buf = torch.full((h + total,), 0xA5, dtype=torch.uint8)
    state = torch.zeros(2 * n + 1, dtype=torch.int64)
    err = lib.emit_canonical_host(codes.data_ptr(), off.data_ptr(), sw.data_ptr(),
                                  None if twin is None else twin.data_ptr(), buf[h:].data_ptr(),
                                  buf[:h].data_ptr(), state.data_ptr(), n, total, k, keys.nwords(k))
    assert err == 0
    return buf


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", CASE_NAMES)
def test_host_build_matches_plain_bit_for_bit(host, k, case):
    """The kernel's functions (decide, the second pass, the 16-byte write
    groups with their fast path, the twins' check) give the plain version's
    buffer byte for byte, header included, whatever the prefix slots hold."""
    _, args = _case(k, case)
    assert torch.equal(host_canonical_bytes(host, *args), emit_kernel.canonical_bytes_plain(*args))


@pytest.mark.parametrize("shift", [1, 3, 8])
def test_host_build_unaligned_codes(host, shift):
    """Codes that do not start on 16 bytes (a slice), and offsets that do
    not fall on a write group: the same bytes."""
    codes, off, sw, n, total = emission_inputs(contig_cases(31)["n257"], 31)
    moved = torch.cat([torch.zeros(shift, dtype=torch.uint8), codes])[shift:]
    assert torch.equal(host_canonical_bytes(host, moved, off, sw, n, total, 31),
                       emit_kernel.canonical_bytes_plain(codes, off, sw, n, total, 31))


def test_canonical_bytes_checks_its_inputs():
    """No contig, a key of the wrong width, codes shorter than the bytes, a
    device with no kernel: each raises, before any work."""
    codes, off, sw, n, total = emission_inputs(contig_cases(41)["odd_even"], 41)
    with pytest.raises(ValueError):
        emit_kernel.canonical_bytes(codes, off, sw, 0, total, 41)
    with pytest.raises(TypeError):
        emit_kernel.canonical_bytes(codes, off, sw[:, 1].contiguous(), n, total, 41)
    with pytest.raises(ValueError):
        emit_kernel.canonical_bytes(codes[: total - 1], off, sw, n, total, 41)
    with pytest.raises(TypeError):
        emit_kernel.canonical_bytes(codes.to(torch.int64), off, sw, n, total, 41)
    with pytest.raises(ValueError, match="no kernel"):
        emit_kernel.canonical_bytes(codes.to("meta"), off.to("meta"), sw.to("meta"), n, total, 41)


@pytest.mark.parametrize("k", KS)
def test_rerun_feeds_the_kernel_once_with_exact_capacities(k, monkeypatch):
    """A capacity overflow reruns the scatter once, and only the rerun's
    buffer reaches the canonical bytes: one call, whose contigs are the
    reference's, every contig beyond them a twin that repeats one."""
    from tpu_euler_torch.euler import extract

    ref_spec = cut_spectrum("repeat", k, 1 << 13, 0.004)
    ref_g = jax_build(ref_spec, k)
    ref_chains = jax_unitigs.chains_from_successors_spec(
        ref_spec.limbs, ref_g.edge_valid, jax_unitigs.successor(ref_g, k), k
    )
    want = jax_extract.chains_to_contigs_device_spec(ref_spec.limbs, ref_chains, k)
    spec = convert.spectrum_from_reference(ref_spec, "cpu", keys.nwords(k))
    g = build_graph_staged(spec, k)
    chains = chains_from_successors_spec(spec.words, g.edge_valid, successor(g), k)
    calls, repeats = [], []

    def spy(codes, chain_off, start_words, n, total, k_, twin):
        calls.append((codes.shape[0], chain_off.shape[0], n, total))
        buf = emit_kernel.canonical_bytes(codes, chain_off, start_words, n, total, k_, twin)
        repeats.append(sum(r >= 0 for r in emit_kernel.split(buf, n)[2]))
        return buf

    monkeypatch.setattr(extract, "canonical_bytes", spy)
    before = trace.totals()
    assert chains_to_contigs_device_spec(spec.words, chains, k, 8, 1) == want
    assert trace.since(before)["emit_reruns"] == 1
    ((cap, chain_cap, n, total),) = calls
    # each contig is emitted from its chain and its twin's; the kernel marks
    # the twin that repeats, and the host leaves it out
    assert len(want) <= n <= chain_cap and sum(map(len, want)) <= total <= cap
    assert repeats == [n - len(want)]
