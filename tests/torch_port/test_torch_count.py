"""One-shot count, the count helpers, cutoff and right-sizing: port vs
tpu_euler, exact."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_euler.config import AssemblyConfig
from tpu_euler.io.encode import encode_reads
from tpu_euler.kmer import count as jax_count_mod
from tpu_euler.kmer import keys as jax_keys
from tpu_euler.kmer.count import apply_cutoff as jax_cutoff
from tpu_euler.pipeline.assemble import count_spectrum as jax_count
from tpu_euler.pipeline.assemble import right_size_spectrum as jax_right_size
from tpu_euler.reference_impl.simulate import random_genome, simulate_reads
from tpu_euler_torch import convert
from tpu_euler_torch.kmer import count as count_mod
from tpu_euler_torch.kmer import keys
from tpu_euler_torch.kmer.count import apply_cutoff
from tpu_euler_torch.pipeline.assemble import count_spectrum, right_size_spectrum


def _codes(k, seed):
    genome = random_genome(2500, seed=seed)
    reads = simulate_reads(genome, read_len=90, coverage=12, seed=seed + 1, error_rate=0.004)
    reads[2] = reads[2][:50] + "N" + reads[2][51:]
    reads[4] = reads[4][:40]
    return encode_reads(reads, 90)


def _assert_same_spectrum(port, ref, k):
    assert port.n == int(ref.n)
    assert torch.equal(port.words, convert.limbs_to_words(np.asarray(ref.limbs), "cpu", keys.nwords(k)))
    np.testing.assert_array_equal(port.counts.numpy(), np.asarray(ref.counts))


# read_batch 100 leaves a partial (code-4 padded) final batch
@pytest.mark.parametrize("k,seed", [(21, 5), (31, 6), (33, 7), (41, 8)])
def test_oneshot_count_and_cutoff(k, seed):
    codes = _codes(k, seed)
    cfg = AssemblyConfig(k=k, read_batch=100, read_len=90, spectrum_capacity=1 << 14)
    assert codes.shape[0] % cfg.read_batch
    ref, ref_n = jax_count(codes, cfg)
    got, n = count_spectrum(codes, cfg, "cpu")
    assert n == ref_n
    _assert_same_spectrum(got, ref, k)
    assert (got.counts[: got.n] > 1).any() and (got.counts[: got.n] == 1).any()
    for mc in (1, 2, 3):
        _assert_same_spectrum(apply_cutoff(got, mc), jax_cutoff(ref, mc), k)


def test_right_size_spectrum():
    codes = _codes(31, 9)
    cfg = AssemblyConfig(k=31, read_batch=512, read_len=90, spectrum_capacity=1 << 19)
    ref, _ = jax_count(codes, cfg)
    got, _ = count_spectrum(codes, cfg, "cpu")
    rs_ref, rs = jax_right_size(ref), right_size_spectrum(got)
    assert rs.words.shape[0] == rs_ref.limbs.shape[0] == 1 << 18
    _assert_same_spectrum(rs, rs_ref, 31)


def test_count_overflow_and_unported_routes_raise():
    """Every counting route runs (none raises NotImplementedError), and a
    spectrum overflow raises in each: one-shot, grouped (2 batches a group)
    and per batch."""
    codes = _codes(21, 5)
    cfg = AssemblyConfig(k=21, read_batch=256, read_len=90, spectrum_capacity=1 << 8)
    for rows in (cfg.oneshot_rows, 2 * 256 * 70, 0):
        with pytest.raises(RuntimeError, match="overflowed"):
            count_spectrum(codes, dataclasses.replace(cfg, oneshot_rows=rows), "cpu")
    for rows in (2 * 256 * 70, 0):
        big = dataclasses.replace(cfg, oneshot_rows=rows, spectrum_capacity=1 << 14)
        got, n = count_spectrum(codes, big, "cpu")
        assert got.n > 0 and n > 0


def _window_limbs(k, seed, n_rows=600, n_distinct=150):
    """Reference limbs of ``n_rows`` keys drawn from ``n_distinct`` random
    k-mers (so keys repeat), and a validity mask with some invalid rows."""
    rng = np.random.default_rng(seed + k)
    codes = rng.integers(0, 4, (n_distinct, k)).astype(np.int8)
    limbs = np.asarray(jax_keys.pack(jnp.asarray(codes), k))[rng.integers(0, n_distinct, n_rows)]
    valid = rng.random(n_rows) > 0.1
    return limbs, valid


@pytest.mark.parametrize("k", [21, 41, 63])
def test_count_batch_merge_and_overflow_helpers(k):
    nw = keys.nwords(k)
    la, va = _window_limbs(k, 1)
    lb, vb = _window_limbs(k, 2)
    ref_a = jax_count_mod.count_batch(jnp.asarray(la), jnp.asarray(va))
    ref_b = jax_count_mod.count_batch(jnp.asarray(lb), jnp.asarray(vb))
    got_a = count_mod.count_batch(convert.limbs_to_words(la, "cpu", nw), torch.from_numpy(va))
    got_b = count_mod.count_batch(convert.limbs_to_words(lb, "cpu", nw), torch.from_numpy(vb))
    _assert_same_spectrum(got_a, ref_a, k)
    _assert_same_spectrum(got_b, ref_b, k)
    a_limbs, a_counts, a_n = np.asarray(ref_a.limbs), np.asarray(ref_a.counts), int(ref_a.n)
    for C in (600, 160):  # room to spare; fewer rows than distinct keys
        def ref_acc():  # merge_spectra donates its accumulator
            return jax_count_mod.Spectrum(
                jnp.asarray(a_limbs[:C]), jnp.asarray(a_counts[:C]), jnp.asarray(min(a_n, C), jnp.int32)
            )
        acc = convert.spectrum_from_reference(ref_acc(), "cpu", nw)
        ref = jax_count_mod.merge_spectra(ref_acc(), ref_b)
        got = count_mod.merge_spectra(acc, got_b)
        _assert_same_spectrum(got, ref, k)
        assert count_mod.spectrum_overflowed(got) == jax_count_mod.spectrum_overflowed(ref)
    assert count_mod.spectrum_overflowed(got) and not count_mod.spectrum_overflowed(got_a)
    empty = count_mod.empty_spectrum(64, k, "cpu")
    _assert_same_spectrum(empty, jax_count_mod.empty_spectrum(64, jax_keys.nlimbs(k)), k)


@pytest.mark.parametrize("k", [21, 41, 63])
def test_merge_spectra_lean_matches_reference(k):
    """The lean merge of the sharded grouped drain: the reference's jitted
    ``merge_spectra_lean`` and its body ``merge_lean_body``, with room to
    spare and with fewer rows than distinct keys."""
    nw = keys.nwords(k)
    la, va = _window_limbs(k, 3)
    lb, vb = _window_limbs(k, 4)
    ref_a = jax_count_mod.count_batch(jnp.asarray(la), jnp.asarray(va))
    ref_b = jax_count_mod.count_batch(jnp.asarray(lb), jnp.asarray(vb))
    got_b = convert.spectrum_from_reference(ref_b, "cpu", nw)
    a_limbs, a_counts, a_n = np.asarray(ref_a.limbs), np.asarray(ref_a.counts), int(ref_a.n)
    for C in (600, 160):
        def ref_acc():  # merge_spectra_lean donates its accumulator
            return jax_count_mod.Spectrum(
                jnp.asarray(a_limbs[:C]), jnp.asarray(a_counts[:C]), jnp.asarray(min(a_n, C), jnp.int32)
            )
        got = count_mod.merge_spectra_lean(convert.spectrum_from_reference(ref_acc(), "cpu", nw), got_b, k)
        _assert_same_spectrum(got, jax_count_mod.merge_lean_body(ref_acc(), ref_b, k), k)
        _assert_same_spectrum(got, jax_count_mod.merge_spectra_lean(ref_acc(), ref_b, k=k), k)
        assert got.words.shape[0] == C and got.n == min(C, got.n)
    with pytest.raises(ValueError, match="are not k ="):
        count_mod.merge_spectra_lean(got, got_b, 31 if k > 31 else 41)
