"""The owner hash of the sharded mode: ``keys.bucket_hash`` folds the
reference's uint32 limb view of a key, so both packages send a key to the
same rank. Exact, on valid keys (the two packages' sentinels differ, and an
invalid row is routed by its validity, never by its hash)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_euler.io.encode import encode_reads
from tpu_euler.kmer import keys as jax_keys
from tpu_euler.kmer.extract import extract_canonical_kmers as jax_extract
from tpu_euler.reference_impl.simulate import random_genome, simulate_reads
from tpu_euler_torch import convert
from tpu_euler_torch.kmer import keys
from tpu_euler_torch.kmer.extract import extract_canonical_kmers

KS = [21, 31, 33, 41, 63]


def _canonical_keys(k):
    """(reference limbs, port words) of the valid canonical k-mers of a few
    seeded reads with errors, an N and a short read."""
    reads = simulate_reads(random_genome(1500, seed=k), read_len=90, coverage=6, seed=k + 1, error_rate=0.01)
    reads[1] = reads[1][:30] + "N" + reads[1][31:]
    reads[3] = reads[3][:70]
    codes = encode_reads(reads, 90)
    limbs, valid = jax_extract(jnp.asarray(codes), k)
    words, port_valid = extract_canonical_kmers(torch.from_numpy(codes), k)
    np.testing.assert_array_equal(port_valid.numpy(), np.asarray(valid))
    return np.asarray(limbs)[np.asarray(valid)], words[port_valid]


@pytest.mark.parametrize("k", KS)
def test_bucket_hash_matches_reference(k):
    limbs, words = _canonical_keys(k)
    L = keys.nlimbs(k)
    assert L == jax_keys.nlimbs(k) == limbs.shape[1]
    want = np.asarray(jax_keys.bucket_hash(jnp.asarray(limbs))).astype(np.int64)
    got = keys.bucket_hash(words, L)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 0.99 * len(np.unique(limbs, axis=0))
    for world in (2, 4, 8, 3):
        np.testing.assert_array_equal((got % world).numpy(), want % world)


@pytest.mark.parametrize("k", KS)
def test_limb_view_matches_reference(k):
    """The device regrouping of words into limbs is ``convert``'s host
    mapping, limb by limb."""
    limbs, words = _canonical_keys(k)
    got = torch.stack(keys.limbs(words, keys.nlimbs(k)), dim=-1).numpy()
    np.testing.assert_array_equal(got, limbs.astype(np.int64))
    np.testing.assert_array_equal(convert.words_to_limbs(words, keys.nlimbs(k)), limbs)


@pytest.mark.parametrize("k", KS)
def test_bucket_hash_of_node_keys_keeps_the_kmer_limb_count(k):
    """(k-1)-mer endpoints keep their k-mer's limb and word counts: the
    sharded traversal hashes them with the k-mer's limb count."""
    limbs, words = _canonical_keys(k)
    want = np.asarray(jax_keys.bucket_hash(jax_keys.prefix(jnp.asarray(limbs), k))).astype(np.int64)
    np.testing.assert_array_equal(keys.bucket_hash(keys.prefix(words), keys.nlimbs(k)).numpy(), want)
    want = np.asarray(jax_keys.bucket_hash(jax_keys.suffix(jnp.asarray(limbs), k))).astype(np.int64)
    np.testing.assert_array_equal(keys.bucket_hash(keys.suffix(words, k), keys.nlimbs(k)).numpy(), want)


def test_bucket_hash_of_small_values():
    """One limb (k <= 16), and keys whose leading limbs are zero."""
    x = torch.tensor([0, 1, 2, 0xFFFFFFFF, 0x12345678])
    want = np.asarray(jax_keys.bucket_hash(jnp.asarray(x.numpy().astype(np.uint32))[:, None])).astype(np.int64)
    np.testing.assert_array_equal(keys.bucket_hash(x, 1).numpy(), want)
    two = np.stack([np.zeros(5, np.uint32), x.numpy().astype(np.uint32)], axis=1)
    want = np.asarray(jax_keys.bucket_hash(jnp.asarray(two))).astype(np.int64)
    np.testing.assert_array_equal(keys.bucket_hash(x, 2).numpy(), want)
