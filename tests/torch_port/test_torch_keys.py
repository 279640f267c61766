"""Port key ops (int64 words, W = ceil(k/31) words for k > 31) vs
tpu_euler.kmer.keys (uint32 limbs), exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_euler.kmer import keys as JK
from tpu_euler_torch import convert
from tpu_euler_torch.kmer import keys as K

N = 2000
# one word; two words (k = 33: a 1-base high word); three (k = 63: a 1-base
# word 0 whose (k-1)-mers leave it empty, and 64-base (k+1)-mers; k = 75) and
# four (k = 95)
KS = [21, 31, 33, 41, 63, 75, 95]


def _inputs(k, seed=0):
    rng = np.random.default_rng(seed + k)
    codes = rng.integers(0, 4, (N, k)).astype(np.int8)
    limbs = np.asarray(JK.pack(jnp.asarray(codes), k))
    return codes, limbs, _words(limbs, k), rng


def _words(limbs, k):
    """Reference limbs of k-mers, or of their (k-1)- or (k+1)-mers, as the
    port holds them: in the k-mer's word count (the (k+1)-mers of k = 31W
    gain one; the 32-base (k+1)-mers of k = 31 stay one raw word)."""
    return convert.limbs_to_words(np.asarray(limbs), "cpu", 1 if k <= 32 else K.nwords(k))


@pytest.mark.parametrize("k", KS)
def test_pack(k):
    codes, limbs, words, _ = _inputs(k)
    assert torch.equal(K.pack(torch.from_numpy(codes), k), words)
    np.testing.assert_array_equal(convert.words_to_limbs(words, limbs.shape[1]), limbs)


@pytest.mark.parametrize("k", KS)
def test_revcomp(k):
    _, limbs, words, _ = _inputs(k)
    assert torch.equal(K.revcomp(words, k), _words(JK.revcomp(jnp.asarray(limbs), k), k))


@pytest.mark.parametrize("k", KS)
def test_canonical(k):
    _, limbs, words, _ = _inputs(k)
    jc, jrc = JK.canonical(jnp.asarray(limbs), k)
    c, rc = K.canonical(words, k)
    assert torch.equal(c, _words(jc, k))
    np.testing.assert_array_equal(rc.numpy(), np.asarray(jrc))


@pytest.mark.parametrize("k", KS)
def test_prefix_suffix(k):
    _, limbs, words, _ = _inputs(k)
    assert torch.equal(K.prefix(words), _words(JK.prefix(jnp.asarray(limbs), k), k))
    assert torch.equal(K.suffix(words, k), _words(JK.suffix(jnp.asarray(limbs), k), k))
    # the (k-1)-mer endpoints' revcomp, as the graph build uses it
    pre = JK.prefix(jnp.asarray(limbs), k)
    assert torch.equal(K.revcomp(K.prefix(words), k - 1), _words(JK.revcomp(pre, k - 1), k))


@pytest.mark.parametrize("k", KS)
def test_key_less(k):
    _, limbs, words, rng = _inputs(k)
    perm = rng.permutation(N)
    ja = JK.key_less(jnp.asarray(limbs), jnp.asarray(limbs[perm]), k)
    np.testing.assert_array_equal(K.key_less(words, words[perm]).numpy(), np.asarray(ja))


@pytest.mark.parametrize("k", KS)
def test_append_base_and_last_base(k):
    _, limbs, words, rng = _inputs(k)
    base = rng.integers(0, 4, N).astype(np.int32)
    ja = np.asarray(JK.append_base(jnp.asarray(limbs), jnp.asarray(base), k))
    a = K.append_base(words, torch.from_numpy(base), k)
    assert torch.equal(a, _words(ja, k + 1))
    np.testing.assert_array_equal(
        K.last_base(words).numpy(), np.asarray(JK.last_base(jnp.asarray(limbs)))
    )


@pytest.mark.parametrize("k", KS)
def test_transition_key_encoding(k):
    """Canonical (k+1)-mers as tkeys: at k = 31 they use all 64 bits; signed
    tkey order must equal the reference's unsigned limb order. For k > 31
    they are multi-word keys, and their dense rank is what the reference's
    keys convert to."""
    _, limbs, words, rng = _inputs(k)
    base = rng.integers(0, 4, N).astype(np.int32)
    ja = JK.append_base(jnp.asarray(limbs), jnp.asarray(base), k)
    jt, _ = JK.canonical(ja, k + 1)
    jt = np.asarray(jt)
    t = K.canonical_tkey(K.append_base(words, torch.from_numpy(base), k), k + 1)
    if K.nwords(k) == 1:
        assert torch.equal(t, convert.tkeys_from_limbs(jt, "cpu"))
    else:
        assert torch.equal(t, _words(jt, k + 1))
        assert torch.equal(K.dense_rank(t), convert.tkeys_from_limbs(jt, "cpu"))
    perm = rng.permutation(N)
    np.testing.assert_array_equal(
        K.key_less(t, t[perm]).numpy(),
        np.asarray(JK.key_less(jnp.asarray(jt), jnp.asarray(jt[perm]))),
    )
    if k == 31:  # some keys really do set bit 63
        assert (convert._limbs_u64(jt) >> np.uint64(63)).any()
    assert K.is_valid(t).all()


@pytest.mark.parametrize("k", [33, 41, 61, 63, 75, 95])
def test_two_word_sort_rank_and_first_base(k):
    """W stable passes sort multi-word keys as the reference's limb tuples
    sort; dense ranks keep order and equality and leave the sentinel; the
    first base sits at the top of word 0."""
    codes, limbs, words, rng = _inputs(k)
    dup = rng.integers(0, N, N // 4)
    limbs, codes = np.concatenate([limbs, limbs[dup]]), np.concatenate([codes, codes[dup]])
    words = _words(limbs, k)
    words[::7] = K.SENT
    s, perm = K.sort(words)
    assert torch.equal(s, words[perm])
    live = ~np.isin(np.arange(words.shape[0]), np.arange(0, words.shape[0], 7))
    order = np.lexsort(limbs[live].T[::-1])
    np.testing.assert_array_equal(convert.words_to_limbs(s[: live.sum()], limbs.shape[1]), limbs[live][order])
    assert not K.is_valid(s[live.sum() :]).any()
    r = K.dense_rank(words)
    assert (r[~torch.from_numpy(live)] == K.SENT).all()
    _, inv = np.unique(limbs[live], axis=0, return_inverse=True)
    np.testing.assert_array_equal(r[torch.from_numpy(live)].numpy(), inv.reshape(-1))
    np.testing.assert_array_equal(K.first_base(words[live], k).numpy(), codes[live, 0])


def test_mix32():
    x = np.concatenate(
        [np.arange(1 << 16, dtype=np.uint32), np.array([0xFFFFFFFF, 0x80000000], np.uint32)]
    )
    ref = np.asarray(JK._mix32(jnp.asarray(x))).astype(np.int64)
    np.testing.assert_array_equal(K._mix32(torch.from_numpy(x.astype(np.int64))).numpy(), ref)


@pytest.mark.parametrize("k", [0, 1, 2, 64])
def test_check_k_rejects(k):
    with pytest.raises(ValueError):
        K.check_k(k)


@pytest.mark.parametrize("k", [3, 63, 65, 201])
def test_check_k_accepts_any_odd_k(k):
    K.check_k(k)
    assert K.word_shape(k) == (() if k <= 31 else (-(-k // 31),))
