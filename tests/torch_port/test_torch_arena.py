"""The grouped count's arena: ``arena_drain`` and ``arena_finalize`` vs the
reference's ``make_arena_drain``/``make_arena_finalize`` on the same arena
state (``convert.arena_from_reference``), exact, over two drain rounds, as
tests/unit/test_capacity_guards.py:55 drives the reference; and the port's
row guard, probed at its real boundary."""

import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_euler.kmer import keys as jax_keys
from tpu_euler.pipeline.assemble import make_arena_drain, make_arena_finalize
from tpu_euler_torch import convert
from tpu_euler_torch.config import AssemblyConfig
from tpu_euler_torch.kmer import keys
from tpu_euler_torch.pipeline import assemble as pipe

SENT32 = np.uint32(0xFFFFFFFF)


def _raw_rows(rng, pool, T, n_valid):
    """T arena fill rows: n_valid keys drawn from ``pool`` (so they repeat),
    then empty rows."""
    rows = pool[rng.integers(0, pool.shape[0], T)]
    rows[n_valid:] = SENT32
    return rows


@pytest.mark.parametrize("k", [21, 41, 63])
@pytest.mark.parametrize("C", [256, 40], ids=["fits", "overflows"])
def test_arena_drain_matches_reference(k, C):
    rng = np.random.default_rng(k)
    T = 96
    nw = keys.nwords(k)
    L = jax_keys.nlimbs(k)
    codes = rng.integers(0, 4, (50, k)).astype(np.int8)
    pool = np.asarray(jax_keys.pack(jnp.asarray(codes), k))
    drain = make_arena_drain(k, C, T)

    head = np.full((C, L), SENT32, np.uint32)
    raw1 = _raw_rows(rng, pool, T, 80)
    arena = np.concatenate([head, raw1])
    bufs = tuple(jnp.asarray(arena[:, j]) for j in range(L))
    ref_counts = jnp.zeros((C + T,), jnp.uint32)
    words, counts = convert.arena_from_reference(bufs, ref_counts, "cpu", nw)
    expected = Counter(map(tuple, raw1[:80].tolist()))
    for rnd in range(2):
        bufs, ref_counts, ref_n, ref_over = drain(bufs, ref_counts)
        n, over = pipe.arena_drain(words, counts, C)
        assert n == int(ref_n) == len(expected)
        assert over == bool(ref_over) == (len(expected) > C)
        want_w, want_c = convert.arena_from_reference(bufs, ref_counts, "cpu", nw)
        assert torch.equal(words, want_w), f"round {rnd}"
        assert torch.equal(counts, want_c), f"round {rnd}"
        if not over:
            got = dict(zip(map(tuple, convert.words_to_limbs(words[:n], L).tolist()), counts[:n].tolist()))
            assert got == dict(expected)
        if rnd:
            break
        # round 2: new raw keys on top of the drained head
        raw2 = _raw_rows(rng, pool, T, 70)
        expected.update(map(tuple, raw2[:70].tolist()))
        bufs = tuple(jax.lax.dynamic_update_slice(b, jnp.asarray(raw2[:, j]), (C,)) for j, b in enumerate(bufs))
        fill_w, _ = convert.arena_from_reference([np.asarray(raw2[:, j]) for j in range(L)], np.zeros(T), "cpu", nw)
        words[C:] = fill_w

    fin_ref = make_arena_finalize(C)(bufs, ref_counts)
    fin = pipe.arena_finalize(words, counts, C)
    assert fin.n == int(fin_ref.n)
    assert torch.equal(fin.words, convert.limbs_to_words(np.asarray(fin_ref.limbs), "cpu", nw))
    np.testing.assert_array_equal(fin.counts.numpy(), np.asarray(fin_ref.counts))


def test_arena_rows_guard_at_its_real_boundary():
    """The drain sorts all M = C + T arena rows in one torch.sort, which
    takes at most INT_MAX elements on CUDA; the guard sits exactly there.
    (The reference asserts the same bound, M < 2^31, for its uint32
    composite key, and its own test probes 2^30 + 2^19 rows.)"""
    limit = keys.SORT_ROWS_LIMIT
    assert limit == (1 << 31) - 1
    assert pipe.arena_rows(limit - 80, 80) == limit
    with pytest.raises(ValueError, match="torch.sort"):
        pipe.arena_rows(limit - 79, 80)
    # the grouped route checks before it allocates the arena
    cfg = AssemblyConfig(k=21, read_batch=1, read_len=100, oneshot_rows=80, spectrum_capacity=limit - 79)
    codes = np.zeros((3, 100), np.int8)
    with pytest.raises(ValueError, match="counting arena"):
        pipe.count_spectrum(codes, cfg, "cpu")
    with pytest.raises(ValueError, match="per-batch merge"):
        pipe.count_spectrum(codes, dataclasses.replace(cfg, oneshot_rows=0), "cpu")
