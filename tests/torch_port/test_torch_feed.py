"""The prefetching batch feed (``pipeline/assemble.py`` ``_batch_feed``) on
the CPU: every batch once, in order, the last padded with code 4; ``close()``
ends it; its batches equal the reference feed's after the reference's own
unpack; and ``count_spectrum`` through it gives the reference's spectrum on
all three counting routes. Exact equality throughout (integers)."""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from tpu_euler.config import AssemblyConfig
from tpu_euler.kmer.extract import unpack_codes, unpack_codes_clean
from tpu_euler.pipeline.assemble import _batch_feed as jax_feed
from tpu_euler.pipeline.assemble import count_spectrum as jax_count
from tpu_euler_torch import convert
from tpu_euler_torch.kmer import keys
from tpu_euler_torch.pipeline import assemble as pipe

READ_BATCH, READ_LEN = 64, 50


def _codes(n_batches, seed=0):
    """Codes 0..4 filling ``n_batches`` batches, the last one partly."""
    rows = (n_batches - 1) * READ_BATCH + 23
    return np.random.default_rng(seed).integers(0, 5, (rows, READ_LEN)).astype(np.int8)


def _cfg(**kw):
    return AssemblyConfig(k=21, read_batch=READ_BATCH, read_len=READ_LEN, **kw)


def _padded(codes, b):
    want = np.full((READ_BATCH, READ_LEN), 4, np.int8)
    part = codes[b * READ_BATCH : (b + 1) * READ_BATCH]
    want[: len(part)] = part
    return want


@pytest.mark.parametrize("depth", [0, 2, 8])  # 8: deeper than any batch count here
@pytest.mark.parametrize("n_batches", [1, 2, 5])
def test_feed_yields_every_batch_once_in_order(n_batches, depth):
    codes = _codes(n_batches)
    got = list(pipe._batch_feed(codes, _cfg(), "cpu", depth=depth))
    assert len(got) == n_batches == pipe._n_batches(codes, _cfg())
    for b, batch in enumerate(got):
        assert batch.dtype == torch.int8 and batch.device.type == "cpu" and batch.is_contiguous()
        np.testing.assert_array_equal(batch.numpy(), _padded(codes, b))
    assert (got[-1][23:] == 4).all() and not (got[-1][:23] == 4).all()


@pytest.mark.parametrize("n_batches", [1, 2, 5])
def test_feed_matches_reference_feed(n_batches):
    """The reference's feed ships packed codes; after its own unpack they are
    the port's int8 batches."""
    codes = _codes(n_batches, seed=1)
    codes[:READ_BATCH][codes[:READ_BATCH] == 4] = 0  # a clean first batch: the reference skips its bitmap
    cfg = _cfg()
    ref = jax_feed(codes, cfg)
    got = pipe._batch_feed(codes, cfg, "cpu")
    n = 0
    for (packed, nmask), batch in zip(ref, got, strict=True):
        if nmask is None:
            want = unpack_codes_clean(packed, READ_LEN)
        else:
            want = unpack_codes(packed, nmask, READ_LEN)
        np.testing.assert_array_equal(batch.numpy(), np.asarray(want))
        n += 1
    assert n == n_batches


def test_close_after_one_batch_returns(monkeypatch):
    """``close()`` on a feed that was not exhausted ends the worker: it
    returns, no thread is left, and batches beyond the prefetch depth were
    never staged."""
    staged = []
    stage = pipe._stage
    monkeypatch.setattr(pipe, "_stage", lambda c, b, cfg, out: staged.append(b) or stage(c, b, cfg, out))
    codes = _codes(40)
    before = threading.active_count()
    feed = pipe._batch_feed(codes, _cfg(), "cpu", depth=2)
    np.testing.assert_array_equal(next(feed).numpy(), _padded(codes, 0))
    t0 = time.perf_counter()
    feed.close()
    assert time.perf_counter() - t0 < 5.0
    assert threading.active_count() == before
    assert staged == sorted(staged) and set(staged) <= {0, 1, 2}
    with pytest.raises(StopIteration):
        next(feed)


def test_feed_raises_the_worker_s_error_and_ends():
    """A batch the worker cannot stage (reads of another length) raises in
    the caller, and the feed is over."""
    codes = _codes(3)
    feed = pipe._batch_feed(codes, dataclasses.replace(_cfg(), read_len=READ_LEN + 1), "cpu")
    with pytest.raises(RuntimeError):
        next(feed)
    with pytest.raises(StopIteration):
        next(feed)


def test_feed_rejects_a_device_it_cannot_feed():
    with pytest.raises(ValueError):
        next(pipe._batch_feed(_codes(1), _cfg(), "meta"))


@pytest.mark.parametrize("route", ["oneshot", "grouped", "per_batch"])
def test_count_spectrum_through_the_feed(route, monkeypatch):
    """Each counting route takes every batch from one feed, closes it, and
    gives the reference's spectrum."""
    W = READ_LEN - 21 + 1
    rows = {"oneshot": 1 << 30, "grouped": 2 * READ_BATCH * W, "per_batch": 0}[route]
    cfg = _cfg(spectrum_capacity=1 << 13, oneshot_rows=rows)
    codes = np.random.default_rng(5).integers(0, 4, (5 * READ_BATCH - 9, READ_LEN)).astype(np.int8)
    codes[:, :30] = codes[0, :30]  # shared prefixes: counts above 1
    codes[3, 25] = 4
    feeds = []
    feed_fn = pipe._batch_feed

    def counted(*a, **kw):
        feeds.append(feed_fn(*a, **kw))
        return feeds[-1]

    monkeypatch.setattr(pipe, "_batch_feed", counted)
    got, n = pipe.count_spectrum(codes, cfg, "cpu")
    assert len(feeds) == 1
    with pytest.raises(StopIteration):  # exhausted and closed
        next(feeds[0])
    ref, ref_n = jax_count(codes, cfg)
    assert n == ref_n and got.n == int(ref.n)
    assert torch.equal(got.words, convert.limbs_to_words(np.asarray(ref.limbs), "cpu", keys.nwords(21)))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(ref.counts))
    assert (got.counts[: got.n] > 1).any()
