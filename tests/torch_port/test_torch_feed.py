"""The prefetching batch feed (``pipeline/assemble.py`` ``_batch_feed``) on
the CPU, for both transports (int8 codes; 2.25-bit packed codes with an N
map that a full clean batch omits): every batch once, in order, the last
padded with code 4; ``close()`` ends it; its batches equal the reference
feed's (the packed ones as they are, the int8 ones after the reference's
own unpack); and the counts that ship each transport (the single-device
``count_spectrum``, packed; the sharded ``count_sharded``, int8) give the
reference's spectrum on all three counting routes. Exact equality
throughout (integers)."""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from tpu_euler.config import AssemblyConfig
from tpu_euler.kmer.extract import unpack_codes, unpack_codes_clean
from tpu_euler.pipeline.assemble import _batch_feed as jax_feed
from tpu_euler.pipeline.assemble import _pack_batch as jax_pack_batch
from tpu_euler.pipeline.assemble import count_spectrum as jax_count
from tpu_euler_torch import convert, trace
from tpu_euler_torch.dist import pipeline as dist_pipe
from tpu_euler_torch.dist.count_dist import gather_spectrum
from tpu_euler_torch.dist.mesh import LoopbackComm
from tpu_euler_torch.kmer import keys
from tpu_euler_torch.kmer.extract import unpack_codes as port_unpack
from tpu_euler_torch.pipeline import assemble as pipe

READ_BATCH, READ_LEN = 64, 50
TRANSPORTS = pytest.mark.parametrize("packed", [False, True], ids=["int8", "packed"])


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


def _as_codes(batch, packed):
    """A feed's batch as int8 codes on the host."""
    if not packed:
        assert batch.dtype == torch.int8 and batch.device.type == "cpu" and batch.is_contiguous()
        return batch.numpy()
    p, m = batch
    assert m is not None  # every batch here holds an N or padding
    for x, width in ((p, -(-READ_LEN // 4)), (m, -(-READ_LEN // 8))):
        assert x.dtype == torch.uint8 and x.shape == (READ_BATCH, width) and x.is_contiguous()
    return port_unpack(p, m, READ_LEN).numpy()


@TRANSPORTS
@pytest.mark.parametrize("depth", [0, 2, 8])  # 8: deeper than any batch count here
@pytest.mark.parametrize("n_batches", [1, 2, 5])
def test_feed_yields_every_batch_once_in_order(n_batches, depth, packed):
    codes = _codes(n_batches)
    got = [_as_codes(b, packed) for b in pipe._batch_feed(codes, _cfg(), "cpu", depth=depth, packed=packed)]
    assert len(got) == n_batches == pipe._n_batches(codes, _cfg())
    for b, batch in enumerate(got):
        np.testing.assert_array_equal(batch, _padded(codes, b))
    assert (got[-1][23:] == 4).all() and not (got[-1][:23] == 4).all()


@TRANSPORTS
@pytest.mark.parametrize("n_batches", [1, 2, 5])
def test_feed_matches_reference_feed(n_batches, packed):
    """The reference's feed ships packed codes, without the map for a clean
    full batch: the packed feed's batches are those bytes, and the int8
    feed's batches are their unpack."""
    codes = _codes(n_batches, seed=1)
    # a first batch without N: at this read length (not a multiple of 8) its
    # map still holds the pad bits past the read, so both feeds ship it
    codes[:READ_BATCH][codes[:READ_BATCH] == 4] = 0
    cfg = _cfg()
    ref = jax_feed(codes, cfg)
    got = pipe._batch_feed(codes, cfg, "cpu", packed=packed)
    n = 0
    for (ref_packed, ref_nmask), batch in zip(ref, got, strict=True):
        if packed:
            p, m = batch
            np.testing.assert_array_equal(p.numpy(), np.asarray(ref_packed))
            assert (m is None) == (ref_nmask is None)
            if m is not None:
                np.testing.assert_array_equal(m.numpy(), np.asarray(ref_nmask))
        elif ref_nmask is None:
            np.testing.assert_array_equal(batch.numpy(), np.asarray(unpack_codes_clean(ref_packed, READ_LEN)))
        else:
            np.testing.assert_array_equal(batch.numpy(), np.asarray(unpack_codes(ref_packed, ref_nmask, READ_LEN)))
        n += 1
    assert n == n_batches
    if n_batches > 1:
        assert ref_nmask is not None  # the padded last batch ships its map


@TRANSPORTS
def test_close_after_one_batch_returns(monkeypatch, packed):
    """``close()`` on a feed that was not exhausted ends the worker: it
    returns, no thread is left, and batches beyond the prefetch depth were
    never staged."""
    staged = []
    rows = pipe._batch_rows
    monkeypatch.setattr(pipe, "_batch_rows", lambda c, b, cfg: staged.append(b) or rows(c, b, cfg))
    codes = _codes(40)
    before = threading.active_count()
    feed = pipe._batch_feed(codes, _cfg(), "cpu", depth=2, packed=packed)
    np.testing.assert_array_equal(_as_codes(next(feed), packed), _padded(codes, 0))
    t0 = time.perf_counter()
    feed.close()
    assert time.perf_counter() - t0 < 5.0
    assert threading.active_count() == before
    assert staged == sorted(staged) and set(staged) <= {0, 1, 2} and 0 in staged
    with pytest.raises(StopIteration):
        next(feed)


@TRANSPORTS
def test_feed_raises_the_worker_s_error_and_ends(packed):
    """A batch the worker cannot stage (reads of another length) raises in
    the caller, and the feed is over."""
    codes = _codes(3)
    feed = pipe._batch_feed(codes, dataclasses.replace(_cfg(), read_len=READ_LEN + 1), "cpu", packed=packed)
    with pytest.raises(ValueError if packed else RuntimeError):
        next(feed)
    with pytest.raises(StopIteration):
        next(feed)


@TRANSPORTS
def test_feed_rejects_a_device_it_cannot_feed(packed):
    with pytest.raises(ValueError):
        next(pipe._batch_feed(_codes(1), _cfg(), "meta", packed=packed))


@TRANSPORTS
@pytest.mark.parametrize("route", ["oneshot", "grouped", "per_batch"])
def test_count_spectrum_through_the_feed(route, monkeypatch, packed):
    """Each counting route takes every batch from one feed, closes it, and
    gives the reference's spectrum, through the count that ships each
    transport: the packed one, the single-device ``count_spectrum``; int8,
    the sharded mode's ``count_sharded`` on two loopback ranks, its shards
    gathered. Its routes are one group, groups of two steps, and a merge a
    step."""
    W = READ_LEN - 21 + 1
    world = 2
    # rows a group takes a batch: one batch's windows, or what a rank
    # receives a step (``count_sharded``'s c_dest from every rank)
    slab = READ_BATCH * W if packed else world * int(2.0 * READ_BATCH * W / world + 256)
    rows = {"oneshot": 1 << 30, "grouped": 2 * slab, "per_batch": 0}[route]
    cfg = _cfg(spectrum_capacity=1 << 13, oneshot_rows=rows)
    codes = np.random.default_rng(5).integers(0, 4, (5 * READ_BATCH - 9, READ_LEN)).astype(np.int8)
    codes[:, :30] = codes[0, :30]  # shared prefixes: counts above 1
    codes[3, 25] = 4
    feeds, batches = [], []
    feed_fn = pipe._batch_feed

    def counted(*a, **kw):
        assert kw.pop("packed", True) == packed  # the count's own transport
        feeds.append(feed_fn(*a, packed=packed, **kw))
        return _noted(batches, feeds[-1])

    if packed:
        monkeypatch.setattr(pipe, "_batch_feed", counted)
        got, n = pipe.count_spectrum(codes, cfg, "cpu")
        n_batches = 5
    else:
        monkeypatch.setattr(dist_pipe, "_batch_feed", counted)
        comm = LoopbackComm(world, "cpu")
        with trace.assembly() as tr:
            acc, n, n_reads = dist_pipe.count_sharded(codes, cfg, comm)
        got = gather_spectrum(acc, comm, cfg.spectrum_capacity)
        assert n_reads == len(codes)
        assert tr.rollup()["calls"].get("count: drain", 0) == {"oneshot": 1, "grouped": 2, "per_batch": 0}[route]
        n_batches = 6  # three steps of two ranks, the last rank's batch all padding
    assert len(feeds) == 1
    with pytest.raises(StopIteration):  # exhausted and closed
        next(feeds[0])
    # the bytes each batch shipped: the reference's packed batch, or int8
    for b, nbytes in enumerate(batches):
        p, m = jax_pack_batch(codes[b * READ_BATCH : (b + 1) * READ_BATCH], cfg)
        assert nbytes == (p.nbytes + (0 if m is None else m.nbytes) if packed else READ_BATCH * READ_LEN)
    assert len(batches) == n_batches
    ref, ref_n = jax_count(codes, cfg)
    assert n == ref_n and got.n == int(ref.n)
    assert torch.equal(got.words, convert.limbs_to_words(np.asarray(ref.limbs), "cpu", keys.nwords(21)))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(ref.counts))
    assert (got.counts[: got.n] > 1).any()


def _noted(seen, feed):
    """``feed``'s batches, the bytes of each (what it ships to a device)
    appended to ``seen``; closing it closes ``feed``."""
    try:
        for batch in feed:
            seen.append(sum(x.nbytes for x in batch if x is not None) if isinstance(batch, tuple) else batch.nbytes)
            yield batch
    finally:
        feed.close()
