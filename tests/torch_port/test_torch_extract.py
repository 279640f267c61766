"""Plain extraction + the fused extract kernel's wrapper vs the reference.

The reference is both ``tpu_euler.kmer.extract.extract_canonical_kmers`` and
the Pallas kernel ``extract_canonical_pallas`` in interpret mode, on the
inputs of ``tests/unit/test_pallas_extract.py`` (an N mid-read, a short
padded read). JAX and ``tpu_euler`` are imported inside the tests that use
them (the port's simulators give the reference's inputs), so the CUDA test
can run on a machine without them:

    python -m pytest --confcutdir=tests/torch_port tests/torch_port/test_torch_extract.py -m cuda
"""

import numpy as np
import pytest
import torch

from tpu_euler_torch import convert, trace
from tpu_euler_torch.kmer import extract_kernel, keys
from tpu_euler_torch.kmer.extract import extract_canonical_kmers, extract_canonical_kmers_packed
from tpu_euler_torch.pipeline.assemble import encode_reads
from tpu_euler_torch.simulate import random_genome, simulate_reads


def _codes(k, n_pad_rows=0):
    reads = simulate_reads(random_genome(800, seed=k), read_len=100, coverage=4, seed=k)
    reads[3] = reads[3][:40] + "N" + reads[3][41:]  # an N in the middle
    reads[5] = reads[5][:55]  # short read (padded)
    codes = encode_reads(reads, 100)
    pad = np.full((n_pad_rows, 100), 4, np.int8)  # final-batch padding rows
    return np.concatenate([codes, pad])


KS = [21, 31, 33, 41, 63, 75, 95]  # one, two, three and four words per key


@pytest.mark.parametrize("k", KS)
def test_plain_matches_xla_and_pallas(k):
    import jax.numpy as jnp

    from tpu_euler.kmer.extract import extract_canonical_kmers as jax_extract
    from tpu_euler.kmer.pallas_extract import extract_canonical_pallas

    codes = _codes(k)
    words, valid = extract_canonical_kmers(torch.from_numpy(codes), k)
    xl, xv = jax_extract(jnp.asarray(codes), k)
    pl, pv = extract_canonical_pallas(jnp.asarray(codes), k, block_reads=16, interpret=True)
    xv, pv = np.asarray(xv), np.asarray(pv)
    np.testing.assert_array_equal(valid.numpy(), xv)
    np.testing.assert_array_equal(valid.numpy(), pv)
    assert not xv.all() and xv.any()
    v = torch.tensor(xv)
    assert torch.equal(words[v], convert.limbs_to_words(np.asarray(xl)[xv], "cpu", keys.nwords(k)))
    assert torch.equal(words[v], convert.limbs_to_words(np.asarray(pl)[xv], "cpu", keys.nwords(k)))


def _codes_edge(read_len, n_pad_rows=3):
    """Reads of ``read_len`` bases with an N mid-read, an N in the first and
    in the last base, a short read, and padding rows."""
    reads = simulate_reads(random_genome(900, seed=read_len), read_len=read_len, coverage=3, seed=read_len + 1)
    reads[2] = reads[2][: read_len // 2] + "N" + reads[2][read_len // 2 + 1 :]
    reads[4] = "N" + reads[4][1:]
    reads[6] = reads[6][:-1] + "N"
    reads[8] = reads[8][: read_len // 2 + 5]
    pad = np.full((n_pad_rows, read_len), 4, np.int8)
    return np.concatenate([encode_reads(reads, read_len), pad])


@pytest.mark.parametrize("read_len", [100, 107])  # 107: not a multiple of 4 or 32
@pytest.mark.parametrize("k", [3, 21, 31, 33, 41, 61, 63, 75, 95])
def test_packed_arithmetic_matches_plain_and_reference(k, read_len):
    """The kernel's arithmetic in tensor ops (keys cut from 2-bit packed
    reads by two shifts and an OR, validity from the code-4 map) against
    the port's plain extraction, the JAX function and the Pallas kernel in
    interpret mode: exact."""
    import jax.numpy as jnp

    from tpu_euler.kmer.extract import extract_canonical_kmers as jax_extract
    from tpu_euler.kmer.pallas_extract import extract_canonical_pallas

    codes = _codes_edge(read_len)
    words, valid = extract_canonical_kmers_packed(torch.from_numpy(codes), k)
    pw, pv = extract_canonical_kmers(torch.from_numpy(codes), k)
    assert torch.equal(valid, pv) and torch.equal(words, pw)  # code 4 packs as base 0 in both
    W = read_len - k + 1
    assert valid.shape == (codes.shape[0] * W,)
    assert not valid.reshape(-1, W)[-3:].any()  # padding rows
    assert valid.reshape(-1, W)[0].all() and not valid.all()
    xl, xv = jax_extract(jnp.asarray(codes), k)
    pl, plv = extract_canonical_pallas(jnp.asarray(codes), k, block_reads=16, interpret=True)
    for limbs, v in ((xl, xv), (pl, plv)):
        v = np.asarray(v)
        np.testing.assert_array_equal(valid.numpy(), v)
        assert torch.equal(words[valid], convert.limbs_to_words(np.asarray(limbs)[v], "cpu", keys.nwords(k)))


@pytest.mark.parametrize("k", KS)
def test_fill_at_offset(k):
    """The wrapper on CPU tensors: words or sentinels at [start, start+R*W),
    the rest of the buffer untouched, padding rows all sentinel, the count
    exact, and no kernel launch."""
    import jax.numpy as jnp

    from tpu_euler.kmer.extract import extract_canonical_kmers as jax_extract

    codes = _codes(k, n_pad_rows=7)
    R, W = codes.shape[0], 100 - k + 1
    start = 123
    buf = torch.full((start + R * W + 45,) + keys.word_shape(k), -7, dtype=torch.int64)
    before = trace.totals()
    n = extract_kernel.extract_fill(torch.from_numpy(codes), buf, start, k)
    assert trace.since(before)["extract_int8_launches"] == 0
    xl, xv = jax_extract(jnp.asarray(codes), k)
    xv = np.asarray(xv)
    expect = keys.select(torch.tensor(xv), convert.limbs_to_words(np.asarray(xl), "cpu", keys.nwords(k)), keys.SENT)
    assert torch.equal(buf[start : start + R * W], expect)
    assert (buf[:start] == -7).all() and (buf[start + R * W :] == -7).all()
    assert (buf[start + (R - 7) * W : start + R * W] == keys.SENT).all()
    assert n.dtype == torch.int64 and int(n) == int(xv.sum())


def test_wrapper_rejects_bad_input():
    codes = torch.from_numpy(_codes(21))
    R, W = codes.shape[0], 80
    buf = torch.empty(R * W, dtype=torch.int64)
    fill = extract_kernel.extract_fill
    with pytest.raises(ValueError):
        fill(codes, buf, 1, 21)  # past the end of buf
    with pytest.raises(ValueError):
        fill(codes, buf, 0, 22)  # even k
    buf3 = torch.empty((R * W, 3), dtype=torch.int64)
    assert int(fill(codes, buf3[: R * (100 - 63 + 1)], 0, 63)) > 0  # k = 63 works: three words
    with pytest.raises(TypeError):
        fill(codes, buf3, 0, 41)  # two words per key, not three
    with pytest.raises(TypeError):
        fill(codes, buf, 0, 41)  # two words per key need a [N, 2] buf
    with pytest.raises(TypeError):
        fill(codes.to(torch.int32), buf, 0, 21)
    with pytest.raises(TypeError):
        fill(codes, buf.to(torch.int32), 0, 21)
    with pytest.raises(ValueError):
        fill(codes[:, ::2], buf, 0, 21)  # not contiguous
    with pytest.raises(ValueError):
        fill(codes.to("meta"), buf.to("meta"), 0, 21)  # no kernel there


def _check_on_card(codes, k, start, dev):
    R, W = codes.shape[0], codes.shape[1] - k + 1
    a = torch.full((start + R * W + 3,) + keys.word_shape(k), -7, dtype=torch.int64, device=dev)
    b = a.clone()
    before = trace.totals()
    na = extract_kernel.extract_fill(codes, a, start, k)
    assert trace.since(before)["extract_int8_launches"] == 1
    nb = extract_kernel.extract_fill_plain(codes, b, start, k)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert int(na) == int(nb)


@pytest.mark.cuda
@pytest.mark.parametrize("k", KS)
def test_kernel_matches_plain_on_card(k):
    """The kernel against its plain version: reads with N, a short read and
    padding rows; random codes 0..4 in a batch that does not fill its last
    tile; reads whose length is not a multiple of 4; a view of the codes
    that is not 16-byte aligned; odd and even ``start``; and batches that
    came through the pinned feed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_euler_torch.config import AssemblyConfig
    from tpu_euler_torch.pipeline.assemble import _batch_feed

    dev = torch.device("cuda")
    rng = np.random.default_rng(k)
    ragged = rng.integers(0, 5, ((1 << 12) + 37, 100)).astype(np.int8)
    for codes_np in (_codes(k, n_pad_rows=5), ragged, _codes_edge(107), rng.integers(0, 5, (300, 107)).astype(np.int8)):
        codes = torch.from_numpy(codes_np).to(dev)
        for start in (17, 16):
            _check_on_card(codes, k, start, dev)
        _check_on_card(codes[3:], k, 0, dev)
    cfg = AssemblyConfig(k=k, read_batch=1000, read_len=100)
    feed = _batch_feed(ragged, cfg, dev, packed=False)
    try:
        for b, codes in enumerate(feed):  # 5 batches through 3 slots, the last padded
            want = np.full((1000, 100), 4, np.int8)
            part = ragged[b * 1000 : (b + 1) * 1000]
            want[: len(part)] = part
            _check_on_card(codes, k, b, dev)
            assert np.array_equal(codes.cpu().numpy(), want)
    finally:
        feed.close()
    assert b == 4


@pytest.mark.cuda
def test_pinned_feed_on_card():
    """On the card the int8 feed yields device tensors copied from pinned
    memory, every batch once and in order, while the consumer keeps the
    stream busy; closing early leaves nothing queued."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_euler_torch.config import AssemblyConfig
    from tpu_euler_torch.pipeline.assemble import _batch_feed

    dev = torch.device("cuda")
    codes = np.random.default_rng(2).integers(0, 5, (20 * 4096 + 5, 100)).astype(np.int8)
    cfg = AssemblyConfig(k=31, read_batch=4096, read_len=100)
    sums = []
    for depth in (0, 1, 2):
        feed = _batch_feed(codes, cfg, dev, depth=depth, packed=False)
        total = torch.zeros((), dtype=torch.int64, device=dev)
        weights = torch.arange(1, 4097, device=dev)[:, None]
        for b, batch in enumerate(feed):
            assert batch.device.type == "cuda" and batch.shape == (4096, 100)
            total += (batch.to(torch.int64) * weights).sum() * (b + 1)  # reads the slot on the stream
        sums.append(int(total))
    want = 0
    w = np.arange(1, 4097)[:, None]
    for b in range(21):
        part = np.full((4096, 100), 4, np.int64)
        rows = codes[b * 4096 : (b + 1) * 4096]
        part[: len(rows)] = rows
        want += int((part * w).sum()) * (b + 1)
    assert sums == [want] * 3
    feed = _batch_feed(codes, cfg, dev, packed=False)
    assert torch.equal(next(feed).cpu(), torch.from_numpy(codes[:4096]))
    feed.close()
    torch.cuda.synchronize()
