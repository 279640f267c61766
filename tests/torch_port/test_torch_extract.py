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

from tpu_euler_torch import convert
from tpu_euler_torch.kmer import extract_kernel, keys
from tpu_euler_torch.kmer.extract import extract_canonical_kmers
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
    before = extract_kernel.launches
    n = extract_kernel.extract_fill(torch.from_numpy(codes), buf, start, k)
    assert extract_kernel.launches == before
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


@pytest.mark.cuda
@pytest.mark.parametrize("k", KS)
def test_kernel_matches_plain_on_card(k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    for codes_np in (_codes(k, n_pad_rows=5), np.random.default_rng(k).integers(0, 5, (1 << 12, 100)).astype(np.int8)):
        codes = torch.from_numpy(codes_np).to(dev)
        R, W = codes.shape[0], 100 - k + 1
        start = 17
        a = torch.full((start + R * W + 3,) + keys.word_shape(k), -7, dtype=torch.int64, device=dev)
        b = a.clone()
        before = extract_kernel.launches
        na = extract_kernel.extract_fill(codes, a, start, k)
        assert extract_kernel.launches == before + 1
        nb = extract_kernel.extract_fill_plain(codes, b, start, k)
        torch.cuda.synchronize()
        assert torch.equal(a, b)
        assert int(na) == int(nb)
