"""The packed host-to-device transport on the CPU against the reference:
``pack_codes_np``, the native codec's ``pack_codes_native`` and
``pack_codes``, ``unpack_codes`` and ``unpack_codes_clean``, ``_pack_batch``
(the map of a clean full batch omitted, that of a padded batch shipped), the
packed feed, and the packed kernel's plain version
(``extract_fill_packed_plain``) against the reference's
``make_extract_fill_step`` on the same packed bytes, with and without a
map. Exact equality throughout (integers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_euler.config import AssemblyConfig
from tpu_euler.io.encode import pack_codes_np as ref_pack
from tpu_euler.kmer import extract as ref_extract
from tpu_euler.pipeline.assemble import _batch_feed as ref_feed
from tpu_euler.pipeline.assemble import _pack_batch as ref_pack_batch
from tpu_euler.pipeline.assemble import count_spectrum as ref_count
from tpu_euler.pipeline.assemble import make_extract_fill_step
from tpu_euler_torch import convert, trace
from tpu_euler_torch.io import encode, native
from tpu_euler_torch.kmer import extract, extract_kernel, keys
from tpu_euler_torch.pipeline import assemble as pipe

LENGTHS = [50, 70, 100, 101, 140]


def _codes(R, L, seed, n=True):
    """Codes 0..3, with code 4 sprinkled in (and a short read, and two pad
    rows) where ``n``."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (R, L)).astype(np.int8)
    if n:
        codes[rng.random((R, L)) < 0.02] = 4
        codes[1, L // 2 :] = 4
        codes[-2:] = 4
    return codes


def _same(got, want):
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("L", LENGTHS)
def test_pack_codes_np_matches_reference(L):
    codes = _codes(37, L, L)
    codes[3, :5] = [-1, 5, 127, -128, 4]  # anything but 0..3 is N, and packs its code & 3
    for got, want in zip(encode.pack_codes_np(codes), ref_pack(codes), strict=True):
        _same(got, want)


@pytest.mark.parametrize("L", LENGTHS)
def test_pack_codes_native_matches_reference(L):
    assert native.native_available()
    codes = _codes(5000, L, L + 1)  # over 4096 rows: the codec's threads split them
    want = ref_pack(codes)
    for got, w in zip(native.pack_codes_native(codes), want, strict=True):
        _same(got, w)
    out = (np.full(want[0].shape, 0xAB, np.uint8), np.full(want[1].shape, 0xAB, np.uint8))
    got = encode.pack_codes(codes, out=out)
    assert got[0] is out[0] and got[1] is out[1]
    for g, w in zip(got, want, strict=True):
        _same(g, w)


def test_pack_codes_native_rejects_a_wrong_destination():
    codes = _codes(8, 100, 0)
    with pytest.raises(ValueError):
        native.pack_codes_native(codes, out=(np.empty((8, 25), np.uint8), np.empty((8, 12), np.uint8)))
    with pytest.raises(ValueError):
        native.pack_codes_native(codes, out=(np.empty((8, 50), np.uint8)[:, ::2], np.empty((8, 13), np.uint8)))


@pytest.mark.parametrize("L", LENGTHS)
def test_unpack_codes_match_reference(L):
    codes = _codes(37, L, L + 2)
    packed, nmask = ref_pack(codes)
    got = extract.unpack_codes(torch.from_numpy(packed), torch.from_numpy(nmask), L)
    want = np.asarray(ref_extract.unpack_codes(jnp.asarray(packed), jnp.asarray(nmask), L))
    assert got.dtype == torch.int8 and want.dtype == np.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), codes)
    got = extract.unpack_codes_clean(torch.from_numpy(packed), L)
    want = np.asarray(ref_extract.unpack_codes_clean(jnp.asarray(packed), L))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "L, rows, n",
    [
        (96, 64, False),  # full, no N, L a multiple of 8: no map
        (96, 64, True),  # full with N: a map
        (96, 40, False),  # padded: a map
        (100, 64, False),  # full, no N, but the map's pad bits past L = 100 are set: a map
        (101, 23, True),
    ],
)
def test_pack_batch_matches_reference(L, rows, n):
    cfg = AssemblyConfig(k=21, read_batch=64, read_len=L)
    batch = _codes(rows, L, rows + L, n=n)
    want_p, want_m = ref_pack_batch(batch, cfg)
    got_p, got_m = pipe._pack_batch(batch, cfg)
    _same(got_p, np.asarray(want_p))
    assert (got_m is None) == (want_m is None) == (L == 96 and rows == 64 and not n)
    if want_m is not None:
        _same(got_m, np.asarray(want_m))
    out = (np.full(got_p.shape, 0xAB, np.uint8), np.full((64, -(-L // 8)), 0xAB, np.uint8))
    p, m = pipe._pack_batch(batch, cfg, out=out)
    assert p is out[0] and (m is None or m is out[1])
    _same(p, got_p)


def test_packed_feed_skips_the_map_of_clean_full_batches():
    """At a read length that is a multiple of 8, full batches without an N
    ship no map, in both feeds; the padded last batch ships one."""
    cfg = AssemblyConfig(k=21, read_batch=64, read_len=64)
    codes = _codes(4 * 64 + 5, 64, 3, n=False)
    codes[70, 9] = 4  # batch 1 holds an N
    maps = []
    for (rp, rm), (p, m) in zip(ref_feed(codes, cfg), pipe._batch_feed(codes, cfg, "cpu"), strict=True):
        _same(p.numpy(), np.asarray(rp))
        assert (m is None) == (rm is None)
        if m is not None:
            _same(m.numpy(), np.asarray(rm))
        maps.append(m is not None)
    assert maps == [False, True, False, False, True]


@pytest.mark.parametrize("route", ["oneshot", "grouped", "per_batch"])
def test_count_routes_through_clean_packed_batches(route):
    """Every counting route through the packed feed, on batches with and
    without a map, gives the reference's spectrum."""
    W = 64 - 21 + 1
    rows = {"oneshot": 1 << 30, "grouped": 2 * 64 * W, "per_batch": 0}[route]
    cfg = AssemblyConfig(k=21, read_batch=64, read_len=64, spectrum_capacity=1 << 15, oneshot_rows=rows)
    codes = _codes(5 * 64 - 9, 64, 11, n=False)
    codes[:, :30] = codes[0, :30]
    codes[70, 40] = 4
    got, n = pipe.count_spectrum(codes, cfg, "cpu")
    ref, ref_n = ref_count(codes, cfg)
    assert n == ref_n and got.n == int(ref.n)
    assert torch.equal(got.words, convert.limbs_to_words(np.asarray(ref.limbs), "cpu", keys.nwords(21)))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(ref.counts))


@pytest.mark.parametrize("with_map", [False, True], ids=["clean", "map"])
@pytest.mark.parametrize("k", [21, 31, 33, 41, 63, 75, 95])
def test_packed_fill_matches_reference_fill_step(k, with_map):
    """``extract_fill_packed`` on CPU tensors (its plain version, no launch)
    against the reference's fill step on the same packed bytes: words at
    [start, start + R W), the reference's all-ones sentinel as ``keys.SENT``,
    the rest of the buffer untouched, the count exact."""
    L, R, start = 100, 67, 13
    W = L - k + 1
    codes = _codes(R, L, k, n=with_map)
    packed, nmask = ref_pack(codes)
    T = start + R * W + 9
    nlimbs = AssemblyConfig(k=k).nlimbs
    ref_buf = tuple(jnp.full((T,), jnp.uint32(0xFFFFFFFF)) for _ in range(nlimbs))
    ref_buf, ref_n = make_extract_fill_step(k, L)(
        jnp.asarray(packed), jnp.asarray(nmask) if with_map else None, ref_buf, jnp.asarray(start, jnp.int32)
    )
    limbs = np.stack([np.asarray(b) for b in ref_buf], axis=-1)[start : start + R * W]
    valid = torch.from_numpy(limbs[:, 0] != 0xFFFFFFFF)
    want = keys.select(valid, convert.limbs_to_words(limbs, "cpu", keys.nwords(k)), keys.SENT)

    buf = torch.full((T,) + keys.word_shape(k), -7, dtype=torch.int64)
    before = trace.totals()
    n = extract_kernel.extract_fill_packed(
        torch.from_numpy(packed), torch.from_numpy(nmask) if with_map else None, buf, start, k, L
    )
    grew = trace.since(before)
    assert (grew["extract_int8_launches"], grew["extract_launches"]) == (0, 0)
    assert torch.equal(buf[start : start + R * W], want)
    assert (buf[:start] == -7).all() and (buf[start + R * W :] == -7).all()
    assert n.dtype == torch.int64 and int(n) == int(ref_n) == int(valid.sum())
    assert with_map == bool((~valid).any())
    plain = torch.full_like(buf, -7)
    extract_kernel.extract_fill_packed_plain(
        torch.from_numpy(packed), torch.from_numpy(nmask) if with_map else None, plain, start, k, L
    )
    assert torch.equal(plain, buf)


def test_packed_wrapper_rejects_bad_input():
    codes = _codes(10, 100, 0)
    p, m = (torch.from_numpy(x) for x in ref_pack(codes))
    buf = torch.empty(10 * 80, dtype=torch.int64)
    fill = extract_kernel.extract_fill_packed
    assert int(fill(p, m, buf, 0, 21, 100)) > 0
    with pytest.raises(ValueError):
        fill(p, m, buf, 1, 21, 100)  # past the end of buf
    with pytest.raises(TypeError):
        fill(p, m, buf, 0, 21, 101)  # packed rows of 26 bytes at 101 bases
    with pytest.raises(TypeError):
        fill(p, m[:9], buf, 0, 21, 100)  # a map of other rows
    with pytest.raises(TypeError):
        fill(p.to(torch.int8), m, buf, 0, 21, 100)
    with pytest.raises(TypeError):
        fill(p, m, buf, 0, 41, 100)  # two words a key need a [N, 2] buf
    with pytest.raises(ValueError):
        fill(torch.cat([p, p], 1)[:, ::2], m, buf, 0, 21, 100)  # not contiguous
    with pytest.raises(ValueError):
        fill(p.to("meta"), None, buf.to("meta"), 0, 21, 100)  # no kernel there
    with pytest.raises(ValueError):
        fill(p, None, buf.to("meta"), 0, 21, 100)  # devices differ
