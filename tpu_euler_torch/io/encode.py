"""Base encoding on the host: read strings -> padded int8 code batches, and
the 2.25-bit pack of a code batch for the host-to-device copy.

The port's own copy of ``tpu_euler/io/encode.py``. One int8 code a base
(A, C, G, T = 0..3, anything else and padding = 4). The single-device feed
packs each batch to 2 bits a base plus a 1-bit N map (``pack_codes``), and
the extract kernel's packed loader reads those bytes on the device.
"""

from __future__ import annotations

import numpy as np

BASE_N = 4

_LUT = np.full(256, BASE_N, dtype=np.int8)  # A/C/G/T (either case) -> 0..3
for _i, _b in enumerate(b"ACGT"):
    _LUT[_b] = _LUT[_b | 0x20] = _i

_BASES = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode_reads(reads, read_len: int) -> np.ndarray:
    """[R, read_len] int8 codes of read str/bytes: longer reads are cut,
    shorter ones padded with N (4). An unknown character encodes to 4 and
    invalidates the windows that cover it."""
    out = np.full((len(reads), read_len), BASE_N, dtype=np.int8)
    for i, r in enumerate(reads):
        r = (r.encode() if isinstance(r, str) else r)[:read_len]
        out[i, : len(r)] = _LUT[np.frombuffer(r, dtype=np.uint8)]
    return out


def encode_reads_with_qual(
    reads, quals, read_len: int, min_qual: int, qual_offset: int = 33
) -> np.ndarray:
    """``encode_reads`` with every base of phred quality below ``min_qual``
    masked as N: a bad base costs the windows that cover it, no more."""
    out = encode_reads(reads, read_len)
    thresh = np.uint8(min_qual + qual_offset)
    for i, q in enumerate(quals):
        qa = np.frombuffer(q.encode(), dtype=np.uint8)[:read_len]
        low = qa < thresh
        if low.any():
            out[i, : len(qa)][low] = BASE_N
    return out


def pack_codes_np(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pack an [R, L] int8 code matrix at 2.25 bits a base [reference
    pack_codes_np, :65]: (packed [R, ceil(L/4)] uint8, four bases a byte,
    base 4j + b at bits 2b and 2b + 1 of byte j; nmask [R, ceil(L/8)]
    uint8, bit b of byte j set where base 8j + b is not 0..3, the positions
    past L included). An N packs as 0, its code 4 & 3. The device's inverse
    is ``kmer.extract.unpack_codes``."""
    R, L = codes.shape
    L4, L8 = -(-L // 4), -(-L // 8)
    c = np.zeros((R, 4 * L4), np.uint8)
    c[:, :L] = codes.astype(np.uint8) & 3
    c = c.reshape(R, L4, 4)
    packed = c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4) | (c[:, :, 3] << 6)
    isn = np.ones((R, 8 * L8), np.uint8)
    isn[:, :L] = (codes >= 4) | (codes < 0)
    nmask = np.zeros((R, L8), np.uint8)
    for b, bit in enumerate(np.moveaxis(isn.reshape(R, L8, 8), 2, 0)):
        nmask |= bit << b
    return packed, nmask


def pack_codes(codes: np.ndarray, out=None) -> tuple[np.ndarray, np.ndarray]:
    """``pack_codes_np``'s result by the native threaded codec, or by numpy
    where the codec did not build, as the reference's ``pack_codes`` (:91)
    chooses. ``out``: (packed, nmask) arrays of the result's shapes to write
    into, e.g. pinned staging memory; they are returned."""
    from tpu_euler_torch.io.native import pack_codes_native

    got = pack_codes_native(codes, out=out)
    if got is not None:
        return got
    packed, nmask = pack_codes_np(np.asarray(codes))
    if out is None:
        return packed, nmask
    out[0][...], out[1][...] = packed, nmask
    return out


def decode_read(codes: np.ndarray) -> str:
    """One int8 code row back to a string, the padding stripped."""
    return bytes(_BASES[np.clip(np.asarray(codes), 0, 4)]).decode().rstrip("N")
