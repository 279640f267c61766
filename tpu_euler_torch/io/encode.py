"""Base encoding on the host: read strings -> padded int8 code batches.

The port's own copy of ``tpu_euler/io/encode.py`` without the 2.25-bit
packing, which belongs to the packed transport. One int8 code a base
(A, C, G, T = 0..3, anything else and padding = 4); the extract kernel packs
to 2 bits on the device.
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


def decode_read(codes: np.ndarray) -> str:
    """One int8 code row back to a string, the padding stripped."""
    return bytes(_BASES[np.clip(np.asarray(codes), 0, 4)]).decode().rstrip("N")
