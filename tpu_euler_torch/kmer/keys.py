"""2-bit-packed k-mer keys as int64 words.

Counterpart of ``tpu_euler/kmer/keys.py``. A k-mer is packed 2 bits/base
(A=0, C=1, G=2, T=3), big-endian (first base most significant), right-aligned
in one int64 word. For odd k <= 31 a key uses at most 62 bits, so it is a
non-negative int64 and signed order equals the reference's unsigned
lexicographic limb order: the word is ``limb0 << 32 | limb1`` of the
reference's uint32 limbs.

Two rules keep the int64 arithmetic exact:

* ``>>`` on int64 is arithmetic, so every right shift of a value that may have
  bit 63 set is masked.
* ``<<`` wraps (torch shifts through the unsigned type), but multiplication
  overflow is not relied on: ``_mul32`` splits its constant.

(k+1)-mer transition keys (``tkey``) need 64 bits at k = 31. They are stored
as ``raw ^ INT64_MIN`` so that signed order equals unsigned order; the
reference's all-ones sentinel then becomes ``INT64_MAX`` (``SENT``). A
canonical 32-mer is never all ones (its reverse complement, all A, is
smaller), so the sentinel stays distinct from every valid key.
"""

from __future__ import annotations

import torch

BASE_N = 4  # N / padding code

SENT = (1 << 63) - 1  # INT64_MAX: invalid key, sorts last
INT64_MIN = -(1 << 63)
MAX_K = 31  # one word per key


def mask(bits: int) -> int:
    """Low-``bits`` mask as a Python int in int64 range (-1 for 64 bits)."""
    return -1 if bits >= 64 else (1 << bits) - 1


def check_k(k: int) -> None:
    if k < 3 or k % 2 == 0 or k > MAX_K:
        raise ValueError(
            f"k must be odd and in [3, {MAX_K}] (one int64 word per key), got {k}"
        )


def pack(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Pack base codes [..., k] (low 2 bits used) into words [...]."""
    c = codes.to(torch.int64) & 3
    w = torch.zeros(codes.shape[:-1], dtype=torch.int64, device=codes.device)
    for i in range(k):
        w = (w << 2) | c[..., i]
    return w


def _rev2bit64(x: torch.Tensor) -> torch.Tensor:
    """Reverse the thirty-two 2-bit groups of each int64 word."""
    for s, m in (
        (2, 0x3333333333333333),
        (4, 0x0F0F0F0F0F0F0F0F),
        (8, 0x00FF00FF00FF00FF),
        (16, 0x0000FFFF0000FFFF),
        (32, 0x00000000FFFFFFFF),
    ):
        x = ((x & m) << s) | ((x >> s) & m)
    return x


def revcomp(w: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of 2k-bit keys (2k <= 64): reverse the base order
    and complement each base (c -> 3 - c, i.e. bitwise NOT)."""
    r = _rev2bit64(~w)
    s = 64 - 2 * k
    if s:
        r = r >> s
    return r & mask(2 * k)


def key_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Key order. Words (and tkeys) are ordered by plain signed comparison;
    this is the reference's unsigned lexicographic limb order."""
    return a < b


def canonical(w: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """min(key, revcomp(key)) for k <= 31; returns (canonical, was_rc)."""
    rc = revcomp(w, k)
    rc_smaller = rc < w
    return torch.where(rc_smaller, rc, w), rc_smaller


def prefix(w: torch.Tensor) -> torch.Tensor:
    """(k-1)-mer prefix: drop the last (least significant) base."""
    return w >> 2


def suffix(w: torch.Tensor, k: int) -> torch.Tensor:
    """(k-1)-mer suffix: drop the first (most significant) base."""
    return w & mask(2 * (k - 1))


def append_base(w: torch.Tensor, base: torch.Tensor, k: int) -> torch.Tensor:
    """Raw 2(k+1)-bit pattern of the (k+1)-mer ``w + base``. At k = 31 it uses
    all 64 bits and may be negative as an int64 (see ``to_tkey``)."""
    return ((w << 2) | (base.to(torch.int64) & 3)) & mask(2 * (k + 1))


def last_base(w: torch.Tensor) -> torch.Tensor:
    """Final (least significant) base code of each key."""
    return w & 3


def to_tkey(raw: torch.Tensor) -> torch.Tensor:
    """Raw up-to-64-bit pattern -> int64 whose signed order is the unsigned
    order of ``raw``."""
    return raw ^ INT64_MIN


def canonical_tkey(raw: torch.Tensor, k1: int) -> torch.Tensor:
    """Canonical (k1)-mer of raw 2*k1-bit patterns (k1 <= 32), as a tkey."""
    return torch.minimum(to_tkey(raw), to_tkey(revcomp(raw, k1)))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for 0 <= x, c < 2^32, without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3-style finalizer on 32-bit values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x
