"""2-bit-packed k-mer keys as int64 words.

Counterpart of ``tpu_euler/kmer/keys.py``. A k-mer is packed 2 bits/base
(A=0, C=1, G=2, T=3), big-endian (first base most significant).

* k <= 31: one int64 word per key, right-aligned, a 1-D tensor ``[N]``. A key
  uses at most 62 bits, so it is a non-negative int64 and signed order equals
  the reference's unsigned lexicographic limb order: the word is
  ``limb0 << 32 | limb1`` of the reference's uint32 limbs.
* 31 < k <= 61: two int64 words per key, a tensor ``[N, 2]`` of ``(hi, lo)``.
  ``lo`` holds the last 31 bases (62 bits), ``hi`` the first k - 31. With V
  the reference's 2k-bit value, ``hi = V >> 62`` and ``lo = V & (2^62 - 1)``:
  both words stay non-negative, and lexicographic signed order on ``(hi, lo)``
  equals the reference's unsigned limb order. The same holds for the
  (k-1)-mer endpoints and the (k+1)-mer transition keys of such a k, which
  are two-word keys as well (32 <= length <= 62).

The functions below take one-word or two-word key tensors and tell them
apart by their shape: a one-word key tensor is 1-D, a two-word one 2-D.

Two rules keep the int64 arithmetic exact:

* ``>>`` on int64 is arithmetic, so every right shift of a value that may have
  bit 63 set is masked.
* ``<<`` wraps (torch shifts through the unsigned type), but multiplication
  overflow is not relied on: ``_mul32`` splits its constant.

(k+1)-mer transition keys (``tkey``) need 64 bits at k = 31. They are stored
as ``raw ^ INT64_MIN`` so that signed order equals unsigned order; the
reference's all-ones sentinel then becomes ``INT64_MAX`` (``SENT``). A
canonical 32-mer is never all ones (its reverse complement, all A, is
smaller), so the sentinel stays distinct from every valid key. The invalid
two-word key is ``(SENT, SENT)``; a valid ``hi`` is below 2^62.
"""

from __future__ import annotations

import torch

BASE_N = 4  # N / padding code

SENT = (1 << 63) - 1  # INT64_MAX: invalid key, sorts last
INT64_MIN = -(1 << 63)
LO_BASES = 31  # bases in one word, and in the low word of a two-word key
MAX_K = 2 * LO_BASES - 1  # odd k whose (k+1)-mers still fit two words


def mask(bits: int) -> int:
    """Low-``bits`` mask as a Python int in int64 range (-1 for 64 bits)."""
    return -1 if bits >= 64 else (1 << bits) - 1


LO_MASK = mask(2 * LO_BASES)


def nwords(k: int) -> int:
    """int64 words per key of k bases."""
    return 1 if k <= LO_BASES else 2


def word_shape(k: int) -> tuple[int, ...]:
    """Trailing shape of a tensor of k-base keys: () for one word, (2,) for
    (hi, lo)."""
    return () if nwords(k) == 1 else (2,)


def check_k(k: int) -> None:
    if k < 3 or k % 2 == 0 or k > MAX_K:
        raise ValueError(
            f"k must be odd and in [3, {MAX_K}] (at most two int64 words per key), got {k}"
        )


def _two(w: torch.Tensor) -> bool:
    return w.dim() == 2


def _pair(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return torch.stack([hi, lo], dim=-1)


def _fold(c: torch.Tensor) -> torch.Tensor:
    """Big-endian 2-bit fold of codes [..., n] (n <= 31) into one word."""
    w = torch.zeros(c.shape[:-1], dtype=torch.int64, device=c.device)
    for i in range(c.shape[-1]):
        w = (w << 2) | c[..., i]
    return w


def pack(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Pack base codes [N, k] (low 2 bits used) into keys [N] or [N, 2]."""
    c = codes.to(torch.int64) & 3
    if nwords(k) == 1:
        return _fold(c)
    h = k - LO_BASES
    return _pair(_fold(c[..., :h]), _fold(c[..., h:]))


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


def _revcomp1(w: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of one-word 2k-bit keys (2k <= 64)."""
    r = _rev2bit64(~w)
    s = 64 - 2 * k
    if s:
        r = r >> s
    return r & mask(2 * k)


def revcomp(w: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of k-base keys: reverse the base order and
    complement each base (c -> 3 - c, i.e. bitwise NOT).

    Two words: realign the key as (its first 31 bases, its last h = k - 31
    bases), then the reverse complement's low word is the first part's and
    its high word the last part's, each reversed within one word."""
    if not _two(w):
        return _revcomp1(w, k)
    h = k - LO_BASES
    hi, lo = w[..., 0], w[..., 1]
    first = (hi << 2 * (LO_BASES - h)) | (lo >> 2 * h)
    last = lo & mask(2 * h)
    return _pair(_revcomp1(last, h), _revcomp1(first, LO_BASES))


def key_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Key order. Words (and tkeys) are ordered by plain signed comparison,
    word pairs lexicographically; this is the reference's unsigned
    lexicographic limb order."""
    if not _two(a):
        return a < b
    return (a[..., 0] < b[..., 0]) | ((a[..., 0] == b[..., 0]) & (a[..., 1] < b[..., 1]))


def key_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a == b if not _two(a) else (a == b).all(dim=-1)


def key_ne(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a != b if not _two(a) else (a != b).any(dim=-1)


def is_valid(w: torch.Tensor) -> torch.Tensor:
    """Per key: not the sentinel."""
    return (w if not _two(w) else w[..., 0]) != SENT


def select(cond: torch.Tensor, a: torch.Tensor, b) -> torch.Tensor:
    """``torch.where`` over keys: ``cond`` [N] picks whole keys of ``a``
    or ``b`` (a key tensor or a scalar such as ``SENT``)."""
    return torch.where(cond[..., None] if _two(a) else cond, a, b)


def sort(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable ascending key sort: (sorted keys, permutation). Two words take
    two stable passes, first on ``lo``, then on ``hi`` carried through the
    first pass's permutation."""
    if not _two(w):
        return torch.sort(w, stable=True)
    lo, perm = torch.sort(w[:, 1], stable=True)
    hi, p2 = torch.sort(w[:, 0][perm], stable=True)
    return _pair(hi, lo[p2]), perm[p2]


def dense_rank(w: torch.Tensor) -> torch.Tensor:
    """[N] int64 rank of each valid key among the distinct valid keys (equal
    keys share a rank); ``SENT`` where the key is the sentinel. Ranks keep
    the keys' order and equality."""
    s, perm = sort(w)
    is_new = torch.ones(s.shape[0], dtype=torch.bool, device=w.device)
    is_new[1:] = key_ne(s[1:], s[:-1])
    rank = torch.empty(s.shape[0], dtype=torch.int64, device=w.device)
    rank[perm] = torch.cumsum(is_new, 0) - 1
    return torch.where(is_valid(w), rank, SENT)


def canonical(w: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """min(key, revcomp(key)); returns (canonical, was_rc)."""
    rc = revcomp(w, k)
    rc_smaller = key_less(rc, w)
    return select(rc_smaller, rc, w), rc_smaller


def prefix(w: torch.Tensor) -> torch.Tensor:
    """(k-1)-mer prefix: drop the last (least significant) base."""
    if not _two(w):
        return w >> 2
    hi, lo = w[..., 0], w[..., 1]
    return _pair(hi >> 2, ((hi & 3) << 2 * (LO_BASES - 1)) | (lo >> 2))


def suffix(w: torch.Tensor, k: int) -> torch.Tensor:
    """(k-1)-mer suffix: drop the first (most significant) base."""
    if not _two(w):
        return w & mask(2 * (k - 1))
    return _pair(w[..., 0] & mask(2 * (k - 1 - LO_BASES)), w[..., 1])


def append_base(w: torch.Tensor, base: torch.Tensor, k: int) -> torch.Tensor:
    """Raw pattern of the (k+1)-mer ``w + base``. At k = 31 it uses all 64
    bits of one word and may be negative as an int64 (see ``to_tkey``)."""
    b = base.to(torch.int64) & 3
    if not _two(w):
        return ((w << 2) | b) & mask(2 * (k + 1))
    hi, lo = w[..., 0], w[..., 1]
    return _pair((hi << 2) | (lo >> 2 * (LO_BASES - 1)), ((lo << 2) | b) & LO_MASK)


def last_base(w: torch.Tensor) -> torch.Tensor:
    """Final (least significant) base code of each key."""
    return (w if not _two(w) else w[..., 1]) & 3


def first_base(w: torch.Tensor, k: int) -> torch.Tensor:
    """First (most significant) base code of each k-base key."""
    if not _two(w):
        return (w >> (2 * k - 2)) & 3
    return (w[..., 0] >> 2 * (k - LO_BASES - 1)) & 3


def to_tkey(raw: torch.Tensor) -> torch.Tensor:
    """Raw up-to-64-bit pattern -> int64 whose signed order is the unsigned
    order of ``raw``."""
    return raw ^ INT64_MIN


def canonical_tkey(raw: torch.Tensor, k1: int) -> torch.Tensor:
    """Canonical (k1)-mer of raw patterns: one word (k1 <= 32) as a tkey;
    two words as they are, since both words are non-negative."""
    if _two(raw):
        return canonical(raw, k1)[0]
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
