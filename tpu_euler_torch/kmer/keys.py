"""2-bit-packed k-mer keys as int64 words.

Counterpart of ``tpu_euler/kmer/keys.py``. A k-mer is packed 2 bits/base
(A=0, C=1, G=2, T=3), big-endian (first base most significant).

* k <= 31: one int64 word per key, right-aligned, a 1-D tensor ``[N]``. A key
  uses at most 62 bits, so it is a non-negative int64 and signed order equals
  the reference's unsigned lexicographic limb order: the word is
  ``limb0 << 32 | limb1`` of the reference's uint32 limbs.
* k > 31: W = ceil(k/31) int64 words per key, a tensor ``[N, W]``: the
  reference's 2k-bit value V written in base 2^62, most significant word
  first. Words 1..W-1 hold 31 bases each and word 0 the first
  k - 31(W-1). Every word stays non-negative, so lexicographic signed order
  over the words equals the reference's unsigned limb order. For W = 2 this
  is ``(hi, lo)`` with ``lo`` the last 31 bases.

A key of n bases may sit in more words than ``nwords(n)``, with leading zero
words: the (k-1)-mer endpoints keep their k-mer's word count (as the
reference keeps its limb count), and the (k+1)-mer of ``append_base`` takes
one more word only where k fills its words (k = 31W). The functions below
tell one-word from multi-word key tensors by their shape (1-D or 2-D) and
read W from the last dimension.

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
multi-word key is ``SENT`` in every word; a valid word is below 2^62.
"""

from __future__ import annotations

import torch

from tpu_euler_torch import trace

BASE_N = 4  # N / padding code

SENT = (1 << 63) - 1  # INT64_MAX: invalid key, sorts last
INT64_MIN = -(1 << 63)
LO_BASES = 31  # bases in one word
#: most elements one ``torch.sort`` takes on a CUDA tensor ("The dimension
#: being sorted can not have more than INT_MAX elements", torch 2.11)
SORT_ROWS_LIMIT = (1 << 31) - 1


def mask(bits: int) -> int:
    """Low-``bits`` mask as a Python int in int64 range (-1 for 64 bits)."""
    return -1 if bits >= 64 else (1 << bits) - 1


LO_MASK = mask(2 * LO_BASES)


def nwords(k: int) -> int:
    """int64 words per key of k bases."""
    return max(1, -(-k // LO_BASES))


def word_shape(k: int) -> tuple[int, ...]:
    """Trailing shape of a tensor of k-base keys: () for one word, (W,) for
    W > 1 words."""
    W = nwords(k)
    return () if W == 1 else (W,)


def check_k(k: int) -> None:
    if k < 3 or k % 2 == 0:
        raise ValueError(f"k must be odd and >= 3, got {k}")


def check_sort_rows(rows: int, what: str) -> None:
    """Raise before allocating a buffer of ``rows`` keys that a later
    ``sort`` could not take in one pass."""
    if rows > SORT_ROWS_LIMIT:
        raise ValueError(
            f"{what} of {rows} rows exceeds the {SORT_ROWS_LIMIT} rows one torch.sort "
            "takes on CUDA: lower AssemblyConfig.oneshot_rows or spectrum_capacity"
        )


def _multi(w: torch.Tensor) -> bool:
    return w.dim() == 2


def _cols(w: torch.Tensor) -> list[torch.Tensor]:
    return [w[..., j] for j in range(w.shape[-1])]


def _stack(cols: list[torch.Tensor]) -> torch.Tensor:
    return torch.stack(cols, dim=-1)


def _fold(c: torch.Tensor) -> torch.Tensor:
    """Big-endian 2-bit fold of codes [..., n] (n <= 31) into one word."""
    w = torch.zeros(c.shape[:-1], dtype=torch.int64, device=c.device)
    for i in range(c.shape[-1]):
        w = (w << 2) | c[..., i]
    return w


def word_spans(k: int) -> list[tuple[int, int]]:
    """Base index range [a, b) of each word of a k-base key in nwords(k)
    words."""
    W = nwords(k)
    h = k - LO_BASES * (W - 1)
    return [(0, h)] + [(h + LO_BASES * (j - 1), h + LO_BASES * j) for j in range(1, W)]


def pack(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Pack base codes [N, k] (low 2 bits used) into keys [N] or [N, W]."""
    c = codes.to(torch.int64) & 3
    if nwords(k) == 1:
        return _fold(c)
    return _stack([_fold(c[..., a:b]) for a, b in word_spans(k)])


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


def _shl(cols: list[torch.Tensor], bits: int) -> list[torch.Tensor]:
    """Left shift of a base-2^62 value by 0 < bits < 62; what leaves word 0
    is dropped."""
    out = [((c << bits) & LO_MASK) | (n >> (2 * LO_BASES - bits)) for c, n in zip(cols, cols[1:])]
    return out + [(cols[-1] << bits) & LO_MASK]


def revcomp(w: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of k-base keys: reverse the base order and
    complement each base (c -> 3 - c, i.e. bitwise NOT).

    W words: left-align the key (shift out the s = 31W - k leading empty
    base slots), so word j holds bases 31j .. 31j + 30; then the reverse
    complement's word j is word W-1-j reversed within one word, and the
    s slots, now leading, are masked back to zero."""
    if not _multi(w):
        return _revcomp1(w, k)
    W = w.shape[-1]
    q, r = divmod(LO_BASES * W - k, LO_BASES)
    cols = _cols(w)[q:]
    if r:
        cols = _shl(cols, 2 * r)
    out = [torch.zeros_like(cols[0])] * q + [_revcomp1(c, LO_BASES) for c in reversed(cols)]
    if r:
        out[q] = out[q] & mask(2 * (LO_BASES - r))
    return _stack(out)


def key_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Key order. Words (and tkeys) are ordered by plain signed comparison,
    multi-word keys lexicographically; this is the reference's unsigned
    lexicographic limb order."""
    if not _multi(a):
        return a < b
    W = a.shape[-1]
    lt = a[..., W - 1] < b[..., W - 1]
    for j in range(W - 2, -1, -1):
        lt = (a[..., j] < b[..., j]) | ((a[..., j] == b[..., j]) & lt)
    return lt


def key_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a == b if not _multi(a) else (a == b).all(dim=-1)


def key_ne(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a != b if not _multi(a) else (a != b).any(dim=-1)


def is_valid(w: torch.Tensor) -> torch.Tensor:
    """Per key: not the sentinel."""
    return (w if not _multi(w) else w[..., 0]) != SENT


def select(cond: torch.Tensor, a: torch.Tensor, b) -> torch.Tensor:
    """``torch.where`` over keys: ``cond`` [N] picks whole keys of ``a``
    or ``b`` (a key tensor or a scalar such as ``SENT``)."""
    return torch.where(cond[..., None] if _multi(a) else cond, a, b)


def sort(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable ascending key sort: (sorted keys, permutation). W words take W
    stable passes, last word first, each carried through the permutation of
    the passes before it. A multi-word sort counts itself, its W passes and
    its rows times W in the trace (host integers: no sync)."""
    if not _multi(w):
        return torch.sort(w, stable=True)
    W = w.shape[1]
    trace.add("key_sorts")
    trace.add("key_sort_passes", W)
    trace.add("key_sort_rows", w.shape[0] * W)
    s, perm = torch.sort(w[:, W - 1], stable=True)
    for j in range(W - 2, -1, -1):
        s, p = torch.sort(w[:, j][perm], stable=True)
        perm = perm[p]
    return _stack([s] + [w[:, j][perm] for j in range(1, W)]), perm


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
    """(k-1)-mer prefix: drop the last (least significant) base. The key
    keeps its word count."""
    if not _multi(w):
        return w >> 2
    cols = _cols(w)
    return _stack(
        [cols[0] >> 2]
        + [((p & 3) << 2 * (LO_BASES - 1)) | (c >> 2) for p, c in zip(cols, cols[1:])]
    )


def suffix(w: torch.Tensor, k: int) -> torch.Tensor:
    """(k-1)-mer suffix: drop the first (most significant) base. The key
    keeps its word count (word 0 becomes 0 where it held one base)."""
    if not _multi(w):
        return w & mask(2 * (k - 1))
    top = k - 1 - LO_BASES * (w.shape[-1] - 1)  # bases left in word 0
    cols = _cols(w)
    return _stack([cols[0] & mask(2 * top)] + cols[1:])


def append_base(w: torch.Tensor, base: torch.Tensor, k: int) -> torch.Tensor:
    """Raw pattern of the (k+1)-mer ``w + base``. At k = 31 it uses all 64
    bits of one word and may be negative as an int64 (see ``to_tkey``); a
    multi-word key that fills its words (k = 31W) gains a word."""
    b = base.to(torch.int64) & 3
    if not _multi(w):
        return ((w << 2) | b) & mask(2 * (k + 1))
    cols = _cols(w)
    carry = [cols[0] >> 2 * (LO_BASES - 1)] if nwords(k + 1) > w.shape[-1] else []
    out = _shl(cols, 2)
    out[-1] = out[-1] | b
    return _stack(carry + out)


def last_base(w: torch.Tensor) -> torch.Tensor:
    """Final (least significant) base code of each key."""
    return (w if not _multi(w) else w[..., -1]) & 3


def first_base(w: torch.Tensor, k: int) -> torch.Tensor:
    """First (most significant) base code of each k-base key in nwords(k)
    words."""
    if not _multi(w):
        return (w >> (2 * k - 2)) & 3
    return (w[..., 0] >> 2 * (k - LO_BASES * (w.shape[-1] - 1) - 1)) & 3


def to_tkey(raw: torch.Tensor) -> torch.Tensor:
    """Raw up-to-64-bit pattern -> int64 whose signed order is the unsigned
    order of ``raw``."""
    return raw ^ INT64_MIN


def canonical_tkey(raw: torch.Tensor, k1: int) -> torch.Tensor:
    """Canonical (k1)-mer of raw patterns: one word (k1 <= 32) as a tkey;
    multi-word keys as they are, since their words are non-negative."""
    if _multi(raw):
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


def nlimbs(k: int) -> int:
    """uint32 limbs per key of k bases in the reference's layout (the same
    2k-bit value, big-endian, 16 bases a limb)."""
    return -(-k // 16)


def limb_word_overlaps(L: int, W: int):
    """(limb j, word i, shift) for each limb/word pair that shares bits of
    one value held as L big-endian 32-bit limbs or W big-endian 62-bit
    words: bit b of the value is bit b - 32(L-1-j) of limb j and bit
    b - 62(W-1-i) of word i; ``shift`` = limb offset - word offset."""
    bits = 2 * LO_BASES
    for j in range(L):
        lo_l = 32 * (L - 1 - j)
        for i in range(W):
            lo_w = bits * (W - 1 - i)
            if lo_l < lo_w + bits and lo_w < lo_l + 32:
                yield j, i, lo_l - lo_w


def limbs(w: torch.Tensor, L: int) -> list[torch.Tensor]:
    """The L big-endian 32-bit limbs of each valid key, each [N] int64 below
    2^32: the reference's limb view of the same value, regrouped from the
    words by shift and mask. The low 32 bits of a left shift that wraps are
    still the value's, so the mask keeps the arithmetic exact."""
    cols = _cols(w) if _multi(w) else [w]
    out = [torch.zeros_like(cols[0]) for _ in range(L)]
    for j, i, sh in limb_word_overlaps(L, len(cols)):
        v = cols[i] >> sh if sh >= 0 else cols[i] << -sh
        out[j] = out[j] | (v & 0xFFFFFFFF)
    return out


def bucket_hash(w: torch.Tensor, L: int, seed: torch.Tensor | None = None) -> torch.Tensor:
    """[N] int64 32-bit scrambled hash of each valid key, the reference's
    fold over its ``L`` uint32 limbs (``nlimbs(k)`` for k-base keys; a
    (k-1)-mer endpoint keeps its k-mer's count): the owner of a key in the
    sharded mode is this hash modulo the number of ranks, so both packages
    must fold the same limbs. The sentinel has no hash worth reading: the
    callers route invalid rows by their validity, not by this value.

    ``seed`` [N] continues a fold: ``bucket_hash(v, L, bucket_hash(u, L))``
    is the reference's hash of the 2L limbs of the pair (u, v)."""
    h = torch.zeros(w.shape[0], dtype=torch.int64, device=w.device) if seed is None else seed
    for limb in limbs(w, L):
        h = _mix32(h ^ limb)
    return h
