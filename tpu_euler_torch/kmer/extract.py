"""k-mer extraction from encoded read batches (plain PyTorch).

Counterpart of ``tpu_euler/kmer/extract.py:extract_canonical_kmers``. This is
the plain version that ``extract_kernel.py``'s CUDA kernel is held against.
It folds the k shifted [R, W] slices one base at a time, so its transients
stay [R, W] words instead of an [R, W, k] window stack.

``unpack_codes`` and ``unpack_codes_clean`` turn the feed's 2.25-bit batches
(``io/encode.py`` ``pack_codes``) back into int8 codes: the plain half of the
kernel's packed loader, which reads those bytes itself.

``extract_canonical_kmers_packed`` computes the same keys the way the CUDA
kernel does (``csrc/kmer_tile.cuh``): each read is packed once, and every
key word is cut from the packed read by two shifts and an OR. It is there so
that the kernel's arithmetic is tested where no kernel runs; the pipeline
does not call it.
"""

from __future__ import annotations

import torch

from tpu_euler_torch.kmer import keys


def extract_kmers(codes: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """All k-windows of a read batch.

    Args:
      codes: [R, Lmax] int8 base codes (0..3, 4 = N/pad).
      k: k-mer length.

    Returns:
      words: [R * W] int64 keys, or [R * W, nwords(k)] for k > 31 (W =
        Lmax - k + 1 windows per read).
      valid: [R * W] bool, True where the window holds no code 4.
    """
    R, Lmax = codes.shape
    W = Lmax - k + 1
    c = codes.to(torch.int64)
    valid = torch.ones((R, W), dtype=torch.bool, device=codes.device)
    words = []
    for a, b in keys.word_spans(k):  # one word's bases at a time
        w = torch.zeros((R, W), dtype=torch.int64, device=codes.device)
        for i in range(a, b):
            s = c[:, i : i + W]
            w = (w << 2) | (s & 3)
            valid &= s != keys.BASE_N
        words.append(w.reshape(R * W))
    out = words[0] if len(words) == 1 else torch.stack(words, dim=-1)
    return out, valid.reshape(R * W)


def extract_canonical_kmers(
    codes: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Extract + canonicalize (min of k-mer and reverse complement)."""
    words, valid = extract_kmers(codes, k)
    canon, _ = keys.canonical(words, k)
    return canon, valid


def unpack_codes_clean(packed: torch.Tensor, read_len: int) -> torch.Tensor:
    """[R, ceil(L/4)] uint8 packed codes -> [R, read_len] int8 codes 0..3,
    for a batch without an N map [reference unpack_codes_clean, :67]."""
    R = packed.shape[0]
    sh2 = torch.arange(0, 8, 2, dtype=torch.uint8, device=packed.device)
    c = (packed[:, :, None] >> sh2) & 3
    return c.reshape(R, -1)[:, :read_len].to(torch.int8)


def unpack_codes(packed: torch.Tensor, nmask: torch.Tensor, read_len: int) -> torch.Tensor:
    """The inverse of ``io.encode.pack_codes_np`` [reference unpack_codes,
    :51]: base code + 4 x its N-map bit, as [R, read_len] int8."""
    R = nmask.shape[0]
    sh1 = torch.arange(8, dtype=torch.uint8, device=nmask.device)
    nb = ((nmask[:, :, None] >> sh1) & 1).reshape(R, -1)[:, :read_len]
    return unpack_codes_clean(packed, read_len) + 4 * nb.to(torch.int8)


# ---- the kernel's arithmetic (csrc/kmer_tile.cuh) in int64 tensor ops ----

_TILE_BASES = 32  # bases in one 64-bit word of a packed strand


def _lsr(x: torch.Tensor, s) -> torch.Tensor:
    """Logical right shift by 1 <= s <= 63 (int or tensor): torch's ``>>`` on
    int64 is arithmetic, so the copies of the sign bit are masked off."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def pack_reads(codes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The packed tile of a read batch [R, Lmax], as the kernel builds it.

    Returns (fwd, rc, nmap). ``fwd`` and ``rc`` are [R, nq + 1] int64: the
    read and the reverse complement of the whole read at 2 bits a base, 32
    bases a word, first base in the most significant bits, one zero word
    past the end (nq = 2 * ceil(Lmax / 64)). ``nmap`` is [R, nq / 2]: bit
    i % 64 of word i // 64 is set where base i is code 4.
    """
    R, Lmax = codes.shape
    nq = 2 * -(-Lmax // 64)
    slots = _TILE_BASES * nq
    c = torch.zeros((R, slots), dtype=torch.int64, device=codes.device)
    c[:, :Lmax] = codes.to(torch.int64)
    zero = torch.zeros((R, 1), dtype=torch.int64, device=codes.device)
    fwd = keys._fold((c & 3).reshape(R, nq, _TILE_BASES))
    is_n = (c == keys.BASE_N).to(torch.int64).reshape(R, nq // 2, 64)
    nmap = torch.zeros((R, nq // 2), dtype=torch.int64, device=codes.device)
    for b in range(64):
        nmap |= is_n[:, :, b] << b
    # reverse the base order of all slots, shift out the slots - Lmax empty
    # ones that now lead, and complement
    rev = torch.cat([keys._rev2bit64(fwd.flip(1)), zero, zero], dim=1)
    pq, po = divmod(slots - Lmax, _TILE_BASES)
    hi, lo = rev[:, pq : pq + nq], rev[:, pq + 1 : pq + 1 + nq]
    hi = torch.cat([hi, zero.expand(R, nq - hi.shape[1])], dim=1)
    lo = torch.cat([lo, zero.expand(R, nq - lo.shape[1])], dim=1)
    rc = ~((hi << 2 * po) | _lsr(lo, 64 - 2 * po)) if po else ~hi
    return torch.cat([fwd, zero], dim=1), torch.cat([rc, zero], dim=1), nmap


def _cut(strand: torch.Tensor, a: torch.Tensor, n: int) -> torch.Tensor:
    """n <= 31 bases from base a[w] of each packed strand [R, nq + 1],
    right-aligned: [R, W]. Two shifts and an OR of two neighbouring words."""
    q, o = a >> 5, (a & 31) * 2
    hi, lo = strand[:, q], strand[:, q + 1]
    v = torch.where(o == 0, hi, (hi << o) | _lsr(lo, (64 - o).clamp(max=63)))
    return _lsr(v, 64 - 2 * n)


def extract_canonical_kmers_packed(
    codes: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Same contract as ``extract_canonical_kmers``, by the kernel's
    arithmetic: word j of window w's key is a cut of the packed read at base
    w + (its offset in the key), the reverse complement the same cut of the
    packed reverse-complement strand at base Lmax - k - w, and the window is
    valid where the k map bits from bit w are zero."""
    R, Lmax = codes.shape
    W = Lmax - k + 1
    fwd, rc, nmap = pack_reads(codes)
    w = torch.arange(W, device=codes.device)
    f_words = [_cut(fwd, w + a, b - a) for a, b in keys.word_spans(k)]
    r_words = [_cut(rc, Lmax - k - w + a, b - a) for a, b in keys.word_spans(k)]
    bad = torch.zeros((R, W), dtype=torch.bool, device=codes.device)
    for q in range(nmap.shape[1]):
        lo = (w - 64 * q).clamp(0, 64)
        n = (w + k - 64 * q).clamp(0, 64) - lo
        m = torch.where(n >= 64, -1, ((1 << n.clamp(max=63)) - 1) << lo.clamp(max=63))
        bad |= (nmap[:, q : q + 1] & m) != 0
    if len(f_words) == 1:
        f, r = f_words[0].reshape(R * W), r_words[0].reshape(R * W)
    else:
        f = torch.stack([x.reshape(R * W) for x in f_words], dim=-1)
        r = torch.stack([x.reshape(R * W) for x in r_words], dim=-1)
    return keys.select(keys.key_less(r, f), r, f), ~bad.reshape(R * W)
