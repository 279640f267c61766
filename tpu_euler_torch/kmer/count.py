"""Sort-based k-mer counting into a spectrum.

Counterpart of the one-shot count of ``tpu_euler`` (``make_oneshot_count``,
pipeline/assemble.py:198, with ``oneshot_reduce``, kmer/count.py:132) and of
``apply_cutoff`` (kmer/count.py:111). The reference sorts L uint32 limb
operands; here a key of k <= 31 is one int64 word, so the one-shot sort is a
single ``torch.sort``, and a two-word key (k > 31) takes two stable passes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_euler_torch.kmer import keys


class Spectrum(NamedTuple):
    """Sorted distinct canonical k-mers with counts, padded to capacity."""

    words: torch.Tensor  # [C] (or [C, 2]) int64, key-sorted in rows [0, n), 0 after
    counts: torch.Tensor  # [C] int32, 0 after row n
    n: int  # number of valid rows


def oneshot_count(buf: torch.Tensor, capacity: int) -> tuple[Spectrum, bool]:
    """Dedup + count a buffer of window keys (``keys.SENT`` = invalid).

    Returns (capacity-row Spectrum, overflowed). ``buf`` is not modified.
    """
    s, _ = keys.sort(buf)
    sv = keys.is_valid(s)
    n_valid = int(sv.sum())
    s = s[:n_valid]  # sentinels sort last
    is_new = torch.ones(n_valid, dtype=torch.bool, device=buf.device)
    is_new[1:] = keys.key_ne(s[1:], s[:-1])
    starts = torch.nonzero(is_new).squeeze(1)
    n = starts.numel()
    m = min(n, capacity)
    bounds = torch.cat([starts, starts.new_tensor([n_valid])])
    words = buf.new_zeros((capacity,) + tuple(buf.shape[1:]))
    counts = torch.zeros(capacity, dtype=torch.int32, device=buf.device)
    words[:m] = s[starts[:m]]
    counts[:m] = (bounds[1 : m + 1] - bounds[:m]).to(torch.int32)
    return Spectrum(words, counts, m), n > capacity


def apply_cutoff(spec: Spectrum, min_count: int) -> Spectrum:
    """Drop k-mers with count < min_count and recompact; capacity unchanged."""
    C = spec.words.shape[0]
    keep = spec.counts[: spec.n] >= min_count
    kept_w = spec.words[: spec.n][keep]
    kept_c = spec.counts[: spec.n][keep]
    m = kept_w.shape[0]
    words = torch.zeros_like(spec.words)
    counts = torch.zeros(C, dtype=torch.int32, device=spec.words.device)
    words[:m] = kept_w
    counts[:m] = kept_c
    return Spectrum(words, counts, m)
