"""Sort-based k-mer counting into a spectrum.

Counterpart of ``tpu_euler/kmer/count.py`` (``empty_spectrum``,
``_unique_counts``, ``count_batch``, ``merge_spectra``,
``merge_spectra_lean``, ``apply_cutoff``,
``spectrum_overflowed``; ``merge_keys`` is the merge of the per-batch
route, ``make_count_step`` in pipeline/assemble.py:65) and of the one-shot count (``make_oneshot_count``,
pipeline/assemble.py:198, with ``oneshot_reduce``, count.py:132). The
reference sorts L uint32 limb operands; here a key of k <= 31 is one int64
word, so a sort is a single ``torch.sort``, and a key of W words takes W
stable passes (``keys.sort``). Invalid rows carry ``keys.SENT`` and sort
last, so no validity operand is sorted.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_euler_torch.kmer import keys


class Spectrum(NamedTuple):
    """Sorted distinct canonical k-mers with counts, padded to capacity."""

    words: torch.Tensor  # [C] (or [C, W]) int64, key-sorted in rows [0, n), 0 after
    counts: torch.Tensor  # [C] int32, 0 after row n
    n: int  # number of valid rows


def empty_spectrum(capacity: int, k: int, device) -> Spectrum:
    return Spectrum(
        words=torch.zeros((capacity,) + keys.word_shape(k), dtype=torch.int64, device=device),
        counts=torch.zeros(capacity, dtype=torch.int32, device=device),
        n=0,
    )


def sorted_segments(s: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Runs of equal valid keys in sorted keys ``s`` (``keys.SENT`` last):
    (first row of each run [n], the sum of its int64 weights ``w`` [n]).
    ``w`` is zeroed in place on the invalid rows. A run's sum is the
    difference of the int64 prefix sums at its first row and the next run's,
    so no sum wraps. ``torch.nonzero`` keeps the runs in order; it reads n
    on the host."""
    sv = keys.is_valid(s)
    w.masked_fill_(~sv, 0)
    is_new = sv
    is_new[1:] &= keys.key_ne(s[1:], s[:-1])
    starts = torch.nonzero(is_new).squeeze(1)
    del is_new, sv
    cs = torch.cumsum(w, 0)
    es = cs[starts] - w[starts]  # exclusive prefix sum at each run's first row
    return starts, torch.cat([es[1:], cs[-1:]]) - es


def _unique_counts(words: torch.Tensor, valid: torch.Tensor, weights: torch.Tensor):
    """Sorted distinct valid keys with summed weights.

    Returns (unique [M], counts [M] int32, n_unique), sized like the input:
    rows >= n_unique are 0.
    """
    s, perm = keys.sort(keys.select(valid, words, keys.SENT))
    starts, sums = sorted_segments(s, weights[perm].to(torch.int64))
    n = starts.numel()
    uniq = torch.zeros_like(words)
    counts = torch.zeros(words.shape[0], dtype=torch.int32, device=words.device)
    uniq[:n] = s[starts]
    counts[:n] = sums.to(torch.int32)
    return uniq, counts, n


def count_batch(words: torch.Tensor, valid: torch.Tensor) -> Spectrum:
    """Count one batch of (canonical) keys. Output capacity = batch size."""
    ones = torch.ones(words.shape[0], dtype=torch.int32, device=words.device)
    return Spectrum(*_unique_counts(words, valid, ones))


def merge_keys(
    acc: Spectrum, words: torch.Tensor, valid: torch.Tensor, weights: torch.Tensor
) -> tuple[Spectrum, bool]:
    """Fold keys ``words`` (rows where ``valid``) with int32 ``weights`` into
    the accumulator: one sort over its C rows and theirs, same-key counts
    add. Returns (spectrum of capacity C, overflowed = more than C distinct
    keys)."""
    C = acc.words.shape[0]
    uniq, counts, n = _unique_counts(
        torch.cat([acc.words, words]),
        torch.cat([torch.arange(C, device=acc.words.device) < acc.n, valid]),
        torch.cat([acc.counts, weights]),
    )
    return Spectrum(uniq[:C], counts[:C], min(n, C)), n > C


def merge_spectra(acc: Spectrum, batch: Spectrum) -> Spectrum:
    """Fold a batch spectrum into the accumulator (same-key counts add).

    Output capacity = accumulator capacity; the caller checks overflow
    (``n`` at capacity, ``spectrum_overflowed``)."""
    valid = torch.arange(batch.words.shape[0], device=batch.words.device) < batch.n
    return merge_keys(acc, batch.words, valid, batch.counts)[0]


def merge_spectra_lean(acc: Spectrum, batch: Spectrum, k: int) -> Spectrum:
    """The reference's memory-lean merge of two sorted spectra
    (``merge_spectra_lean`` and its traceable body ``merge_lean_body``,
    count.py:177-260), which the sharded grouped drain folds a group with:
    same rows, counts and ``n`` (at most the accumulator's capacity).

    The reference needs a lean variant because its plain merge sorts a
    validity operand and compacts by scatters; it puts the sentinel into
    limb 0 instead, which is safe only for k % 16 != 0, and asserts that.
    The port's keys always carry their validity as ``keys.SENT``, which no
    key of any odd k equals, so ``merge_spectra`` already is that merge and
    the assertion has nothing to guard. Only the key width is checked."""
    for spec in (acc, batch):
        if tuple(spec.words.shape[1:]) != keys.word_shape(k):
            raise ValueError(f"keys of shape {tuple(spec.words.shape)} are not k = {k} keys")
    return merge_spectra(acc, batch)


def spectrum_overflowed(spec: Spectrum) -> bool:
    """Distinct keys reached capacity: the spectrum may have dropped some."""
    return spec.n >= spec.words.shape[0]


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
