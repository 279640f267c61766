"""Contig-set verification.

``canonical_contig_set`` and ``diff_contig_sets`` keep the reference's import
path (``tpu_euler/verify/compare.py``); the functions live in ``oracle.py``.
``substring_gate`` is the gate of the full-size runs that no oracle can
replay (``scripts/fullscale_adversarial.py:50-73``).
"""

from __future__ import annotations

import numpy as np

from tpu_euler_torch.oracle import canonical_contig_set, diff_contig_sets, rc

__all__ = ["canonical_contig_set", "contig_sets_equal", "diff_contig_sets", "n50", "substring_gate"]

_ANCHOR = 31  # bases of a contig looked up in the genome's index


def contig_sets_equal(a, b) -> bool:
    return canonical_contig_set(a) == canonical_contig_set(b)


def n50(lengths) -> int:
    """The length at which the contigs that long or longer hold half of
    all bases."""
    lengths = sorted(lengths, reverse=True)
    half, run = sum(lengths) / 2, 0
    for n in lengths:
        run += n
        if run >= half:
            return n
    return 0


def _anchor_keys(codes: np.ndarray) -> np.ndarray:
    """2-bit key of the ``_ANCHOR`` bases at every position of ``codes``."""
    n = codes.size - _ANCHOR + 1
    key = np.zeros(max(n, 0), dtype=np.int64)
    for j in range(_ANCHOR):
        key = (key << 2) | codes[j : j + n]
    return key


def substring_gate(contigs, genome: str, min_len: int = 150, circular: bool = False) -> dict:
    """Is every contig of at least ``min_len`` bases an exact substring of
    the genome or of its reverse complement? A circular genome is doubled,
    so that a contig across its origin is found. The sum of the matched
    contigs' bases over the genome's is a lower bound of the coverage.

    The reference scans the genome once a contig; here the genome's
    31-mers are sorted once, a contig's first 31 bases find its candidate
    positions, and the bytes are compared there: thousands of contigs
    against tens of megabases take seconds.
    """
    text = np.frombuffer(((genome + genome) if circular else genome).encode(), dtype=np.uint8)
    lut = np.zeros(256, dtype=np.int64)
    lut[np.frombuffer(b"ACGT", dtype=np.uint8)] = np.arange(4)
    keys = _anchor_keys(lut[text])
    order = np.argsort(keys, kind="stable")
    keys = keys[order]

    def found(seq: str) -> bool:
        s = np.frombuffer(seq.encode(), dtype=np.uint8)
        key = _anchor_keys(lut[s[:_ANCHOR]])[0]
        lo, hi = np.searchsorted(keys, key, "left"), np.searchsorted(keys, key, "right")
        return any(
            p + s.size <= text.size and np.array_equal(text[p : p + s.size], s) for p in order[lo:hi]
        )

    n_checked = n_ok = matched = 0
    bad: list[int] = []
    for c in sorted((c.decode() if isinstance(c, bytes) else c for c in contigs), key=len, reverse=True):
        if len(c) < max(min_len, _ANCHOR):
            continue
        n_checked += 1
        if found(c) or found(rc(c)):
            n_ok += 1
            matched += len(c)
        else:
            bad.append(len(c))
    return {
        "contigs_total": len(contigs),
        "contigs_checked": n_checked,
        "contigs_substring_ok": n_ok,
        "bad_contig_lens": bad[:10],
        "matched_bases": matched,
        "coverage_lower_bound": matched / len(genome),
    }
