"""Contig-set verification.

``canonical_contig_set`` and ``diff_contig_sets`` keep the reference's import
path (``tpu_euler/verify/compare.py``); the functions live in ``oracle.py``.
``substring_gate`` is the gate of the full-size runs that no oracle can
replay (``scripts/fullscale_adversarial.py:50-73``). The gates of the
full-size runs (``chip_smoke.py`` and the bench entry, ``bench.py``) raise
``AssertionError`` with the run's name and print what passed:
``check_one_contig``, ``check_substring_gate`` and ``same_assembly``.
"""

from __future__ import annotations

import json
import time

import numpy as np

from tpu_euler_torch.oracle import canonical_contig_set, diff_contig_sets, rc

__all__ = [
    "canonical_contig_set", "check_one_contig", "check_substring_gate", "contig_sets_equal", "diff_contig_sets",
    "n50", "same_assembly", "substring_gate",
]

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


def check_one_contig(name, contigs, genome, k) -> None:
    """Exactly one contig of G + k - 1 bases that spells the circular genome
    read from some rotation, on either strand: it, or its reverse
    complement, lies in genome + genome."""
    contigs = list(contigs)
    if len(contigs) != 1 or len(contigs[0]) != len(genome) + k - 1:
        raise AssertionError(f"{name}: expected exactly one contig of G + k - 1 bases")
    contig, doubled = contigs[0].decode(), genome + genome
    if contig not in doubled and rc(contig) not in doubled:
        raise AssertionError(f"{name}: the contig does not spell the genome")
    print(f"{name}: the contig of {len(contig)} bases spells the circular genome exactly")


def check_substring_gate(name, contigs, genome, circular, min_coverage, min_contigs) -> None:
    """The gate of scripts/fullscale_adversarial.py: at least ``min_contigs``
    contigs, every one of 150 bases or more an exact substring of the genome
    or of its reverse complement, and those cover ``min_coverage`` of it."""
    t0 = time.perf_counter()
    gate = substring_gate(contigs, genome, 150, circular=circular)
    print(f"{name}: gate in {time.perf_counter() - t0:.2f} s: " + json.dumps(gate))
    if not (
        gate["contigs_total"] >= min_contigs
        and gate["contigs_checked"] > 0
        and gate["contigs_substring_ok"] == gate["contigs_checked"]
        and gate["coverage_lower_bound"] >= min_coverage
    ):
        raise AssertionError(f"{name}: the substring gate failed (coverage floor {min_coverage:.4f})")
    print(
        f"{name}: every contig of >= 150 bases ({gate['contigs_checked']}) is an exact substring of the "
        f"genome or its reverse complement; they cover {100 * gate['coverage_lower_bound']:.2f}% "
        f"(floor {100 * min_coverage:.2f}%)"
    )


def same_assembly(name, got, want) -> None:
    """``got`` counted the windows and k-mers of ``want`` and emitted its
    contigs."""
    if (got.n_reads, got.n_kmers_counted, got.n_distinct_kmers, got.contigs) != (
        want.n_reads, want.n_kmers_counted, want.n_distinct_kmers, want.contigs
    ):
        raise AssertionError(
            f"{name}: {got.n_reads} reads, {got.n_kmers_counted} windows, {got.n_distinct_kmers} distinct k-mers, "
            f"{len(got.contigs)} contigs differ from the one-device run's "
            f"{want.n_reads}, {want.n_kmers_counted}, {want.n_distinct_kmers}, {len(want.contigs)}"
        )
