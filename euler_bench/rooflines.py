"""The card's peaks and the bytes each kernel's work needs, for roofline
shares.

A kernel's share of its roofline is the least time its work could take on
the card (its bytes over the peak bandwidth; the port's kernels do integer
work far below any compute peak) over the device time the profiler read
for it. Bytes count each input read once and each output written once.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80GB data sheet: HBM3 bandwidth, at the 700 W limit
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
WORD_BASES = 31


def peak_bytes_per_s(kind: str) -> float:
    """The card's published bandwidth; raises for a card not in the table."""
    try:
        return PEAK_BYTES_PER_S[kind]
    except KeyError:
        raise KeyError(f"no published bandwidth for {kind!r}: add it to PEAK_BYTES_PER_S") from None


def extract_fill_bytes(n_reads: int, read_len: int, k: int, read_batch: int, has_n: bool = False) -> int:
    """Bytes of the extract kernel's packed loader over ``n_reads`` reads fed
    in batches of ``read_batch``: each read's packed bases (2 bits a base,
    ``ceil(L / 4)`` bytes) read once, its map of N positions (``ceil(L / 8)``
    bytes) where its batch ships one, and each of its ``L - k + 1`` windows'
    canonical key words (``ceil(k / 31)`` int64) written once. A batch ships
    its map unless it is full, holds no N, and its read length is a multiple
    of 8. Pad rows of a partial batch are not the reads' work and are not
    counted."""
    words = -(-k // WORD_BASES)
    packed, nmask = -(-read_len // 4), -(-read_len // 8)
    partial = n_reads % read_batch
    map_reads = n_reads if (read_len % 8 or has_n) else partial
    return n_reads * (packed + (read_len - k + 1) * words * 8) + map_reads * nmask


def extract_fill_bytes_of(n_reads: int, settings: dict) -> int:
    """``extract_fill_bytes`` for one assembly of a cell's reads (no N)."""
    return extract_fill_bytes(n_reads, settings["read_len"], settings["k"], settings["read_batch"])
