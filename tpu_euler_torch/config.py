"""Assembly configuration of the port.

Counterpart of ``tpu_euler/config.py:AssemblyConfig``, cut to the fields the
port reads. The port reads a config by attribute only, so the
reference's config, whose fields carry the same names and defaults, works
unchanged in its place (the parity tests pass it).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AssemblyConfig:
    """Static configuration of one assembly run.

    Attributes:
      k: k-mer length; odd, so no k-mer is its own reverse complement, and
        at most ``read_len``. Keys take ceil(k/31) int64 words.
      min_count: canonical k-mers counted fewer times are dropped.
      read_batch: reads per batch handed to the extract kernel.
      read_len: padded read length; shorter reads are padded with N (code 4).
      spectrum_capacity: most distinct canonical k-mers the spectrum holds.
      tip_rounds: rounds of tip clipping after the cutoff (0 = off).
      tip_len: a dead-end chain of fewer edges is a tip (0 = 2k).
      bubble_rounds: rounds of simple-bubble popping after the tips (0 = off).
      bubble_len: a bubble's branches all have fewer edges (0 = 2k).
      oneshot_rows: most window rows the one-shot count buffers; a run with
        more counts in groups of ``oneshot_rows // (read_batch *
        windows_per_read)`` batches, and 0 counts batch by batch.
      node_cap_factor: node-array capacity as a fraction of the edge count.
    """

    k: int = 31
    min_count: int = 1
    read_batch: int = 4096
    read_len: int = 100
    spectrum_capacity: int = 1 << 20
    tip_rounds: int = 0
    tip_len: int = 0
    bubble_rounds: int = 0
    bubble_len: int = 0
    oneshot_rows: int = 192_000_000
    node_cap_factor: float = 2.0

    def __post_init__(self):
        if self.k < 3 or self.k % 2 == 0:
            raise ValueError(f"k must be odd and >= 3, got {self.k}")
        if self.read_len < self.k:
            raise ValueError("read_len must be >= k")

    @property
    def windows_per_read(self) -> int:
        return self.read_len - self.k + 1
