"""End-to-end single-device assembly pipeline.

Counterpart of ``tpu_euler/pipeline/assemble.py`` on its one-shot,
non-cleaning route (SPEC config 2): reads -> int8 codes -> per batch, the
fused extract kernel fills a buffer of canonical window keys -> one sort +
dedup into a spectrum -> right-size + cutoff -> staged graph -> unitig chains
-> device emission -> canonical contigs.

Stage timers use the reference's keys: ``encode`` (host batch preparation and
its host-to-device copy), ``count`` (kernel launches), ``count_drain`` (the
sort and reduce, ending in a host read), ``graph`` and ``extract``.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from tpu_euler_torch.config import AssemblyConfig
from tpu_euler_torch.euler.extract import chains_to_contigs_device_spec
from tpu_euler_torch.euler.unitigs import chains_from_successors_spec, successor
from tpu_euler_torch.graph.build import build_graph_staged
from tpu_euler_torch.kmer import keys
from tpu_euler_torch.kmer.count import Spectrum, apply_cutoff, oneshot_count
from tpu_euler_torch.kmer.extract_kernel import extract_fill

log = logging.getLogger("tpu_euler_torch")

_LUT = np.full(256, 4, dtype=np.int8)  # A/C/G/T (either case) -> 0..3, else N = 4
for _i, _b in enumerate(b"ACGT"):
    _LUT[_b] = _LUT[_b | 0x20] = _i


def encode_reads(reads, read_len: int) -> np.ndarray:
    """[R, read_len] int8 codes of read str/bytes [tpu_euler/io/encode.py:25]:
    longer reads are cut, shorter ones padded with N (4)."""
    out = np.full((len(reads), read_len), 4, dtype=np.int8)
    for i, r in enumerate(reads):
        r = (r.encode() if isinstance(r, str) else r)[:read_len]
        out[i, : len(r)] = _LUT[np.frombuffer(r, dtype=np.uint8)]
    return out


@dataclasses.dataclass
class AssemblyResult:
    contigs: set[bytes]
    n_distinct_kmers: int
    n_kmers_counted: int
    n_reads: int
    stage_seconds: dict[str, float]

    @property
    def contig_strings(self) -> set[str]:
        return {c.decode() for c in self.contigs}


def _n_batches(codes_all: np.ndarray, cfg: AssemblyConfig) -> int:
    return max(1, -(-codes_all.shape[0] // cfg.read_batch))


def _batch(codes_all: np.ndarray, b: int, cfg: AssemblyConfig, device) -> torch.Tensor:
    """Batch b padded to ``read_batch`` rows with code-4 reads, on ``device``."""
    batch = codes_all[b * cfg.read_batch : (b + 1) * cfg.read_batch]
    if batch.shape[0] < cfg.read_batch:
        pad = np.full((cfg.read_batch - batch.shape[0], cfg.read_len), 4, np.int8)
        batch = np.concatenate([batch, pad], axis=0)
    return torch.from_numpy(np.ascontiguousarray(batch, dtype=np.int8)).to(device)


def count_spectrum(
    codes_all: np.ndarray, cfg: AssemblyConfig, device, t: dict | None = None
) -> tuple[Spectrum, int]:
    """Count an [R, read_len] int8 code matrix into a Spectrum on ``device``.

    Only the one-shot route is ported: every batch's window keys go into one
    buffer that is sorted once (two stable passes for two-word keys).
    Returns (spectrum, n_windows_counted).
    """
    keys.check_k(cfg.k)
    device = torch.device(device)
    t = t if t is not None else {}
    for name in ("encode", "count", "count_drain"):
        t.setdefault(name, 0.0)
    Wb = cfg.read_batch * cfg.windows_per_read
    n_batches = _n_batches(codes_all, cfg)
    T = n_batches * Wb
    if not cfg.oneshot_rows or T > cfg.oneshot_rows:
        raise NotImplementedError(
            f"{T} window rows exceed oneshot_rows={cfg.oneshot_rows}: grouped "
            "arena counting is not ported yet (ROADMAP Queue 1, step 11)"
        )
    buf = torch.empty((T,) + keys.word_shape(cfg.k), dtype=torch.int64, device=device)
    n_windows = torch.zeros((), dtype=torch.int64, device=device)
    for b in range(n_batches):
        t0 = time.perf_counter()
        codes = _batch(codes_all, b, cfg, device)
        t1 = time.perf_counter()
        n_windows += extract_fill(codes, buf, b * Wb, cfg.k)
        t["encode"] += t1 - t0
        t["count"] += time.perf_counter() - t1
    t1 = time.perf_counter()
    acc, over = oneshot_count(buf, cfg.spectrum_capacity)
    del buf
    n_windows = int(n_windows)
    t["count_drain"] += time.perf_counter() - t1
    if over:
        raise RuntimeError(
            f"spectrum capacity {cfg.spectrum_capacity} overflowed: "
            f"raise AssemblyConfig.spectrum_capacity"
        )
    return acc, n_windows


def right_size_spectrum(acc: Spectrum, granule: int = 1 << 18) -> Spectrum:
    """Slice the capacity-padded spectrum down to ~1.06x its live size,
    granule-rounded. Edge, node and chain ids are positions in arrays of this
    size, so the rounding must stay the reference's."""
    C = acc.words.shape[0]
    cap2 = min(C, max(granule, -(-int(acc.n * 1.06) // granule) * granule))
    if cap2 >= C:
        return acc
    return Spectrum(acc.words[:cap2], acc.counts[:cap2], acc.n)


def spectrum_to_contigs(
    acc: Spectrum, cfg: AssemblyConfig, t: dict | None = None
) -> tuple[set, int]:
    """Cutoff + graph + traversal + emission. Returns (contigs, n_cut)."""
    if cfg.tip_rounds or cfg.bubble_rounds:
        raise NotImplementedError(
            "tip clipping and bubble popping are not ported yet "
            "(ROADMAP Queue 1, step 12)"
        )
    t = t if t is not None else {}
    device = acc.words.device
    acc = right_size_spectrum(acc)
    t2 = time.perf_counter()
    cut = apply_cutoff(acc, cfg.min_count)
    del acc
    E = 2 * cut.words.shape[0]
    node_cap = 0  # 0 -> exact worst case 2E
    if cfg.node_cap_factor < 2.0:
        granule = 1 << 18
        node_cap = min(2 * E, -(-int(cfg.node_cap_factor * E) // granule) * granule)
    g = build_graph_staged(cut, cfg.k, node_cap)
    succ0 = successor(g)
    edge_valid = g.edge_valid
    del g
    chains = chains_from_successors_spec(cut.words, edge_valid, succ0, cfg.k)
    del succ0
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # the graph timer ends on finished work
    t["graph"] = time.perf_counter() - t2
    t3 = time.perf_counter()
    contigs = chains_to_contigs_device_spec(cut.words, chains, cfg.k)
    t["extract"] = time.perf_counter() - t3
    return contigs, cut.n


def assemble_codes(codes_all: np.ndarray, cfg: AssemblyConfig, device) -> AssemblyResult:
    """Assemble from a pre-encoded [R, read_len] int8 code matrix on ``device``."""
    t: dict = {}
    acc, n_windows = count_spectrum(codes_all, cfg, device, t)
    contigs, n_cut = spectrum_to_contigs(acc, cfg, t)
    n_reads = codes_all.shape[0]
    log.info(
        "assembled %d reads -> %d distinct kmers -> %d contigs (%s)",
        n_reads, n_cut, len(contigs), {s: f"{v:.3f}s" for s, v in t.items()},
    )
    return AssemblyResult(
        contigs=contigs,
        n_distinct_kmers=n_cut,
        n_kmers_counted=n_windows,
        n_reads=n_reads,
        stage_seconds=t,
    )


def assemble_reads(reads, cfg: AssemblyConfig, device) -> AssemblyResult:
    """Assemble a list of read strings into canonical contigs on ``device``."""
    reads = list(reads)
    return assemble_codes(encode_reads(reads, cfg.read_len), cfg, device)
