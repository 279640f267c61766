"""What the port's basic operations cost on one device: the twins of the
reference's ``scripts/microbench_*.py``.

    python -m tpu_euler_torch.microbench [--section S ...] [--quick] [--device cuda|cpu] [--out F]

Sections (each a function that returns rows):

* ``ops`` (``microbench_sort.py``, the op table of PERF_TPU.md round 1): at
  13,107,200 rows a one-word key sort carrying a payload, a two-word
  ``keys.sort`` (two stable passes and gathers), a cumsum, a random
  gather, a scatter set, a segment sum by ``index_add_`` against the port's
  ``sorted_segments``, a group's first row by ``scatter_reduce_("amin")``
  onto spread addresses against ``searchsorted``, ``scatter_reduce_``
  onto one address against ``min``, and a copy of every row to the host
  (pageable memory); then both sorts at 9,437,184,
  47,185,920 and 165,150,720 rows.
* ``sortceiling`` (``microbench_sortceiling.py``): ``torch.sort`` of one
  word and ``keys.sort`` of two, 2^20 rows up to 165,150,720, and two words
  at 308,743,680 rows (SPEC config 5's arena group), each against the bytes
  of an LSD radix sort: 8 passes of 8 bits a 64-bit word, each pass
  reading and writing the key and its int64 index (32 bytes a row).
* ``sortshape`` (``microbench_sortshape.py``): one flat sort of 165,150,720
  rows against [B, M] sorts along rows at the same padded volume.
* ``topk`` (``microbench_topk.py``): a drain's run-start compaction, 2.8% of
  165,150,720 rows, kept up to 2^23: ``torch.nonzero`` (the port's), a
  composite-key sort (the reference's) and ``torch.topk``.
* ``drain`` (``microbench_drain.py``, ``microbench_drain5.py``):
  ``oneshot_count``'s parts (sort, validity count, ``key_ne``, ``nonzero``,
  the capacity gathers) and the whole, at SPEC config 2's one-shot buffer
  (165,150,720 one-word rows, k = 31, capacity 2^23) and at config 5's
  group (308,743,680 two-word rows, k = 41, capacity 120,000,000).
* ``walkstride`` (``microbench_walkstride.py``): on config 2's graph
  (``bench_tour``'s input), ``cycle_min_ruling_tables`` and
  ``rank_chains_with_cut`` at the reference's seven (``RULER_STRIDE``,
  ``WALK_CAP``) pairs, with each pair's kernel launches from one walk under
  ``torch.profiler`` on the card (not with ``--quick``). Each row names its
  route: ``kernel`` (the walk and jump kernels, on the card) or ``plain``
  (their plain PyTorch versions, on the CPU); on the card the plain route
  is timed at the reference's pair too (``plain_route``).
* ``cuttables``: the cut list's first-cut tables (``ranking._cut_tables``),
  the two scatter minima onto one spare slot (``cut_tables_plain``) against
  the kernel (``cut_tables``), on the cycle walk's own flags and owner
  words at config 2's graph (E = 9,961,472) and on flags shaped like them
  at 2^27 edges (on the card also each call's device time under
  ``torch.profiler``, without the host's launch overhead); then, on that
  walk, the index puts that still send every dead lane to one spare slot
  (``_pick_rulers``' and ``_chains_from_rank``'s has-predecessor bits,
  ``_chains_from_rank``'s chain lengths) against the same writes through a
  compacted index (``torch.nonzero``, which reads its count on the host).

Before it is timed, every candidate is held bit-equal to the function it
stands for on the section's inputs (sorts against numpy on a slice, the
segment sums, first rows and compactions against the port's own routes,
the drain's parts against ``oneshot_count``, every walk pair's cut
successors, ranks and end edges against the first pair's, whole arrays);
a mismatch raises. Times: a warm-up, then the median of 5 calls with the
least and the most, by CUDA events on the card and by the host
clock on the CPU (a walk: host clock between device syncs). Each row gives
the bytes the operation must move (each input read once, each output
written once) and, on the card, that many bytes' share of 3.35 TB/s at the
measured time; sweep rows give none. ``--quick`` runs every section at a
small size and one walk pair. It prints one JSON line a row and a summary
line (rows a section, checks passed, each section's peak device memory),
and writes them all to ``--out``. It runs on the card unless ``--device
cpu`` is given, and fails where there is no CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from tpu_euler_torch.euler import ranking, ranking_kernel
from tpu_euler_torch.kmer import keys
from tpu_euler_torch.kmer.count import oneshot_count, sorted_segments

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
RADIX_PASSES_A_WORD = 8  # 8-bit digits over a 64-bit key
RADIX_PASS_BYTES_A_ROW = 32  # read and write an int64 key and its int64 index

OPS_ROWS = 13_107_200  # the reference's op table: 2^18 x 50 rows
SORT_SIZES = (9_437_184, 47_185_920, 165_150_720)
CEILING_SIZES = (1 << 20, 1 << 22, 1 << 24, 1 << 26, 165_150_720)
CONFIG2_ROWS = 165_150_720  # 9 batches x 2^18 reads x 70 windows
CONFIG2_VALID = 161_000_000  # 2.3 M reads x 70 windows
CONFIG2_DISTINCT = 4_600_000
CONFIG2_CAPACITY = 1 << 23
CONFIG5_CAPACITY = 120_000_000
CONFIG5_ROWS = CONFIG5_CAPACITY + 12 * (1 << 18) * 60  # the arena: C + T
CONFIG5_DISTINCT = 84_000_000  # microbench_drain5.py's
SHAPES_B = (64, 256, 1024, 4096)
START_SHARE = 0.028  # run starts among a one-shot buffer's rows
COMPACT_CAP = 1 << 23
PAIRS = ((64, 128), (32, 128), (32, 64), (16, 64), (16, 32), (8, 32), (64, 64))
WALK_BP = 4_600_000
QUICK_ROWS = 1 << 14
QUICK_WALK_BP = 20_000
CUT_ROWS = 1 << 27  # the cut tables on flags shaped like a walk's, beside config 2's own
CUT_FLAGS = 16  # cut lanes among those rows (one or two a cycle)
REPS = 5  # timed calls a row, after a warm-up
SEED = 2026


class MismatchError(AssertionError):
    """A candidate differs from the function it stands for."""


class Bench:
    """One run's device, repeats and size, and its checks."""

    def __init__(self, device="cuda", quick: bool = False):
        self.dev = torch.device("cuda:0" if device == "cuda" else device)
        self.on_card = self.dev.type == "cuda"
        if self.on_card:
            torch.cuda.init()  # the allocator's peak counters exist only after it
        self.quick = quick
        self.checks = 0

    def gen(self, salt: int) -> torch.Generator:
        return torch.Generator(device=self.dev).manual_seed(SEED * 1000 + salt)

    def randint(self, hi: int, shape, salt: int, lo: int = 0) -> torch.Tensor:
        return torch.randint(lo, hi, shape, generator=self.gen(salt), device=self.dev, dtype=torch.int64)

    def sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.dev)

    def check(self, ok, what: str) -> None:
        if not bool(ok):
            raise MismatchError(what)
        self.checks += 1

    def time(self, fn) -> dict:
        """Warm-up, then ``REPS`` calls: median, least and most ms."""
        fn()
        self.sync()
        ts = []
        for _ in range(REPS):
            if self.on_card:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                ts.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                fn()
                ts.append((time.perf_counter() - t0) * 1e3)
        return {"ms": statistics.median(ts), "ms_min": min(ts), "ms_max": max(ts), "reps": REPS}

    def row(self, section: str, name: str, fn, rows: int, n_bytes: int, hbm: bool = True, **extra) -> dict:
        """A timed row; ``hbm`` False for bytes that cross the host link,
        not the card's memory."""
        r = {"section": section, "name": name, "rows": rows, **extra, **self.time(fn), "bytes": n_bytes}
        # a share of the card's memory rate only where the card was timed
        r["hbm_share"] = n_bytes / (r["ms"] / 1e3) / HBM_BYTES_PER_S if self.on_card and hbm else None
        return r


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _sorted_like_numpy(b: Bench, what: str, w: torch.Tensor, s: torch.Tensor, perm: torch.Tensor) -> None:
    """(s, perm) is the stable sort of keys ``w`` ([n] or [n, W])."""
    a = _np(w)
    order = np.argsort(a, kind="stable") if a.ndim == 1 else np.lexsort(a.T[::-1])
    b.check(np.array_equal(_np(perm), order) and np.array_equal(_np(s), a[order]), what)


def _one_word_sort(key, payload):
    s, p = torch.sort(key, stable=True)
    return s, payload[p]


def _segment_sum_index_add(s, w):
    """Sums of ``w`` over runs of equal sorted keys by run id and
    ``index_add_``."""
    is_new = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
    is_new[1:] = s[1:] != s[:-1]
    seg = torch.cumsum(is_new, 0) - 1
    n = int(seg[-1]) + 1
    return torch.zeros(n, dtype=torch.int64, device=s.device).index_add_(0, seg, w)


def _first_by_amin(node, n_slots: int):
    """First row of each value of sorted ``node`` (``n_slots`` = none), as
    ``euler/tour.py`` ``_group_starts`` finds it."""
    first = torch.full((n_slots,), node.shape[0], dtype=torch.int64, device=node.device)
    return first.scatter_reduce_(0, node, torch.arange(node.shape[0], device=node.device), "amin")


def _first_by_searchsorted(node, n_slots: int):
    v = torch.arange(n_slots, device=node.device)
    pos = torch.searchsorted(node, v)
    hit = node[torch.clamp(pos, max=node.shape[0] - 1)] == v
    return torch.where(hit & (pos < node.shape[0]), pos, node.shape[0])


def _amin_one_address(x):
    out = torch.full((1,), keys.SENT, dtype=torch.int64, device=x.device)
    return out.scatter_reduce_(0, torch.zeros_like(x), x, "amin")


def _two_word_keys(b: Bench, n: int, salt: int) -> torch.Tensor:
    """[n, 2] keys shaped like k = 41's: 20 bits in word 0, 62 in word 1."""
    return torch.stack([b.randint(1 << 20, (n,), salt), b.randint(1 << 62, (n,), salt + 1)], dim=1)


def _sort_rows(b: Bench, section: str, n: int, salt: int) -> list[dict]:
    """A one-word sort with payload and a two-word ``keys.sort`` at n rows."""
    key, payload = b.randint(1 << 62, (n,), salt), b.randint(1 << 62, (n,), salt + 1)
    w2 = _two_word_keys(b, n, salt + 2)
    m = min(n, 4096)
    _sorted_like_numpy(b, f"torch.sort at {n}", key[:m], *torch.sort(key[:m], stable=True))
    _sorted_like_numpy(b, f"keys.sort at {n}", w2[:m], *keys.sort(w2[:m]))
    s, p = _one_word_sort(key[:m], payload[:m])
    ks, kp = keys.sort(key[:m])
    b.check(torch.equal(s, ks) and torch.equal(p, payload[:m][kp]), "one-word sort with payload == keys.sort + gather")
    return [
        b.row(section, "sort_1word_payload", lambda: _one_word_sort(key, payload), n, 40 * n),
        b.row(section, "keys_sort_2word", lambda: keys.sort(w2), n, 40 * n),
    ]


def section_ops(b: Bench) -> list[dict]:
    N = QUICK_ROWS if b.quick else OPS_ROWS
    rows = _sort_rows(b, "ops", N, 1)
    src, w = b.randint(1 << 62, (N,), 10), b.randint(4, (N,), 11, lo=1)
    idx, perm = b.randint(N, (N,), 12), torch.randperm(N, generator=b.gen(13), device=b.dev)
    m = min(N, 4096)
    b.check(np.array_equal(_np(torch.cumsum(w[:m], 0)), np.cumsum(_np(w[:m]))), "cumsum")
    b.check(np.array_equal(_np(src[idx[:m]]), _np(src)[_np(idx[:m])]), "gather")

    def scatter_set():
        out = torch.empty_like(src)
        out[perm] = src
        return out

    got = np.empty(N, dtype=np.int64)
    got[_np(perm)] = _np(src)
    b.check(np.array_equal(_np(scatter_set()), got), "scatter set")

    # runs of equal sorted keys: 2.8% of the rows start one, as in a drain
    pool = b.randint(1 << 62, (max(1, int(N * START_SHARE)),), 14)
    s = torch.sort(pool[b.randint(pool.shape[0], (N,), 15)]).values
    b.check(torch.equal(_segment_sum_index_add(s, w), sorted_segments(s, w.clone())[1]),
            "segment sum: index_add_ == sorted_segments")
    n_seg = int(sorted_segments(s, w.clone())[0].numel())
    # sorted node ids spread over as many slots as rows, as the tour's
    node = torch.sort(b.randint(N, (N,), 16)).values
    b.check(torch.equal(_first_by_amin(node, N), _first_by_searchsorted(node, N)),
            "group start: scatter_reduce_ amin == searchsorted")
    b.check(int(_amin_one_address(src)[0]) == int(src.min()), "amin onto one address == min")
    rows += [
        b.row("ops", "cumsum", lambda: torch.cumsum(w, 0), N, 16 * N),
        b.row("ops", "gather_random", lambda: src[idx], N, 24 * N),
        b.row("ops", "scatter_set", scatter_set, N, 24 * N),
        b.row("ops", "segment_sum_index_add", lambda: _segment_sum_index_add(s, w), N, 16 * N + 8 * n_seg,
              segments=n_seg),
        b.row("ops", "segment_sum_sorted_segments", lambda: sorted_segments(s, w), N, 16 * N + 16 * n_seg,
              segments=n_seg),
        b.row("ops", "group_start_scatter_amin", lambda: _first_by_amin(node, N), N, 24 * N),
        b.row("ops", "group_start_searchsorted", lambda: _first_by_searchsorted(node, N), N, 24 * N),
        b.row("ops", "scatter_amin_one_address", lambda: _amin_one_address(src), N, 16 * N),
        b.row("ops", "min_reduction", lambda: src.min(), N, 8 * N),
        # what a transfer of every row costs against the ops above
        b.row("ops", "copy_to_host", lambda: src.to("cpu"), N, 8 * N, hbm=False),
    ]
    del src, w, idx, perm, pool, s, node
    for n in (QUICK_ROWS // 2,) if b.quick else SORT_SIZES:
        rows += _sort_rows(b, "ops", n, 100 + n % 97)
    return rows


def _ceiling_row(b: Bench, name: str, fn, n: int, words: int) -> dict:
    passes = RADIX_PASSES_A_WORD * words
    pass_bytes = RADIX_PASS_BYTES_A_ROW * n
    r = b.row("sortceiling", name, fn, n, (16 * words + 8) * n, words=words,
              radix_passes_assumed=passes, radix_pass_bytes=pass_bytes)
    r["ns_per_row"] = r["ms"] * 1e6 / n
    if b.on_card:
        bound_ms = passes * pass_bytes / HBM_BYTES_PER_S * 1e3
        r.update(radix_bound_ms=bound_ms, radix_bound_share=bound_ms / r["ms"],
                 implied_passes=r["ms"] / 1e3 * HBM_BYTES_PER_S / pass_bytes)
    return r


def section_sortceiling(b: Bench) -> list[dict]:
    rows = []
    sizes = (QUICK_ROWS,) if b.quick else CEILING_SIZES
    for n in sizes:
        key, w2 = b.randint(1 << 62, (n,), 20), _two_word_keys(b, n, 21)
        m = min(n, 4096)
        _sorted_like_numpy(b, f"torch.sort at {n}", key[:m], *torch.sort(key[:m], stable=True))
        _sorted_like_numpy(b, f"keys.sort at {n}", w2[:m], *keys.sort(w2[:m]))
        rows.append(_ceiling_row(b, "torch_sort_1word", lambda: torch.sort(key, stable=True), n, 1))
        rows.append(_ceiling_row(b, "keys_sort_2word", lambda: keys.sort(w2), n, 2))
        del key, w2
    n = 2 * QUICK_ROWS if b.quick else CONFIG5_ROWS
    keys.check_sort_rows(n, "config 5's arena group")
    w2 = _two_word_keys(b, n, 22)
    _sorted_like_numpy(b, f"keys.sort at {n}", w2[:4096], *keys.sort(w2[:4096]))
    rows.append(_ceiling_row(b, "keys_sort_2word_config5_group", lambda: keys.sort(w2), n, 2))
    return rows


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def section_sortshape(b: Bench) -> list[dict]:
    N = QUICK_ROWS if b.quick else CONFIG2_ROWS
    key = b.randint(1 << 62, (N,), 30)
    rows = [b.row("sortshape", "flat", lambda: torch.sort(key, stable=True), N, 24 * N)]
    for B in SHAPES_B[:1] if b.quick else SHAPES_B:
        M = _ceil_to(-(-N // B), 512)
        xb = torch.cat([key, key[: B * M - N]]).view(B, M)
        s, p = torch.sort(xb, dim=1, stable=True)
        s0, p0 = torch.sort(xb[0], stable=True)
        b.check(torch.equal(s[0], s0) and torch.equal(p[0], p0), f"[{B}, {M}] sort: row 0 == its flat sort")
        del s, p, s0, p0
        rows.append(b.row("sortshape", f"batched_{B}", lambda: torch.sort(xb, dim=1, stable=True), B * M,
                          24 * B * M, batch=B, row_len=M))
        del xb
    return rows


def _starts_by_nonzero(is_new, cap: int):
    return torch.nonzero(is_new).squeeze(1)[:cap]


def _composite(is_new):
    iota = torch.arange(is_new.shape[0], device=is_new.device)
    return torch.where(is_new, iota, iota + is_new.shape[0])


def _starts_by_sort(is_new, cap: int):
    return torch.sort(_composite(is_new)).values[:cap]


def _starts_by_topk(is_new, cap: int):
    return torch.topk(_composite(is_new), cap, largest=False, sorted=True).values


def section_topk(b: Bench) -> list[dict]:
    T = QUICK_ROWS if b.quick else CONFIG2_ROWS
    cap = QUICK_ROWS // 16 if b.quick else COMPACT_CAP
    is_new = torch.rand(T, generator=b.gen(40), device=b.dev) < START_SHARE
    nz = _starts_by_nonzero(is_new, cap)
    n = nz.shape[0]
    for name, fn in (("composite sort", _starts_by_sort), ("topk", _starts_by_topk)):
        got = fn(is_new, cap)
        b.check(torch.equal(got[:n], nz) and bool((got[n:] >= T).all()), f"run starts: {name} == nonzero")
    return [
        b.row("topk", "nonzero", lambda: _starts_by_nonzero(is_new, cap), T, T + 8 * n, starts=n, cap=cap),
        b.row("topk", "composite_sort", lambda: _starts_by_sort(is_new, cap), T, T + 8 * cap, starts=n, cap=cap),
        b.row("topk", "topk", lambda: _starts_by_topk(is_new, cap), T, T + 8 * cap, starts=n, cap=cap),
    ]


def _is_new(s, n_valid: int):
    is_new = torch.ones(n_valid, dtype=torch.bool, device=s.device)
    is_new[1:] = keys.key_ne(s[1 : n_valid], s[: n_valid - 1])
    return is_new


def _capacity_gathers(s, starts, n_valid: int, capacity: int):
    n = starts.numel()
    m = min(n, capacity)
    bounds = torch.cat([starts, starts.new_tensor([n_valid])])
    words = s.new_zeros((capacity,) + tuple(s.shape[1:]))
    counts = torch.zeros(capacity, dtype=torch.int32, device=s.device)
    words[:m] = s[starts[:m]]
    counts[:m] = (bounds[1 : m + 1] - bounds[:m]).to(torch.int32)
    return words, counts, m, n > capacity


def _drain_rows(b: Bench, shape: str, rows: int, n_valid: int, distinct: int, capacity: int, words: int):
    """``oneshot_count``'s parts, each on the previous part's output, and
    the whole, on ``rows`` keys drawn from ``distinct`` ones (the first
    ``n_valid`` rows valid, the rest ``keys.SENT``)."""
    salt = 50 + words
    pool = b.randint(1 << 62, (distinct,), salt) if words == 1 else _two_word_keys(b, distinct, salt)
    buf = pool[b.randint(distinct, (rows,), salt + 5)]
    del pool
    buf[n_valid:] = keys.SENT
    s = keys.sort(buf)[0]
    nv = int(keys.is_valid(s).sum())
    is_new = _is_new(s, nv)
    starts = torch.nonzero(is_new).squeeze(1)
    parts = _capacity_gathers(s, starts, nv, capacity)
    whole = oneshot_count(buf, capacity)
    b.check(nv == n_valid, f"{shape}: valid rows")
    b.check(torch.equal(parts[0], whole[0].words) and torch.equal(parts[1], whole[0].counts)
            and parts[2:] == (whole[0].n, whole[1]), f"{shape}: the parts == oneshot_count")
    del parts, whole
    n = starts.numel()
    W = 8 * words
    extra = {"shape": shape, "words": words, "capacity": capacity, "valid": nv, "distinct_found": n}
    out = [
        b.row("drain", "sort", lambda: keys.sort(buf), rows, (2 * W + 8) * rows, **extra),
        b.row("drain", "valid_count", lambda: int(keys.is_valid(s).sum()), rows, 8 * rows, **extra),
        b.row("drain", "key_ne", lambda: _is_new(s, nv), rows, W * nv + nv, **extra),
        b.row("drain", "nonzero", lambda: torch.nonzero(is_new).squeeze(1), rows, nv + 8 * n, **extra),
        b.row("drain", "capacity_gathers", lambda: _capacity_gathers(s, starts, nv, capacity), rows,
              n * (8 + 2 * W + 4) + capacity * (W + 4), **extra),
    ]
    del is_new, s, starts
    whole_row = b.row("drain", "oneshot_count", lambda: oneshot_count(buf, capacity), rows,
                      W * rows + capacity * (W + 4), **extra)
    parts_ms = sum(r["ms"] for r in out)
    whole_row.update(parts_sum_ms=parts_ms, parts_share=parts_ms / whole_row["ms"])
    return out + [whole_row]


def section_drain(b: Bench) -> list[dict]:
    if b.quick:  # the same proportions at a few thousand rows
        q = QUICK_ROWS
        c2 = (q, q * 31 // 32, q // 36, q // 16)
        m, d, c = 2 * q, 2 * q * 84 // 309, 2 * q * 120 // 309
    else:
        c2 = (CONFIG2_ROWS, CONFIG2_VALID, CONFIG2_DISTINCT, CONFIG2_CAPACITY)
        m, d, c = CONFIG5_ROWS, CONFIG5_DISTINCT, CONFIG5_CAPACITY
    # the arena: its head holds the distinct keys and sentinels up to C
    c5 = (m, m - (c - d), d, c)
    rows = _drain_rows(b, "config 2 one-shot buffer, k = 31", *c2, words=1)
    gc.collect()
    if b.on_card:
        torch.cuda.empty_cache()
    return rows + _drain_rows(b, "config 5 arena group, k = 41", *c5, words=2)


@contextlib.contextmanager
def walk_constants(stride: int, cap: int):
    """Within the block, the ruling walk samples a ruler every ``stride``
    elements and walks at most ``cap`` hops a round; the module's values
    come back however the block ends."""
    if not 1 <= cap <= 255:
        raise ValueError(f"WALK_CAP {cap}: a hop's offset has 8 bits of the owner word (gid << 8 | step)")
    if stride < 1:
        raise ValueError(f"RULER_STRIDE {stride} < 1")
    saved = ranking.RULER_STRIDE, ranking.WALK_CAP
    ranking.RULER_STRIDE, ranking.WALK_CAP = stride, cap
    try:
        yield
    finally:
        ranking.RULER_STRIDE, ranking.WALK_CAP = saved


@contextlib.contextmanager
def plain_route():
    """Within the block, the walk's rounds, the pointer jumps and the tour's
    labels run their plain PyTorch versions on every device (the kernels'
    yardstick on the card); the kernel wrappers come back however the block
    ends."""
    names = ("walk_round", "jump_min", "jump_rank", "jump_labels", "ruling_labels", "cut_tables")
    saved = {name: getattr(ranking_kernel, name) for name in names}
    for name in names:
        setattr(ranking_kernel, name, getattr(ranking_kernel, name + "_plain"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ranking_kernel, name, fn)


@contextlib.contextmanager
def held_rounds():
    """Within the block, every walk round runs through ``walk_round`` and,
    from copies of the same state, through ``walk_round_plain`` (owner
    words, succ2 after the patch, the tables, the continuations and their
    count), every pointer jump through ``jump_min`` / ``jump_rank`` and
    through the plain rounds (the final state), the tour's labels through
    ``jump_labels`` / ``ruling_labels`` and ``jump_labels_plain`` (at the
    same rounds), and the cut tables through ``cut_tables`` and
    ``cut_tables_plain``; a difference raises ``MismatchError``. Yields the
    counts of walk rounds, jumps, label calls and cut tables held."""
    held = {"walk_rounds": 0, "jumps": 0, "labels": 0, "cut_tables": 0}
    names = ("walk_round", "jump_min", "jump_rank", "jump_labels", "ruling_labels", "cut_tables")
    saved = {name: getattr(ranking_kernel, name) for name in names}

    def walk_round(succ2, t, frontier, base, owner_off, walk_cap, tabs):
        s2, oo, tb = succ2.clone(), owner_off.clone(), {k: v.clone() for k, v in tabs.items()}
        got = saved["walk_round"](succ2, t, frontier, base, owner_off, walk_cap, tabs)
        t_plain = None if t is None else t.contiguous()  # the record's t, as an array beside the copy of succ2
        want = ranking_kernel.walk_round_plain(s2, t_plain, frontier, base, oo, walk_cap, tb)
        n = succ2.shape[0] - 1  # the spare slot at n holds whatever a dropped scatter wrote
        if not (torch.equal(owner_off[:n], oo[:n]) and torch.equal(succ2, s2) and got[1] == want[1]
                and torch.equal(got[0], want[0]) and all(torch.equal(tabs[k], tb[k]) for k in tabs)):
            raise MismatchError(f"walk round at gid {base}: the kernel's state != the plain version's")
        held["walk_rounds"] += 1
        return got

    def held_jump(name, plain, count="jumps"):
        def jump(*state_and_rounds):
            *state, rounds = state_and_rounds
            got = saved[name](*state, rounds)
            want = plain(*state, rounds)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise MismatchError(f"{name} over {rounds} rounds: the kernel's state != the plain version's")
            held[count] += 1
            return got

        return jump

    def cut_tables(is_cut, owner_off, S):
        got = saved["cut_tables"](is_cut, owner_off, S)
        if not all(torch.equal(a, b) for a, b in zip(got, ranking_kernel.cut_tables_plain(is_cut, owner_off, S))):
            raise MismatchError(f"cut_tables over {is_cut.shape[0]} edges: the kernel's tables != the plain version's")
        held["cut_tables"] += 1
        return got

    ranking_kernel.walk_round = walk_round
    ranking_kernel.cut_tables = cut_tables
    ranking_kernel.jump_min = held_jump("jump_min", ranking_kernel.jump_min_plain)
    ranking_kernel.jump_rank = held_jump("jump_rank", ranking_kernel.jump_rank_plain)
    ranking_kernel.jump_labels = held_jump("jump_labels", ranking_kernel.jump_labels_plain, "labels")
    ranking_kernel.ruling_labels = held_jump("ruling_labels", ranking_kernel.ruling_labels_plain, "labels")
    try:
        yield held
    finally:
        for name, fn in saved.items():
            setattr(ranking_kernel, name, fn)


def walk_inputs(b: Bench, bp: int):
    """(succ, edge_valid, transition keys) of ``bench_tour``'s graph."""
    from tpu_euler_torch.bench_tour import tour_graph, tour_inputs
    from tpu_euler_torch.euler.unitigs import successor, transition_keys

    codes, cfg = tour_inputs(bp)
    g = tour_graph(codes, cfg, b.dev)
    succ0 = successor(g)
    return succ0, g.edge_valid, transition_keys(g, succ0, cfg.k)


def walk_once(b: Bench, succ0, valid, t):
    """(cycle s, rank s, (cut successors, distance to chain end, end edge))."""
    from tpu_euler_torch.euler.unitigs import _apply_cut

    b.sync()
    t0 = time.perf_counter()
    res = ranking.cycle_min_ruling_tables(succ0, valid, t)
    b.sync()
    t_cycle = time.perf_counter() - t0
    if res is None:
        raise RuntimeError("cycle_min_ruling_tables overflowed its gids")
    on_cycle, cyc_min, owner_off, tabs, succ_c = res
    succ, is_cut = _apply_cut(succ0, t, on_cycle, cyc_min)
    b.sync()
    t0 = time.perf_counter()
    rr = ranking.rank_chains_with_cut(succ, valid, is_cut, owner_off, tabs, succ_c)
    b.sync()
    t_rank = time.perf_counter() - t0
    if rr is None:
        raise RuntimeError("rank_chains_with_cut broke an invariant")
    return t_cycle, t_rank, (succ, *rr)


def walk_sweep(b: Bench, inputs, pairs=PAIRS, plain: bool = False, first=None):
    """A row a (stride, cap) pair, each naming its route: ``kernel`` on the
    card, ``plain`` on the CPU or with ``plain`` (``plain_route``, rows
    named ``..._plain`` on the card). Every pair's arrays must equal
    ``first``'s, or the first pair's. Returns (rows, the first arrays)."""
    from tpu_euler_torch.profile_config2 import device_profile

    route = "kernel" if b.on_card and not plain else "plain"
    rows = []
    for stride, cap in pairs:
        with walk_constants(stride, cap), plain_route() if plain else contextlib.nullcontext():
            walk_once(b, *inputs)
            runs = [walk_once(b, *inputs) for _ in range(REPS)]
            profiled = b.on_card and not b.quick
            launches = device_profile(lambda: walk_once(b, *inputs))["kernel_launches"] if profiled else None
        got = runs[0][2]
        if first is None:
            first = got
        b.check(all(torch.equal(x, y) for x, y in zip(got, first)),
                f"walk ({stride}, {cap}): cut successors, ranks and end edges == ({pairs[0][0]}, {pairs[0][1]})'s")
        cyc, rank = [r[0] for r in runs], [r[1] for r in runs]
        tot = [x + y for x, y in zip(cyc, rank)]
        rows.append({
            "section": "walkstride", "name": f"stride_{stride}_cap_{cap}" + ("_plain" if plain and b.on_card else ""),
            "route": route, "rows": int(inputs[0].shape[0]), "stride": stride, "walk_cap": cap,
            "cycle_s": statistics.median(cyc), "rank_s": statistics.median(rank),
            "total_s": statistics.median(tot), "total_spread_s": [min(tot), max(tot)], "reps": REPS,
            "launches": launches, "edges": int(inputs[1].sum()), "equal_to_first": True,
        })
    return rows, first


def section_walkstride(b: Bench) -> list[dict]:
    """The sweep through the kernels, and on the card the plain route at
    the reference's pair beside it."""
    inputs = walk_inputs(b, QUICK_WALK_BP if b.quick else WALK_BP)
    rows, first = walk_sweep(b, inputs, PAIRS[:1] if b.quick else PAIRS)
    if b.on_card:
        rows += walk_sweep(b, inputs, PAIRS[:1], plain=True, first=first)[0]
    return rows


def cut_table_bytes(E: int, cuts: int, S: int) -> int:
    """What the cut tables must move: the E flags, a cut lane's owner word,
    and 8 bytes a slot to start the table and 16 to unpack it."""
    return E + 8 * cuts + 24 * S


def walk_state(b: Bench, bp: int) -> dict:
    """A cycle walk of ``bench_tour``'s graph at ``bp`` and its cut list's
    rank: what ``chains_from_t`` holds when it calls the cut tables and
    ``_chains_from_rank``."""
    from tpu_euler_torch.euler.unitigs import _apply_cut

    succ0, valid, t = walk_inputs(b, bp)
    res = ranking.cycle_min_ruling_tables(succ0, valid, t)
    if res is None:
        raise RuntimeError("cycle_min_ruling_tables overflowed its gids")
    on_cycle, cyc_min, owner_off, tabs, succ_c = res
    succ, is_cut = _apply_cut(succ0, t, on_cycle, cyc_min)
    rr = ranking.rank_chains_with_cut(succ, valid, is_cut, owner_off, tabs, succ_c)
    if rr is None:
        raise RuntimeError("rank_chains_with_cut broke an invariant")
    return {"succ0": succ0, "valid": valid, "t": t, "succ": succ, "is_cut": is_cut, "owner_off": owner_off,
            "S": succ_c.shape[0], "d": rr[0], "end_edge": rr[1]}


def cut_inputs(b: Bench, n: int, salt: int) -> tuple:
    """(is_cut, owner_off, S) shaped like a cycle walk's over n edges: a
    ruler gid and an offset a lane over a table of S = the walk's rows, a
    lane in 64 uncovered, ``CUT_FLAGS`` cut lanes."""
    S = ranking._pow2(2 * max(1, n // ranking.RULER_STRIDE))
    owner = (b.randint(S // 2, (n,), salt) << 8) | b.randint(ranking.WALK_CAP, (n,), salt + 1)
    owner[b.randint(n, (max(1, n // 64),), salt + 2)] = -1
    is_cut = torch.zeros(n, dtype=torch.bool, device=b.dev)
    is_cut[b.randint(n, (CUT_FLAGS,), salt + 3)] = True
    return is_cut, owner, S


def _cut_rows(b: Bench, shape: str, is_cut, owner_off, S: int) -> list[dict]:
    E = is_cut.shape[0]
    cuts = int((is_cut & (owner_off >= 0)).sum())
    want = ranking_kernel.cut_tables_plain(is_cut, owner_off, S)
    got = ranking_kernel.cut_tables(is_cut, owner_off, S)
    b.check(all(torch.equal(x, y) for x, y in zip(got, want)), f"cut tables at {shape}: cut_tables == cut_tables_plain")
    n_bytes = cut_table_bytes(E, cuts, S)
    extra = {"shape": shape, "gids": S, "cuts": cuts}
    rows = []
    for name in ("cut_tables_plain", "cut_tables"):
        fn = getattr(ranking_kernel, name)
        r = b.row("cuttables", name, lambda: fn(is_cut, owner_off, S), E, n_bytes, **extra)
        if b.on_card and not b.quick:  # the card's own time, without the host's launch overhead
            from tpu_euler_torch.profile_config2 import device_profile

            r["device_ms"] = device_profile(lambda: fn(is_cut, owner_off, S))["device_busy_union_s"] * 1e3
            r["device_hbm_share"] = n_bytes / (r["device_ms"] / 1e3) / HBM_BYTES_PER_S
        rows.append(r)
    return rows


def _has_pred_spare(succ):
    E = succ.shape[0]
    has_pred = torch.zeros(E + 1, dtype=torch.bool, device=succ.device)
    has_pred[torch.where(succ >= 0, succ, E)] = True
    return has_pred


def _has_pred_compact(succ):
    has_pred = torch.zeros(succ.shape[0] + 1, dtype=torch.bool, device=succ.device)
    has_pred[succ[torch.nonzero(succ >= 0).squeeze(1)]] = True
    return has_pred


def _len_at_end_spare(is_start, end_edge, d):
    E = is_start.shape[0]
    len_at_end = torch.zeros(E + 1, dtype=torch.int64, device=d.device)
    len_at_end[torch.where(is_start, end_edge, E)] = d + 1
    return len_at_end


def _len_at_end_compact(is_start, end_edge, d):
    len_at_end = torch.zeros(is_start.shape[0] + 1, dtype=torch.int64, device=d.device)
    idx = torch.nonzero(is_start).squeeze(1)
    len_at_end[end_edge[idx]] = d[idx] + 1
    return len_at_end


def section_cuttables(b: Bench) -> list[dict]:
    """The cut tables at config 2's walk and at ``CUT_ROWS`` shaped like
    it; the dead-lane index puts of the walk's path at config 2's walk."""
    w = walk_state(b, QUICK_WALK_BP if b.quick else WALK_BP)
    E = w["succ"].shape[0]
    rows = _cut_rows(b, "config 2's cycle walk", w["is_cut"], w["owner_off"], w["S"])
    rows += _cut_rows(b, "a walk's shape", *cut_inputs(b, QUICK_ROWS + 3 if b.quick else CUT_ROWS, 70))
    gc.collect()
    is_start = w["valid"] & ~_has_pred_spare(w["succ"])[:E]
    puts = (
        ("has_pred_pick_rulers", (w["succ0"],), _has_pred_spare, _has_pred_compact, 9 * E + 1,
         int((w["succ0"] < 0).sum())),
        ("has_pred_chains_from_rank", (w["succ"],), _has_pred_spare, _has_pred_compact, 9 * E + 1,
         int((w["succ"] < 0).sum())),
        ("len_at_end_chains_from_rank", (is_start, w["end_edge"], w["d"]), _len_at_end_spare, _len_at_end_compact,
         E + 16 * int(is_start.sum()) + 8 * (E + 1), int((~is_start).sum())),
    )
    for name, args, spare, compact, n_bytes, dead in puts:
        b.check(torch.equal(spare(*args)[:E], compact(*args)[:E]), f"{name}: the compacted write == the spare slot's")
        extra = {"shape": "config 2's cycle walk", "dead_lanes": dead}
        rows += [
            b.row("cuttables", f"{name}_spare_slot", lambda: spare(*args), E, n_bytes, **extra),
            b.row("cuttables", f"{name}_compacted", lambda: compact(*args), E, n_bytes, **extra),
        ]
    return rows


SECTIONS = {
    "ops": section_ops,
    "sortceiling": section_sortceiling,
    "sortshape": section_sortshape,
    "topk": section_topk,
    "drain": section_drain,
    "walkstride": section_walkstride,
    "cuttables": section_cuttables,
}


def run(sections=tuple(SECTIONS), quick: bool = False, device="cuda", emit=print) -> dict:
    """Every named section in turn; returns {"rows", "summary"}."""
    from tpu_euler_torch.profile_config2 import card_line

    b = Bench(device, quick)
    t_start = time.perf_counter()
    rows, per_section = [], {}
    for name in sections:
        if b.on_card:
            torch.cuda.reset_peak_memory_stats(b.dev)
        t0 = time.perf_counter()
        got = SECTIONS[name](b)
        for r in got:
            r["device"] = b.dev.type
            emit(json.dumps(r))
        per_section[name] = {
            "rows": len(got), "wall_s": time.perf_counter() - t0,
            "peak_gib": torch.cuda.max_memory_allocated(b.dev) / 2**30 if b.on_card else None,
        }
        rows += got
        gc.collect()
        if b.on_card:
            torch.cuda.empty_cache()
    summary = {
        "summary": "microbench", "quick": quick, "reps": REPS, "checks_passed": b.checks,
        "sections": per_section, "wall_s": time.perf_counter() - t_start,
        "device": torch.cuda.get_device_name(b.dev) if b.on_card else "cpu",
        "card": card_line() if b.on_card else "cpu", "torch": torch.__version__,
    }
    emit(json.dumps(summary))
    return {"rows": rows, "summary": summary}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--section", action="append", choices=tuple(SECTIONS), help="a section to run (default: all)")
    ap.add_argument("--quick", action="store_true", help="every section at a small size, one walk pair")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default="", help="write every row and the summary here")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("microbench: no CUDA device (--device cpu runs on the CPU)")
    rec = run(args.section or tuple(SECTIONS), args.quick, args.device)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
