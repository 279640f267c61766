"""End-to-end single-device assembly pipeline.

Counterpart of ``tpu_euler/pipeline/assemble.py``: reads -> int8 codes ->
per batch, a 2.25-bit pack on the host, from which the fused extract
kernel's packed loader writes canonical window keys -> a
spectrum by one of three counting routes -> right-size + cutoff (-> tip
clipping and bubble popping, ``euler/clean.py``) -> staged graph -> unitig
chains -> device emission -> canonical contigs.

Counting routes (``count_spectrum``), as the reference picks them:

* one-shot, when the run's window rows fit ``oneshot_rows``: every batch's
  keys go into one buffer that is sorted once;
* grouped, beyond that (SPEC configs 4 and 5): groups of batches fill the
  tail of a persistent arena whose head holds the spectrum so far, and one
  drain per group merges the two (``arena_drain``);
* per batch, at ``oneshot_rows = 0``: each batch's keys are merged into the
  spectrum as they come (``merge_keys``).

The walk always takes the reference's `big` route (its E > 2^26 branch): the
transition keys are handed to it, and it frees them before its cut-rank
phase and recomputes them only for a fallback. The chains are those of the
other route, so the port keeps the one.

The batches come from ``_batch_feed``, the reference's prefetcher: a worker
thread pads and packs batch b + 2 into pinned memory and starts its
host-to-device copy while the main thread launches batch b's kernel.

Stage timers use the reference's keys: ``encode`` (the time the main thread
waits for the prefetcher), ``count`` (kernel launches), ``count_drain`` (the
sorts and reduces, ending in a host read), ``tips`` (cutoff and cleaning
rounds, where asked), ``graph`` and ``extract``; each is the sum of the
spans that ``trace.STAGES`` names for it.
"""

from __future__ import annotations

import dataclasses
import logging
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tpu_euler_torch import trace
from tpu_euler_torch.config import AssemblyConfig
from tpu_euler_torch.euler.clean import clip_tips, pop_bubbles
from tpu_euler_torch.euler.extract import chains_to_contigs_device_spec
from tpu_euler_torch.euler.unitigs import chains_from_t, successor, transition_keys_spec
from tpu_euler_torch.graph.build import build_graph_staged
from tpu_euler_torch.io.encode import encode_reads, pack_codes
from tpu_euler_torch.kmer import keys
from tpu_euler_torch.kmer.count import (
    Spectrum,
    apply_cutoff,
    empty_spectrum,
    merge_keys,
    oneshot_count,
    sorted_segments,
    spectrum_overflowed,
)
from tpu_euler_torch.kmer.extract_kernel import extract_fill_packed
from tpu_euler_torch.pipeline.checkpoint import save_graph

log = logging.getLogger("tpu_euler_torch")


@dataclasses.dataclass
class AssemblyResult:
    contigs: set[bytes]
    n_distinct_kmers: int
    n_kmers_counted: int
    n_reads: int
    stage_seconds: dict[str, float]
    trace: trace.Trace | None = None  # the assembly's spans and counters

    @property
    def contig_strings(self) -> set[str]:
        return {c.decode() for c in self.contigs}


def _n_batches(codes_all: np.ndarray, cfg: AssemblyConfig) -> int:
    return max(1, -(-codes_all.shape[0] // cfg.read_batch))


def _batch_rows(codes_all: np.ndarray, b: int, cfg: AssemblyConfig) -> np.ndarray:
    return np.asarray(codes_all[b * cfg.read_batch : (b + 1) * cfg.read_batch])


def _stage(codes_all: np.ndarray, b: int, cfg: AssemblyConfig, out: torch.Tensor) -> None:
    """Batch b into the host tensor ``out`` [read_batch, read_len] int8, the
    rows past the last read filled with code 4."""
    batch = _batch_rows(codes_all, b, cfg)
    n = batch.shape[0]
    out[:n].copy_(torch.from_numpy(batch))
    out[n:] = 4


def _pack_batch(batch: np.ndarray, cfg: AssemblyConfig, out=None):
    """A host batch of at most ``read_batch`` reads, padded to the batch
    shape with code 4 and packed at 2.25 bits a base [reference _pack_batch,
    :339]: (packed [read_batch, ceil(L/4)] uint8, nmask [read_batch,
    ceil(L/8)] uint8), nmask None for a full batch without an N, whose map
    is all zero and is neither copied nor read. ``out``: (packed, nmask)
    arrays of those shapes to pack into (the feed's pinned staging memory);
    the pad rows are written there directly, as the pack of a row of code 4
    (packed bytes 0, map bytes 0xFF)."""
    batch = np.asarray(batch)
    n = batch.shape[0]
    if batch.ndim != 2 or batch.shape[1] != cfg.read_len or n > cfg.read_batch:
        raise ValueError(f"a batch of {cfg.read_batch} reads of {cfg.read_len} bases, got {batch.shape}")
    if out is None:
        L = cfg.read_len
        out = (np.empty((cfg.read_batch, -(-L // 4)), np.uint8), np.empty((cfg.read_batch, -(-L // 8)), np.uint8))
    packed, nmask = out
    pack_codes(batch, out=(packed[:n], nmask[:n]))
    packed[n:] = 0
    nmask[n:] = 0xFF
    if n == cfg.read_batch and not nmask.any():
        return packed, None
    return packed, nmask


def _batch_feed(
    codes_all: np.ndarray, cfg: AssemblyConfig, device, depth: int = 2, batches=None, packed: bool = True
):
    """Yield each batch on ``device``, in order, prepared ahead of time
    [reference _batch_feed, :389]. ``batches`` names the batches to yield,
    in that order (the sharded mode feeds a rank every ``world``-th batch);
    one past the last read is all code 4.

    With ``packed`` (every single-device route, as the reference's feed)
    a batch is ``_pack_batch``'s (packed, nmask) as [read_batch, ceil(L/4)]
    and [read_batch, ceil(L/8)] uint8 tensors, nmask None for a full batch
    without an N, for the extract kernel's packed loader. Without it (the
    sharded mode, whose reference ships int8 codes too) a batch is its
    [read_batch, read_len] int8 codes, for the int8 loader.

    One worker thread prepares batch b + depth while the main thread
    launches batch b's device step, so the host's pad, pack and stage time
    and the host-to-device copy overlap device work; one worker keeps the
    batches in order and bounds the memory to the staged batches. A caller
    that does not exhaust the generator must ``close()`` it, which ends the
    worker.

    On a CUDA device the worker packs (or pads) the batch straight into
    pinned staging tensors and starts the copy on a stream of its own (the
    map's only where the batch has one); the feed makes the caller's current
    stream wait for that copy before it yields the batch. The staging and
    device tensors are a ring of depth + 1 slots. A slot's staging tensors
    are written again only after the copy out of them has finished, and its
    device tensors only after the work the caller queued on them: a yielded
    batch is the caller's until it takes the next one. On a CPU device there
    is no pinning and no stream, and the feed yields the host batch. The
    device is the caller's in both cases.

    Spans, in the caller's trace: ``feed: setup``, and a batch's ``feed:
    wait`` on the caller's thread; the worker, handed that trace, records
    its ``feed: pack`` (with the process CPU time) and ``feed: copy issue``.
    """
    tr = trace.current()  # the caller's trace: the worker records into it too

    def fill(b, host):
        """Batch b into the host tensors ``host``; returns them, None in
        place of a map the batch omits."""
        if not packed:
            _stage(codes_all, b, cfg, host[0])
            return host
        _, nmask = _pack_batch(_batch_rows(codes_all, b, cfg), cfg, out=[t.numpy() for t in host])
        return [host[0], None if nmask is None else host[1]]

    def batch_of(tensors):  # what the caller takes
        return tuple(tensors) if packed else tensors[0]

    def prep(i: int):
        b = order[i]
        tr.add("batches")
        if not on_card:
            with tr.span("feed: pack", cpu=True, batch=b):
                host = fill(b, [torch.empty(sh, dtype=dt) for sh, dt in parts])
            return batch_of(host), None
        s = i % n_slots
        copied[s].synchronize()  # the last copy out of these staging tensors
        with tr.span("feed: pack", cpu=True, batch=b):
            used = fill(b, staging[s])
        out = [None if src is None else dst for dst, src in zip(on_device[s], used)]
        nbytes = sum(src.nbytes for src in used if src is not None)
        tr.add("h2d_bytes", nbytes)
        with torch.cuda.device(device), torch.cuda.stream(copy_stream):
            if consumed[s] is not None:  # the last work on these device tensors
                copy_stream.wait_event(consumed[s])
            with tr.span("feed: copy issue", batch=b, bytes=nbytes):
                for dst, src in zip(out, used):
                    if src is not None:
                        dst.copy_(src, non_blocking=True)
            copied[s].record(copy_stream)
        return batch_of(out), copied[s]

    with tr.span("feed: setup"):
        device = torch.device(device)
        order = list(range(_n_batches(codes_all, cfg)) if batches is None else batches)
        n_batches = len(order)
        L = cfg.read_len
        parts = (
            [((cfg.read_batch, -(-L // 4)), torch.uint8), ((cfg.read_batch, -(-L // 8)), torch.uint8)]
            if packed
            else [((cfg.read_batch, L), torch.int8)]
        )
        on_card = device.type == "cuda"
        if on_card:
            n_slots = depth + 1
            copy_stream = torch.cuda.Stream(device)
            staging = [[torch.empty(sh, dtype=dt, pin_memory=True) for sh, dt in parts] for _ in range(n_slots)]
            on_device = [[torch.empty(sh, dtype=dt, device=device) for sh, dt in parts] for _ in range(n_slots)]
            copied = [torch.cuda.Event() for _ in range(n_slots)]
            consumed: list = [None] * n_slots
        elif device.type != "cpu":
            raise ValueError(f"no batch feed for device {device}")
        ex = ThreadPoolExecutor(max_workers=1)
        futs = {i: ex.submit(prep, i) for i in range(min(depth, n_batches))}
    try:
        for i in range(n_batches):
            with tr.span("feed: wait", batch=order[i]):
                if on_card and i:  # the caller took batch i, so it is done queueing work on batch i - 1
                    consumed[(i - 1) % n_slots] = torch.cuda.current_stream(device).record_event()
                if i + depth < n_batches:
                    futs[i + depth] = ex.submit(prep, i + depth)
                batch, ready = futs.pop(i).result()
                if on_card:
                    torch.cuda.current_stream(device).wait_event(ready)
            yield batch
    finally:
        ex.shutdown(wait=True, cancel_futures=True)
        if on_card:
            copy_stream.synchronize()


def _finish(device) -> None:
    """Wait for the device's queued work, so that a span ends on finished
    work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _overflow(cfg: AssemblyConfig) -> RuntimeError:
    return RuntimeError(
        f"spectrum capacity {cfg.spectrum_capacity} overflowed: "
        f"raise AssemblyConfig.spectrum_capacity"
    )


def _fill(feed, cfg, buf, row: int, b: int) -> torch.Tensor:
    """The packed feed's next batch, batch b, into ``buf`` at ``row`` as
    window keys, by the kernel's packed loader; returns its valid count (on
    the device)."""
    packed, nmask = next(feed)  # the wait for the prefetcher: the feed's own span
    with trace.span("count: extract launch", batch=b):
        return extract_fill_packed(packed, nmask, buf, row, cfg.k, cfg.read_len)


def count_spectrum(
    codes_all: np.ndarray, cfg: AssemblyConfig, device, t: dict | None = None
) -> tuple[Spectrum, int]:
    """Count an [R, read_len] int8 code matrix into a Spectrum on ``device``.

    One-shot when the run's window rows fit ``cfg.oneshot_rows``, grouped
    beyond that, per batch at ``oneshot_rows = 0``. The reference also
    counts per batch for k % 16 == 0, where limb 0 has no spare bit for its
    sentinel; for odd k that never holds, and the port's sentinel
    (``keys.SENT``) never equals a key, so ``oneshot_rows`` alone picks the
    route. Returns (spectrum, n_windows_counted); the route adds its stage
    seconds (``encode``, ``count``, ``count_drain``) to ``t``.
    """
    keys.check_k(cfg.k)
    device = torch.device(device)
    total_rows = _n_batches(codes_all, cfg) * cfg.read_batch * cfg.windows_per_read
    if not cfg.oneshot_rows:
        return count_spectrum_per_batch(codes_all, cfg, device, t)
    if total_rows <= cfg.oneshot_rows:
        return count_spectrum_oneshot(codes_all, cfg, device, t)
    return count_spectrum_grouped(codes_all, cfg, device, t)


def count_spectrum_oneshot(codes_all, cfg: AssemblyConfig, device, t: dict | None):
    """Every batch's window keys into one buffer, sorted once (W stable
    passes for W-word keys) [reference count_spectrum_oneshot, :416]."""
    Wb = cfg.read_batch * cfg.windows_per_read
    n_batches = _n_batches(codes_all, cfg)
    T = n_batches * Wb
    keys.check_sort_rows(T, "the one-shot buffer")
    with trace.stage_times(t):
        buf = torch.empty((T,) + keys.word_shape(cfg.k), dtype=torch.int64, device=device)
        n_windows = torch.zeros((), dtype=torch.int64, device=device)
        feed = _batch_feed(codes_all, cfg, device)
        try:
            for b in range(n_batches):
                n_windows += _fill(feed, cfg, buf, b * Wb, b)
        finally:
            feed.close()
        with trace.span("count: sort"):
            acc, over = oneshot_count(buf, cfg.spectrum_capacity)
            del buf
            n_windows = int(n_windows)
    if over:
        raise _overflow(cfg)
    return acc, n_windows


def arena_rows(capacity: int, t_rows: int) -> int:
    """Rows M = C + T of the grouped-count arena. The drain sorts all M rows
    in one ``keys.sort``; its prefix sums and row indices are int64, so the
    sort's element limit is the only bound (the reference's uint32
    composite key wraps at 2^31, assemble.py:274)."""
    M = capacity + t_rows
    keys.check_sort_rows(M, "the counting arena")
    return M


#: device bytes a drain holds at its peak per arena row and key word, and per
#: row besides: the arena's words and count, the sort's passes, gathers and
#: stacked output, with room (a grouped count of 2.36 G windows of 77-mers
#: peaks at 104.3 bytes an arena row of three words on an H100)
DRAIN_BYTES_PER_WORD, DRAIN_BYTES_PER_ROW = 48, 16


def count_capacity_limit(cfg: AssemblyConfig, n_reads: int, free_bytes: int | None = None) -> int:
    """The largest spectrum capacity C whose count of ``n_reads`` reads fits:
    C plus the window rows held beside it (the one-shot buffer, a group of
    batches, or one batch) within the rows one key sort takes and, where the
    device's free bytes are given, a drain at its peak within three
    quarters of them."""
    Wb = cfg.read_batch * cfg.windows_per_read
    t_rows = min(-(-n_reads // cfg.read_batch) * Wb, max(1, cfg.oneshot_rows // Wb) * Wb)
    rows = keys.SORT_ROWS_LIMIT
    if free_bytes is not None:
        per_row = DRAIN_BYTES_PER_WORD * keys.nwords(cfg.k) + DRAIN_BYTES_PER_ROW
        rows = min(rows, free_bytes * 3 // 4 // per_row)
    return rows - t_rows


def arena_drain(words: torch.Tensor, counts: torch.Tensor, capacity: int) -> tuple[int, bool]:
    """Merge the arena's raw window keys into its head, in place
    [reference make_arena_drain, assemble.py:243].

    ``words`` [M] or [M, W] holds the spectrum so far in rows [0, C) (with
    its int64 ``counts``) and raw window keys in rows [C, M) (weight 1;
    ``keys.SENT`` = empty). One key sort brings equal keys together; the
    distinct keys are compacted in order into rows [0, n) with their summed
    weights (``sorted_segments``: int64 prefix sums, as config 5's 2.4 G
    windows need). Every row past n is reset to ``keys.SENT`` and count 0;
    counts are written for rows below C only. The reference compacts by a
    second, composite-key sort that carries the prefix sums; ``torch.sort``
    carries no payload, so the port compacts the run starts with
    ``torch.nonzero``, which keeps their order, and gathers. Returns (n
    distinct keys, overflowed = n > C).
    """
    C = capacity
    s, perm = keys.sort(words)
    w = torch.where(perm < C, counts[perm], 1)
    del perm
    starts, sums = sorted_segments(s, w)
    del w
    n = starts.numel()
    words[:n] = s[starts]
    words[n:] = keys.SENT
    del s, starts
    counts.zero_()
    counts[: min(n, C)] = sums[:C]
    return n, n > C


def arena_finalize(words: torch.Tensor, counts: torch.Tensor, capacity: int) -> Spectrum:
    """The arena's head as a capacity-row Spectrum (new tensors, so the
    arena can be freed) [reference make_arena_finalize, :322]."""
    head = words[:capacity]
    valid = keys.is_valid(head)
    return Spectrum(
        words=keys.select(valid, head, 0),
        counts=torch.where(valid, counts[:capacity], 0).to(torch.int32),
        n=int(valid.sum()),
    )


def count_spectrum_grouped(codes_all, cfg: AssemblyConfig, device, t: dict | None):
    """Groups of ``oneshot_rows // Wb`` batches fill rows [C, C + T) of a
    persistent arena of M = C + T rows whose head, rows [0, C), holds the
    spectrum so far; one ``arena_drain`` per group merges them
    [reference count_spectrum_grouped, :452]. The last group may be
    partial: its unfilled rows stay empty.

    Sync policy: each group's drain ends in a host read of its distinct
    count, because the compaction sizes its outputs by it, and an overflow
    raises there, at the group where it happens. The reference defers that
    read for runs of at most four groups (``defer_sync``, :480), a rule set
    by out-of-memory failures on a 16 GB chip, where every deferred group
    kept its sort workspace queued. Under torch's stream-ordered caching
    allocator a deferred group holds no extra memory, but it also saves
    little: the read only delays the host's copy of the next batch, a few
    milliseconds against a drain over M rows. The drain's gathers run on
    past that read, so the group also waits for them: ``count_drain`` then
    holds the whole drain, as the reference's does.
    """
    Wb = cfg.read_batch * cfg.windows_per_read
    n_batches = _n_batches(codes_all, cfg)
    bpg = max(1, cfg.oneshot_rows // Wb)  # batches per group
    C = cfg.spectrum_capacity
    M = arena_rows(C, bpg * Wb)
    with trace.stage_times(t):
        words = torch.full((M,) + keys.word_shape(cfg.k), keys.SENT, dtype=torch.int64, device=device)
        counts = torch.zeros(M, dtype=torch.int64, device=device)
        n_windows = torch.zeros((), dtype=torch.int64, device=device)
        feed = _batch_feed(codes_all, cfg, device)
        try:
            for g0 in range(0, n_batches, bpg):
                for b in range(g0, min(g0 + bpg, n_batches)):
                    n_windows += _fill(feed, cfg, words, C + (b - g0) * Wb, b)
                with trace.span("count: drain", group=g0 // bpg, words=keys.nwords(cfg.k)):
                    _, over = arena_drain(words, counts, C)
                    _finish(device)  # the drain's compaction runs on past its host read
                if over:
                    raise _overflow(cfg)
        finally:
            feed.close()
        with trace.span("count: finalize"):
            acc = arena_finalize(words, counts, C)
            del words, counts
            n_windows = int(n_windows)
    if spectrum_overflowed(acc):
        raise _overflow(cfg)
    return acc, n_windows


def count_spectrum_per_batch(codes_all, cfg: AssemblyConfig, device, t: dict | None):
    """Per batch: the kernel writes the batch's keys into a [Wb] buffer,
    whose valid rows ``merge_keys`` folds into the spectrum with weight 1,
    one sort over C + Wb rows [reference make_count_step, :65, and
    count_spectrum, :556-583]."""
    Wb = cfg.read_batch * cfg.windows_per_read
    keys.check_sort_rows(cfg.spectrum_capacity + Wb, "a per-batch merge")
    with trace.stage_times(t):
        acc = empty_spectrum(cfg.spectrum_capacity, cfg.k, device)
        buf = torch.empty((Wb,) + keys.word_shape(cfg.k), dtype=torch.int64, device=device)
        ones = torch.ones(Wb, dtype=torch.int32, device=device)
        n_windows = torch.zeros((), dtype=torch.int64, device=device)
        over = False
        feed = _batch_feed(codes_all, cfg, device)
        try:
            for b in range(_n_batches(codes_all, cfg)):
                n_windows += _fill(feed, cfg, buf, 0, b)
                with trace.span("count: merge", batch=b):
                    acc, ov = merge_keys(acc, buf, keys.is_valid(buf), ones)
                over |= ov
        finally:
            feed.close()
        with trace.span("count: finalize"):
            n_windows = int(n_windows)
    if over or spectrum_overflowed(acc):
        raise _overflow(cfg)
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
    acc: Spectrum | list, cfg: AssemblyConfig, t: dict | None = None, save_graph_path: str = ""
) -> tuple[set, int]:
    """Cutoff (+ cleaning) + graph + traversal + emission. Returns
    (contigs, n_cut).

    ``acc`` may be handed over as a one-element list ``[spectrum]``: it is
    popped here, so the caller's frame keeps no reference and the
    pre-cutoff spectrum is freed once the cutoff has copied what it keeps.

    With ``tip_rounds`` or ``bubble_rounds`` the cut spectrum is right-sized
    a second time before the cleaning rounds: reads with errors count
    several times more distinct k-mers than survive the cutoff, and every
    round builds a graph at the spectrum's capacity. ``save_graph_path``
    checkpoints the final graph and its chains. Adds the stage seconds
    (``tips`` where asked, ``graph``, ``extract``) to ``t``.
    """
    if isinstance(acc, list):
        acc = acc.pop()
    device = acc.words.device
    with trace.stage_times(t):
        acc = right_size_spectrum(acc)
        if cfg.tip_rounds or cfg.bubble_rounds:
            with trace.span("clean"):
                acc = right_size_spectrum(apply_cutoff(acc, cfg.min_count))
                if cfg.tip_rounds:
                    acc, n_clipped = clip_tips(acc, cfg.k, cfg.tip_rounds, cfg.tip_len)
                    log.info("tip clipping removed %d k-mers", n_clipped)
                if cfg.bubble_rounds:
                    acc, n_popped = pop_bubbles(acc, cfg.k, cfg.bubble_rounds, cfg.bubble_len)
                    log.info("bubble popping removed %d k-mers", n_popped)
                _finish(device)  # the cleaning ends on finished work
        with trace.span("graph: cutoff"):
            cut = apply_cutoff(acc, cfg.min_count)
            del acc
            E = 2 * cut.words.shape[0]
            node_cap = 0  # 0 -> exact worst case 2E
            if cfg.node_cap_factor < 2.0:
                granule = 1 << 18
                node_cap = min(2 * E, -(-int(cfg.node_cap_factor * E) // granule) * granule)
        with trace.span("graph: build", words=keys.nwords(cfg.k)):
            g = build_graph_staged(cut, cfg.k, node_cap)
            words, n_cut = cut.words, cut.n
            del cut
            succ0 = successor(g)
            edge_valid = g.edge_valid
            ends = types.SimpleNamespace(tail=g.tail, head=g.head) if save_graph_path else None
            del g
        # the walk frees t before its cut-rank phase ([E] int64, 1.7 GB at
        # config 5) and recomputes it only for a fallback
        with trace.span("graph: transition keys"):
            holder = [transition_keys_spec(words, succ0, cfg.k)]
        with trace.span("graph: walk"):
            chains = chains_from_t(
                holder, edge_valid, succ0,
                t_factory=lambda: transition_keys_spec(words, succ0, cfg.k),
            )
            del succ0
        with trace.span("graph: sync"):
            _finish(device)  # the graph stage ends on finished work
        if save_graph_path:
            save_graph(save_graph_path, ends, chains, cfg.k, spec_words=words)
        contigs = chains_to_contigs_device_spec(words, chains, cfg.k)  # the emission's spans: stage extract
    return contigs, n_cut


def assemble_codes(codes_all: np.ndarray, cfg: AssemblyConfig, device) -> AssemblyResult:
    """Assemble from a pre-encoded [R, read_len] int8 code matrix on ``device``."""
    t: dict = {}
    with trace.assembly() as tr:
        acc, n_windows = count_spectrum(codes_all, cfg, device, t)
        holder = [acc]  # handed to spectrum_to_contigs, which pops it
        del acc
        contigs, n_cut = spectrum_to_contigs(holder, cfg, t)
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
        trace=tr,
    )


def assemble_reads(reads, cfg: AssemblyConfig, device) -> AssemblyResult:
    """Assemble a list of read strings into canonical contigs on ``device``."""
    reads = list(reads)
    return assemble_codes(encode_reads(reads, cfg.read_len), cfg, device)
