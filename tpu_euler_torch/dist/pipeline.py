"""The sharded assembly pipeline.

Counterpart of ``tpu_euler/dist/pipeline.py``. The k-mer spectrum is always
sharded by hash owner (``dist/count_dist.py``). By default the traversal
is replicated: the shards are gathered, and every rank runs the
single-device ``spectrum_to_contigs`` on the whole spectrum, so every rank
returns the same result. With ``shard_traversal=True`` nothing is gathered:
the graph, the chains, the tip and bubble rounds and the emission stay at
O(E / world) a rank (``dist/traverse_dist.py``). The contig sets are the
same either way.

A *comm* (``dist/mesh.py``) says where the ranks are: ``ProcessComm`` when
this process is one rank of a ``torch.distributed`` group, ``LoopbackComm``
when it holds them all on one device.

An assembly opens a trace (``trace.assembly``, as ``assemble_codes`` does),
and its stage timers are sums of its spans (``trace.STAGES``): ``encode``
(``encode: reads`` where the input is strings, and the prefetching feed's
``feed: setup`` and ``feed: wait``), ``count`` (a ``count: step`` a step:
extract, owner grouping, all-to-all, fill or per-batch merge, less the
feed's waits inside it), ``count_drain`` (a ``count: drain`` a group, and
``count: finalize``, the final reads), ``gather`` (``gather: spectrum``),
then ``spectrum_to_contigs``' own spans; the sharded traversal's
``graph: cutoff`` and ``graph: sharded traversal`` (chains, cleaning, each
attempt of the retry) make ``graph``, and ``emit: fragments`` makes
``extract``, and ``gather`` reads 0. The stages that end a phase end on a
device sync (``_finish``) inside their span.
"""

from __future__ import annotations

import itertools
import logging

import numpy as np
import torch

from tpu_euler_torch import trace
from tpu_euler_torch.config import AssemblyConfig
from tpu_euler_torch.dist.count_dist import (
    alloc_group_bufs,
    dist_count_step,
    dist_drain_step,
    dist_fill_step,
    empty_dist_spectrum,
    gather_spectrum,
)
from tpu_euler_torch.dist.mesh import fetch_global
from tpu_euler_torch.dist.traverse_dist import (
    dist_bubble_step,
    dist_chains_step,
    dist_compact_step,
    dist_cutoff_step,
    dist_tip_step,
    shard_chains_to_contigs,
)
from tpu_euler_torch.io.encode import encode_reads
from tpu_euler_torch.kmer import keys
from tpu_euler_torch.pipeline.assemble import (
    AssemblyResult,
    _batch_feed,
    _finish,
    spectrum_to_contigs,
)

log = logging.getLogger("tpu_euler_torch")


class _SlabOverflow(RuntimeError):
    """A slab of the sharded traversal dropped records (owner imbalance):
    the traversal can run again with bigger slabs."""


def assemble_reads_distributed(
    reads,
    cfg: AssemblyConfig,
    comm,
    dest_capacity_factor: float = 2.0,
    shard_traversal: bool = False,
    codes: np.ndarray | None = None,
    local_input: bool = False,
    slab_factors: tuple = (2.0, 4.0, 8.0),
) -> AssemblyResult:
    """Data-parallel assembly over the ranks of ``comm``
    [reference assemble_reads_distributed, :37].

    In a step each rank takes ``cfg.read_batch`` rows of the input. By
    default ``reads`` (strings) or ``codes`` ([R, read_len] int8) hold the
    whole input in every process, and rank r of step s takes batch
    s * world + r. With ``local_input`` they hold only this process's
    records (its byte-range shard of a file, say), which feed the ranks
    held here; the processes agree on the number of steps through an
    all-gather of (records, rows a step) pairs, since a process that ran a
    step fewer would leave the others waiting in the exchange.

    Counting is grouped (each rank buffers the keys it receives over
    ``oneshot_rows // (world * c_dest)`` steps and sorts them once) unless
    ``cfg.oneshot_rows`` is 0, which merges step by step. A rank whose
    group overflows its shard carries on to the end of the input and all
    ranks raise together there: one that raised alone would hang the rest.

    ``shard_traversal`` keeps the graph and the traversal sharded
    (``_sharded_traversal``); ``slab_factors`` are the slab sizes it tries
    in turn when a slab overflows.
    """
    keys.check_k(cfg.k)
    t: dict = {}
    with trace.assembly() as tr, trace.stage_times(t):
        if reads is not None:
            with trace.span("encode: reads"):
                codes = encode_reads(list(reads), cfg.read_len)
        acc, n_windows, n_reads = count_sharded(codes, cfg, comm, dest_capacity_factor, local_input)
        c_local = cfg.spectrum_capacity // comm.world
        if shard_traversal:
            contigs, n_cut = _sharded_traversal(acc, cfg, comm, c_local, slab_factors)
        else:
            with trace.span("gather: spectrum"):
                spec = gather_spectrum(acc, comm, min(cfg.spectrum_capacity, comm.world * c_local))
                del acc
                _finish(comm.device)
            holder = [spec]  # handed to spectrum_to_contigs, which pops it
            del spec
            contigs, n_cut = spectrum_to_contigs(holder, cfg)  # its spans count in the caller's stage times
    log.info(
        "dist-assembled %d reads on %d ranks -> %d distinct kmers -> %d contigs",
        n_reads, comm.world, n_cut, len(contigs),
    )
    return AssemblyResult(
        contigs=contigs,
        n_distinct_kmers=n_cut,
        n_kmers_counted=n_windows,
        n_reads=n_reads,
        # every stage but the cleaning rounds', which only the replicated
        # traversal runs as a stage, reported, 0 where none ran
        stage_seconds={s: t.get(s, 0.0) for s in trace.STAGES if s in t or s != "tips"},
        trace=tr,
    )


def count_sharded(
    codes: np.ndarray, cfg: AssemblyConfig, comm, dest_capacity_factor: float = 2.0, local_input: bool = False
):
    """The k-mer spectrum of ``codes`` ([R, read_len] int8), sharded by
    hash owner over the ranks of ``comm``, through the prefetching feed's
    int8 transport [reference assemble_reads_distributed, :83-203]. The
    batches a step, the input's split with ``local_input`` and the grouped
    or step-by-step merge are as ``assemble_reads_distributed`` says.

    Raises where a shard overflowed or the exchange dropped a k-mer, on
    every rank together. Returns (the shards, valid windows counted, reads
    over all processes)."""
    world, held, device = comm.world, len(comm.ranks), comm.device
    rows = cfg.read_batch  # reads a rank a step
    c_dest = int(dest_capacity_factor * rows * cfg.windows_per_read / world + 256)
    c_local = cfg.spectrum_capacity // world
    grouped = bool(cfg.oneshot_rows)

    total = codes.shape[0]
    if local_input:
        pairs = comm.process_allgather([total, rows * held])
        n_steps = max(1, max(-(-int(tp) // int(mp)) for tp, mp in pairs))
        n_reads = int(pairs[:, 0].sum())
        stride, first = held, 0
    else:
        n_steps = max(1, -(-total // (rows * world)))
        n_reads = total
        stride, first = world, comm.ranks[0]

    acc = empty_dist_spectrum(comm, c_local, cfg.k)
    n_valid = [torch.zeros((), dtype=torch.int64, device=device) for _ in range(held)]
    over = [False] * held
    if grouped:
        slab_rows = world * c_dest  # rows a rank receives a step
        bpg = max(1, min(n_steps, cfg.oneshot_rows // slab_rows))  # steps a group
        bufs = alloc_group_bufs(comm, bpg * slab_rows, cfg.k)
    batches = [s * stride + first + j for s in range(n_steps) for j in range(held)]
    feed = _batch_feed(codes, cfg, device, batches=batches, packed=False)  # int8 codes, as the reference ships
    try:
        for s in range(n_steps):
            # the step takes its batches one at a time (the feed reuses a
            # batch's slot once the next is taken); their waits are the
            # feed's spans, inside this one
            with trace.span("count: step", step=s):
                step_codes = itertools.islice(feed, held)
                if grouped:
                    b = s % bpg
                    nv = dist_fill_step(step_codes, bufs, b * slab_rows, acc.dropped, comm, cfg.k, c_dest)
                else:
                    acc, nv = dist_count_step(step_codes, acc, comm, cfg.k, c_dest)
                for j in range(held):
                    n_valid[j] += nv[j]
                drain = grouped and (b == bpg - 1 or s == n_steps - 1)
                if drain:
                    _finish(device)  # the group's fills are count time
            if drain:
                with trace.span("count: drain", group=s // bpg):
                    acc, ov = dist_drain_step(bufs, acc, c_local, cfg.k)
                    over = [was or now for was, now in zip(over, ov)]
                    if s < n_steps - 1:
                        for buf in bufs:
                            buf.fill_(keys.SENT)
                    _finish(device)
    finally:
        feed.close()
    if grouped:
        del bufs

    with trace.span("count: finalize"):
        _finish(device)
        # one row a rank: valid windows, drops, group overflow, shard rows
        stats = fetch_global(comm, [
            torch.cat([
                torch.stack([n_valid[j], acc.dropped[j]]),
                torch.tensor([int(over[j]), acc.n[j]], dtype=torch.int64, device=device),
            ])[None]
            for j in range(held)
        ])
    n_windows, dropped, n_over = (int(x) for x in stats[:, :3].sum(0))
    if n_over:
        raise RuntimeError(
            f"a spectrum shard overflowed its group-drain capacity "
            f"{c_local}: raise AssemblyConfig.spectrum_capacity"
        )
    if dropped:
        raise RuntimeError(
            f"{dropped} k-mers dropped in all_to_all exchange: raise "
            f"dest_capacity_factor (hash imbalance) or lower read_batch"
        )
    if int(stats[:, 3].max()) >= c_local:
        raise RuntimeError(
            f"a spectrum shard overflowed its capacity {c_local}: raise "
            f"AssemblyConfig.spectrum_capacity"
        )
    return acc, n_windows, n_reads


def _run_traversal(cut, cfg: AssemblyConfig, comm, c_local: int, slab_factor: float):
    """One attempt at the sharded traversal at ``slab_factor`` [reference
    run_traversal, :216]: the chains, tips to a fixed point, then bubbles,
    each removal followed by a compaction and new chains. ``cut`` = the
    shards after the cutoff (words, counts, n), which no step modifies, so
    another attempt can start from them.

    Raises ``_SlabOverflow`` when a slab dropped records. Every count that
    decides is summed over all ranks, so all ranks raise, or leave a loop,
    together. Returns (chains, each rank's rows)."""
    words, counts, n = cut
    sc = dist_chains_step(words, n, comm, cfg.k, c_local, slab_factor)
    if cfg.tip_rounds:
        for _ in range(cfg.tip_rounds):
            keep, n_tips, drops = dist_tip_step(sc, comm, cfg.tip_len or 2 * cfg.k, c_local, slab_factor)
            if drops:
                raise _SlabOverflow("tip-step slab overflow")
            if n_tips == 0:
                break
            del sc  # a step's chains are free before the next step's slabs
            words, counts, n = dist_compact_step(words, counts, n, keep)
            sc = dist_chains_step(words, n, comm, cfg.k, c_local, slab_factor)
    if cfg.bubble_rounds:
        for _ in range(cfg.bubble_rounds):
            keep, n_popped, drops = dist_bubble_step(
                sc, counts, comm, cfg.k, cfg.bubble_len or 2 * cfg.k, c_local, slab_factor
            )
            if drops:
                raise _SlabOverflow("bubble-step slab overflow")
            if n_popped == 0:
                break
            del sc
            words, counts, n = dist_compact_step(words, counts, n, keep)
            sc = dist_chains_step(words, n, comm, cfg.k, c_local, slab_factor)
    dropped = int(fetch_global(comm, [d[None] for d in sc.dropped]).sum())
    if dropped:
        raise _SlabOverflow(f"{dropped} records dropped in sharded-traversal slabs")
    return sc, n


def _sharded_traversal(acc, cfg: AssemblyConfig, comm, c_local: int, slab_factors: tuple):
    """The cutoff, the traversal with its retry over ``slab_factors`` and
    the emission, all on the sharded spectrum ``acc`` [reference
    assemble_reads_distributed, :205-302]. Returns (contigs, distinct
    k-mers left, over all ranks)."""
    with trace.span("graph: cutoff"):
        cut = dist_cutoff_step(acc.words, acc.counts, acc.n, cfg.min_count)
        del acc
    sc = last_err = None
    for slab_factor in slab_factors:
        try:
            with trace.span("graph: sharded traversal", slab_factor=slab_factor):
                sc, n = _run_traversal(cut, cfg, comm, c_local, slab_factor)
                _finish(comm.device)
            break
        except _SlabOverflow as e:
            last_err = e
            log.warning(
                "%s at slab_factor=%.2f; retrying with a bigger slab (owner imbalance)", e, slab_factor
            )
    if sc is None:
        raise RuntimeError(
            f"sharded-traversal slabs overflowed even at slab_factor="
            f"{slab_factors[-1]}: pathological owner imbalance — raise "
            f"spectrum_capacity or device count"
        ) from last_err
    del cut
    with trace.span("emit: fragments"):
        contigs = shard_chains_to_contigs(sc, comm, cfg.k)
    n_cut = int(fetch_global(comm, [torch.tensor([nj], dtype=torch.int64, device=comm.device) for nj in n]).sum())
    return contigs, n_cut
