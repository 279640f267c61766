"""Sharded k-mer counting: keys exchanged all-to-all by hash owner.

Counterpart of ``tpu_euler/dist/count_dist.py``.

* Each rank extracts the canonical k-mers of its rows of the read batch (on
  a CUDA device with the extract kernel, ``kmer/extract_kernel.py``).
* ``owner(key) = bucket_hash(key) % world`` over the reference's limb view
  of the key, so both packages send a key to the same rank.
* Keys are grouped by owner with one stable sort of the owner alone (the
  rows of one owner keep their window order), packed into fixed
  [world, c_dest] send slabs and exchanged with one all-to-all. An empty
  slab row is ``keys.SENT``: validity travels inside the key.
* Each rank then counts only keys it owns, so no key is counted on two
  ranks, and folds them into its shard of the spectrum: batch by batch
  (``dist_count_step``), or buffered over a group of batches and sorted
  once (``dist_fill_step``, ``dist_drain_step``).
* A slab that fills up drops the rest of its group; the drops are counted,
  and the pipeline sums them over the ranks and fails.

Every step takes per-rank lists and a comm (``dist/mesh.py``) and maps the
shard-local functions (``local_send``, ``_group_by_owner``) over the ranks
the comm holds. ``codes`` may be any iterable that yields a rank's batch at
a time; a batch is used up before the next is taken, as the pipeline's
prefetching feed requires.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_euler_torch.dist.exchange import owner_slots
from tpu_euler_torch.kmer import keys
from tpu_euler_torch.kmer.count import (
    Spectrum,
    _unique_counts,
    merge_keys,
    merge_spectra_lean,
    oneshot_count,
)
from tpu_euler_torch.kmer.extract_kernel import extract_fill


class DistSpectrum(NamedTuple):
    """The spectrum sharded by k-mer ownership: one entry a held rank."""

    words: list  # a rank: [c_local] (or [c_local, W]) int64, sorted in rows [0, n)
    counts: list  # a rank: [c_local] int32
    n: list  # a rank: its number of valid rows
    dropped: list  # a rank: 0-d int64, k-mers it dropped in the exchange (must be 0)

    def shard(self, j: int) -> Spectrum:
        return Spectrum(self.words[j], self.counts[j], self.n[j])


def empty_dist_spectrum(comm, c_local: int, k: int) -> DistSpectrum:
    held = range(len(comm.ranks))
    return DistSpectrum(
        words=[torch.zeros((c_local,) + keys.word_shape(k), dtype=torch.int64, device=comm.device) for _ in held],
        counts=[torch.zeros(c_local, dtype=torch.int32, device=comm.device) for _ in held],
        n=[0 for _ in held],
        dropped=[torch.zeros((), dtype=torch.int64, device=comm.device) for _ in held],
    )


def _group_by_owner(words: torch.Tensor, owner: torch.Tensor, world: int, c_dest: int):
    """Pack keys ``words`` [M] (or [M, W]) into send slabs grouped by
    ``owner`` [M] (``world`` for an invalid row, which is not sent).

    Returns (send [world * c_dest] (or [.., W]) with ``keys.SENT`` in the
    rows no key took, the number of keys dropped)."""
    rows, slots, n_dropped = owner_slots(owner, world, c_dest)
    send = torch.full((world * c_dest,) + tuple(words.shape[1:]), keys.SENT, dtype=torch.int64, device=words.device)
    send[slots] = words[rows]
    return send, n_dropped


def local_send(codes: torch.Tensor, k: int, world: int, c_dest: int):
    """One rank's half of a step before the exchange: the canonical keys of
    its [R, read_len] int8 codes, their owners, the send slabs.

    Returns (send, keys dropped, valid windows), the counts on the device."""
    n_rows = codes.shape[0] * (codes.shape[1] - k + 1)
    words = torch.empty((n_rows,) + keys.word_shape(k), dtype=torch.int64, device=codes.device)
    n_valid = extract_fill(codes, words, 0, k)
    owner = torch.where(keys.is_valid(words), keys.bucket_hash(words, keys.nlimbs(k)) % world, world)
    send, n_dropped = _group_by_owner(words, owner, world, c_dest)
    return send, n_dropped, n_valid


def _exchange(codes, dropped: list, comm, k: int, c_dest: int):
    """Extract, group and exchange one step's batches. ``dropped`` gains
    each rank's drops in place. Returns (received slabs, valid windows), a
    held rank each."""
    sends, n_valid = [], []
    for j, rank_codes in enumerate(codes):
        send, n_dropped, nv = local_send(rank_codes, k, comm.world, c_dest)
        dropped[j] += n_dropped
        sends.append(send)
        n_valid.append(nv)
    if len(sends) != len(comm.ranks):
        raise ValueError(f"{len(sends)} batches for {len(comm.ranks)} ranks")
    return comm.all_to_all(sends), n_valid


def dist_count_step(codes, acc: DistSpectrum, comm, k: int, c_dest: int):
    """The per-batch step [reference make_dist_count_step, :99]: exchange,
    then each rank merges the keys it received into its shard, one sort
    over its c_local rows and the slab's (the reference counts the slab and
    merges the batch spectrum, two sorts for the same rows and counts).

    Returns (acc', each rank's valid windows)."""
    recvs, n_valid = _exchange(codes, acc.dropped, comm, k, c_dest)
    words, counts, n = [], [], []
    for j, recv in enumerate(recvs):
        ones = torch.ones(recv.shape[0], dtype=torch.int32, device=recv.device)
        merged, _ = merge_keys(acc.shard(j), recv, keys.is_valid(recv), ones)
        words.append(merged.words)
        counts.append(merged.counts)
        n.append(merged.n)
    return DistSpectrum(words, counts, n, acc.dropped), n_valid


def alloc_group_bufs(comm, t_loc: int, k: int) -> list:
    """An empty (all ``keys.SENT``) group buffer of ``t_loc`` rows a held
    rank [reference make_buf_alloc, :235]."""
    keys.check_sort_rows(t_loc, "a rank's group buffer")
    return [
        torch.full((t_loc,) + keys.word_shape(k), keys.SENT, dtype=torch.int64, device=comm.device)
        for _ in comm.ranks
    ]


def dist_fill_step(codes, bufs: list, start: int, dropped: list, comm, k: int, c_dest: int):
    """The grouped route's fill [reference make_dist_fill_step, :142]:
    exchange, then each rank writes the slab it received into rows
    [start, start + world * c_dest) of its group buffer, in place.

    Returns each rank's valid windows; ``dropped`` gains the drops."""
    recvs, n_valid = _exchange(codes, dropped, comm, k, c_dest)
    for buf, recv in zip(bufs, recvs):
        buf[start : start + recv.shape[0]] = recv
    return n_valid


def dist_drain_step(bufs: list, acc: DistSpectrum, c_local: int, k: int):
    """The grouped route's drain [reference make_dist_drain_step, :193]: a
    rank sorts its group buffer once, reduces it to at most ``c_local``
    distinct keys and merges those into its shard. The keys arrived
    partitioned by owner, so this is the global dedup of the rank's keys,
    and no collective runs.

    Returns (acc', over): ``over[j]`` says that the group alone held more
    than ``c_local`` distinct keys."""
    words, counts, n, over = [], [], [], []
    for j, buf in enumerate(bufs):
        group, ov = oneshot_count(buf, c_local)
        merged = merge_spectra_lean(acc.shard(j), group, k)
        words.append(merged.words)
        counts.append(merged.counts)
        n.append(merged.n)
        over.append(ov)
    return DistSpectrum(words, counts, n, acc.dropped), over


def gather_spectrum(acc: DistSpectrum, comm, out_capacity: int) -> Spectrum:
    """The shards gathered into one spectrum, the same on every rank
    [reference make_gather_spectrum, :251]: the ranks' keys are disjoint,
    so one sort over all shards' rows gives the global sorted spectrum. Cut
    to ``out_capacity`` rows."""
    c_local = acc.words[0].shape[0]
    keys.check_sort_rows(comm.world * c_local, "the gathered spectrum")
    words = comm.all_gather(acc.words)[0]
    counts = comm.all_gather(acc.counts)[0]
    n = comm.all_gather([torch.tensor([n], dtype=torch.int64, device=comm.device) for n in acc.n])[0]
    slot = torch.arange(c_local, device=comm.device)
    valid = (slot[None, :] < n[:, None]).reshape(-1)
    uniq, ucounts, n_all = _unique_counts(words, valid, counts)
    return Spectrum(uniq[:out_capacity], ucounts[:out_capacity], min(n_all, out_capacity))
