"""Chain -> contig sequence emission over the virtual doubled edge array.

Counterpart of ``emit_chains_device_spec``, ``chains_to_contigs_device_spec``
and ``_emission_to_contigs`` in ``tpu_euler/euler/extract.py``. On the
device, every edge's last base is scattered into a dense byte buffer at its
chain's offset + (k-1) + its position; only O(total contig bases) then moves
to the host, where the (k-1)-base chain prefixes are stitched in and each
contig is canonicalized (min of sequence and reverse complement).

The numpy helpers are this package's own copies: the reference's live in a
module that imports JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_euler_torch.euler.unitigs import UnitigChains
from tpu_euler_torch.graph.build import gather_edge_rows
from tpu_euler_torch.kmer import keys

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_RC_TABLE = np.zeros(256, dtype=np.uint8)
for _a, _b in zip(b"ACGT", b"TGCA"):
    _RC_TABLE[_a] = _b


def rc_bytes(seq: np.ndarray) -> np.ndarray:
    return _RC_TABLE[seq][::-1]


def canonicalize_contig_buffer(buf: np.ndarray, off: np.ndarray) -> set[bytes]:
    """Canonical contig set from a flat ASCII base buffer + [n+1] offsets.

    Vectorized: the reverse complement of contig c at global byte j is the
    complement of the mirrored byte off[c] + off[c+1] - 1 - j; fwd vs rc is
    decided by each contig's first fwd/rc mismatch.
    """
    n = off.size - 1
    if n == 0:
        return set()
    if n <= 256:  # few (typically long) contigs: per-contig numpy is cheaper
        out = set()
        for c in range(n):
            seq = buf[off[c] : off[c + 1]]
            fwd = seq.tobytes()
            rev = rc_bytes(seq).tobytes()
            out.add(fwd if fwd <= rev else rev)
        return out
    total = int(off[-1])
    lens = np.diff(off)
    cid = np.repeat(np.arange(n, dtype=np.int64), lens)
    j = np.arange(total, dtype=np.int64)
    mirror = off[cid] + off[cid + 1] - 1 - j
    comp = _RC_TABLE[buf[mirror]]  # comp[j] = rc(contig)[local j]
    neq = np.flatnonzero(buf != comp)
    pos = np.searchsorted(neq, off[:-1])
    cand = neq[np.minimum(pos, max(neq.size - 1, 0))] if neq.size else np.zeros(n, np.int64)
    has = (pos < neq.size) & (cand < off[1:])
    take_rc = np.zeros(n, bool)
    take_rc[has] = comp[cand[has]] < buf[cand[has]]
    out = np.where(take_rc[cid], comp, buf)
    return {out[off[c] : off[c + 1]].tobytes() for c in range(n)}


def decode_bases_np(words: np.ndarray, n_bases: int, k: int) -> np.ndarray:
    """ASCII of the FIRST n_bases of k-base keys: [N] int64 words, or [N, W]
    for k > 31 -> [N, n_bases]. Base i lies (k-1-i) bases above the key's
    last base: in word W-1 - (k-1-i) // 31, (k-1-i) % 31 bases up."""
    up = k - 1 - np.arange(n_bases, dtype=np.int64)
    w2 = words.reshape(words.shape[0], -1)
    src = w2[:, w2.shape[1] - 1 - up // keys.LO_BASES]
    return _BASES[(src >> (2 * (up % keys.LO_BASES))[None, :]) & 3]


class DeviceEmission(NamedTuple):
    """Device-side contig buffer + per-chain tables (capacity-padded)."""

    buf: torch.Tensor  # [out_capacity] uint8 base codes (0..3)
    chain_off: torch.Tensor  # [chain_capacity] int64 byte offset of each chain
    start_words: torch.Tensor  # [chain_capacity] (or [.., W]) int64 start edge key
    n_chains: int
    total: int  # bytes used


def emit_chains_device_spec(
    words: torch.Tensor,
    chains: UnitigChains,
    k: int,
    out_capacity: int,
    chain_capacity: int,
) -> DeviceEmission:
    """Assemble all contig bytes on the device, sort-free: a chain's id is its
    end edge's id, so chain offsets are one exclusive cumsum of
    (length + k - 1) over end-edge slots, in end-edge-id order."""
    C = words.shape[0]
    E = 2 * C
    dev = words.device
    eid = torch.arange(E, device=dev)
    valid = chains.in_chain
    is_rep = valid & (chains.chain == eid)  # this edge ends its own chain
    is_start = valid & (chains.pos == 0)

    contrib = torch.where(is_rep, chains.length + (k - 1), 0)
    cs = torch.cumsum(contrib, 0) - contrib  # exclusive: offset at end-edge slots
    total = int(cs[-1] + contrib[-1])
    rank = torch.cumsum(is_rep, 0) - 1  # chain rank at end-edge slots
    n_chains = int(rank[-1]) + 1

    cid = torch.clamp(chains.chain, 0, E - 1)
    out_pos = cs[cid] + (k - 1) + chains.pos
    # last base of doubled row r: its own for r < C; for r >= C the
    # complement of forward row r-C's first base
    lastb = torch.cat([keys.last_base(words), 3 - keys.first_base(words, k)]).to(torch.uint8)
    buf = torch.zeros(out_capacity + 1, dtype=torch.uint8, device=dev)
    buf[torch.where(valid & (out_pos < out_capacity), out_pos, out_capacity)] = lastb

    # chains ranked past the capacity are dropped (the caller reruns)
    crank_end = torch.where(is_rep & (rank < chain_capacity), rank, chain_capacity)
    chain_off = torch.zeros(chain_capacity + 1, dtype=torch.int64, device=dev)
    chain_off[crank_end] = cs
    srank = rank[cid]
    crank_start = torch.where(is_start & (srank < chain_capacity), srank, chain_capacity)
    start_eid = torch.zeros(chain_capacity + 1, dtype=torch.int64, device=dev)
    start_eid[crank_start] = eid
    return DeviceEmission(
        buf=buf[:out_capacity],
        chain_off=chain_off[:chain_capacity],
        start_words=gather_edge_rows(words, start_eid[:chain_capacity], k),
        n_chains=n_chains,
        total=total,
    )


def chains_to_contigs_device_spec(
    words: torch.Tensor,
    chains: UnitigChains,
    k: int,
    out_capacity: int | None = None,
    chain_capacity: int | None = None,
) -> set[bytes]:
    """Device emission; on a capacity overflow it reruns once with exact
    (pow2-rounded) capacities."""
    E = 2 * words.shape[0]
    out_capacity = out_capacity or E + (k - 1) * max(1024, E >> 4)
    chain_capacity = chain_capacity or max(1024, E >> 4)
    em = emit_chains_device_spec(words, chains, k, out_capacity, chain_capacity)
    if em.n_chains > chain_capacity or em.total > out_capacity:
        g2 = max(1 << 14, 1 << (max(em.n_chains - 1, 1)).bit_length())
        g3 = max(1 << 20, 1 << (max(em.total - 1, 1)).bit_length())
        return chains_to_contigs_device_spec(words, chains, k, g3, g2)
    if em.n_chains == 0:
        return set()
    return _emission_to_contigs(em, k)


def _emission_to_contigs(em: DeviceEmission, k: int) -> set[bytes]:
    """The O(output)-transfer host tail of the device emission."""
    n = em.n_chains
    seq = _BASES[em.buf[: em.total].cpu().numpy()]
    off = em.chain_off[:n].cpu().numpy()
    prefixes = decode_bases_np(em.start_words[:n].cpu().numpy(), k - 1, k)
    seq[off[:, None] + np.arange(k - 1)[None, :]] = prefixes
    return canonicalize_contig_buffer(seq, np.concatenate([off, [em.total]]))
