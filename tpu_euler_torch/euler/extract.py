"""Chain -> contig sequence emission.

Counterpart of ``tpu_euler/euler/extract.py``. On the device
(``chains_to_contigs_device_spec`` over the spectrum's virtual doubled edge
array, ``chains_to_contigs_device`` over materialized edge keys), every
edge's last base is scattered into a dense byte buffer at its chain's
offset + (k-1) + its position; then a kernel (``emit_kernel``) stitches in
each chain's (k-1)-base prefix from its start key, decides each contig's
direction (min of sequence and reverse complement) and writes the
canonical ASCII bytes and their offsets into one buffer, which moves to
the host in one copy into pinned memory; the host only cuts it into
``bytes``, once for a contig and the other strand's chain (its twin) where
the kernel found the two canonical forms equal byte for byte. The
reference does the stitch and the canonicalization in numpy on the host:
the work runs elsewhere, the output is the same. The two device entry
points share one scatter and differ in where an edge's key is read
(``_SpecEdges``, ``_MaterializedEdges``). On a capacity overflow the
emission reruns once with exact capacities (the trace's ``emit_reruns``
counts them); it never falls back to the host path. Its spans are ``emit:
device`` (the scatter, a rerun, and the kernel's launches), ``emit: copy``
(the copy to the host and its wait, which also waits for the kernel) and
``emit: host`` (cutting the buffer into the contig set).

``chains_to_contigs`` is the host path: every valid edge's record moves to
the host and one numpy scatter assembles the bytes, which
``canonicalize_contig_buffer`` canonicalizes. It serves as the device
path's check; the sharded mode's fragment emission and the command line's
dump use the same numpy helpers.

The numpy helpers are this package's own copies: the reference's live in a
module that imports JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_euler_torch import trace
from tpu_euler_torch.euler.emit_kernel import canonical_bytes, contig_set
from tpu_euler_torch.euler.unitigs import UnitigChains
from tpu_euler_torch.graph.build import DeBruijnGraph, gather_edge_rows
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
    twin: torch.Tensor | None  # [n_chains] the other strand's chain, or -1 (None: not known)


class _SpecEdges:
    """Edge keys read from the spectrum: the virtual doubled array, whose
    row r >= C is the reverse complement of spectrum row r - C."""

    def __init__(self, words: torch.Tensor, k: int):
        self.words, self.k, self.E = words, k, 2 * words.shape[0]

    def last_bases(self) -> torch.Tensor:
        # a reverse row's last base is the complement of its forward row's first
        return torch.cat([keys.last_base(self.words), 3 - keys.first_base(self.words, self.k)])

    def rows(self, idx: torch.Tensor) -> torch.Tensor:
        return gather_edge_rows(self.words, idx, self.k)

    def twin(self, idx: torch.Tensor) -> torch.Tensor:
        """Each edge's reverse complement's row."""
        C = self.E // 2
        return torch.where(idx < C, idx + C, idx - C)


class _MaterializedEdges:
    """Edge keys held as an array, one row an edge (``build_graph``,
    ``load_graph``)."""

    def __init__(self, words: torch.Tensor):
        self.words, self.E = words, words.shape[0]

    def last_bases(self) -> torch.Tensor:
        return keys.last_base(self.words)

    def rows(self, idx: torch.Tensor) -> torch.Tensor:
        return self.words[torch.clamp(idx, 0, self.E - 1)]

    def twin(self, idx: torch.Tensor) -> None:
        """Not known: an edge's reverse complement may lie anywhere."""
        return None


def _edge_words_of(g) -> torch.Tensor:
    """A graph's materialized edge keys, or the bare array."""
    return g.edge_words if isinstance(g, DeBruijnGraph) else g


def emit_chains_device(
    edges, chains: UnitigChains, k: int, out_capacity: int, chain_capacity: int
) -> DeviceEmission:
    """Assemble all contig bytes on the device from an edge source
    (``_SpecEdges`` or ``_MaterializedEdges``) [reference
    emit_chains_device_spec, :188, and emit_chains_device, :125], sort-free: a chain's id is its
    end edge's id, so chain offsets are one exclusive cumsum of
    (length + k - 1) over end-edge slots, in end-edge-id order. Where the
    source knows each edge's reverse complement, each chain's twin is the
    chain that ends at its start edge's reverse complement (the other
    strand's), a candidate the canonical bytes confirm or drop."""
    E = edges.E
    dev = chains.chain.device
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
    buf = torch.zeros(out_capacity + 1, dtype=torch.uint8, device=dev)
    buf[torch.where(valid & (out_pos < out_capacity), out_pos, out_capacity)] = (
        edges.last_bases().to(torch.uint8)
    )

    # chains ranked past the capacity are dropped (the caller reruns)
    crank_end = torch.where(is_rep & (rank < chain_capacity), rank, chain_capacity)
    chain_off = torch.zeros(chain_capacity + 1, dtype=torch.int64, device=dev)
    chain_off[crank_end] = cs
    srank = rank[cid]
    crank_start = torch.where(is_start & (srank < chain_capacity), srank, chain_capacity)
    start_eid = torch.zeros(chain_capacity + 1, dtype=torch.int64, device=dev)
    start_eid[crank_start] = eid
    start_words = edges.rows(start_eid[:chain_capacity])
    twin = None
    if n_chains <= chain_capacity:
        te = edges.twin(start_eid[:n_chains])
        if te is not None:
            twin = torch.where(is_rep[te], rank[te], -1)
    return DeviceEmission(
        buf=buf[:out_capacity],
        chain_off=chain_off[:chain_capacity],
        start_words=start_words,
        n_chains=n_chains,
        total=total,
        twin=twin,
    )


def _contigs_device(edges, chains, k, out_capacity, chain_capacity) -> set[bytes]:
    E = edges.E
    out_capacity = out_capacity or E + (k - 1) * max(1024, E >> 4)
    chain_capacity = chain_capacity or max(1024, E >> 4)
    with trace.span("emit: device"):
        em = emit_chains_device(edges, chains, k, out_capacity, chain_capacity)
        if em.n_chains > chain_capacity or em.total > out_capacity:
            trace.add("emit_reruns")
            g2 = max(1 << 14, 1 << (max(em.n_chains - 1, 1)).bit_length())
            g3 = max(1 << 20, 1 << (max(em.total - 1, 1)).bit_length())
            del em
            em = emit_chains_device(edges, chains, k, g3, g2)
        n = em.n_chains
        if n == 0:
            return set()
        buf = canonical_bytes(em.buf, em.chain_off, em.start_words, n, em.total, k, em.twin)
        del em
    return _emission_to_contigs(buf, n)


def chains_to_contigs_device_spec(
    words: torch.Tensor,
    chains: UnitigChains,
    k: int,
    out_capacity: int | None = None,
    chain_capacity: int | None = None,
) -> set[bytes]:
    """Device emission over the virtual doubled edge array; on a capacity
    overflow it reruns once with exact (pow2-rounded) capacities."""
    return _contigs_device(_SpecEdges(words, k), chains, k, out_capacity, chain_capacity)


def chains_to_contigs_device(
    g: DeBruijnGraph | torch.Tensor,
    chains: UnitigChains,
    k: int,
    out_capacity: int | None = None,
    chain_capacity: int | None = None,
) -> set[bytes]:
    """Device emission over materialized edge keys: a graph with
    ``edge_words`` or the bare array [reference chains_to_contigs_device,
    :329]. The same rerun policy."""
    return _contigs_device(_MaterializedEdges(_edge_words_of(g)), chains, k, out_capacity, chain_capacity)


def _emission_to_contigs(buf: torch.Tensor, n: int) -> set[bytes]:
    """The O(output)-transfer host tail of the device emission: the
    canonical buffer of ``n`` contigs (``emit_kernel.canonical_bytes``) in
    one copy into pinned host memory (torch's caching host allocator, so
    reused from call to call), then cut into the contig set, each contig
    that the card found to repeat its twin left out."""
    nbytes = buf.nbytes
    trace.add("d2h_bytes", nbytes)
    with trace.span("emit: copy", bytes=nbytes):
        if buf.is_cuda:
            host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            host.copy_(buf, non_blocking=True)
            torch.cuda.current_stream(buf.device).synchronize()
        else:
            host = buf
    del buf
    with trace.span("emit: host"):
        contigs, mirrored = contig_set(host, n)
        trace.add("emit_mirrored_prefixes", mirrored)
        return contigs


def assemble_contig_bytes(chain: np.ndarray, pos: np.ndarray, words: np.ndarray, k: int) -> set[bytes]:
    """The host assembly: (chain id, position, edge key) of every valid
    edge -> the canonical contig set [reference assemble_contig_bytes,
    :373]. ``words`` is [N] int64, or [N, W] for k > 31."""
    if chain.size == 0:
        return set()
    last = _BASES[words.reshape(words.shape[0], -1)[:, -1] & 3]
    # dense chain ids in end-edge-id order
    uchain, dense = np.unique(chain, return_inverse=True)
    chain_len = np.zeros(uchain.size, dtype=np.int64)
    np.maximum.at(chain_len, dense, pos + 1)
    # contig c takes (k - 1) + len_c bytes at off[c] of one flat buffer
    off = np.zeros(uchain.size + 1, dtype=np.int64)
    np.cumsum(chain_len + (k - 1), out=off[1:])
    buf = np.empty(off[-1], dtype=np.uint8)
    buf[off[dense] + (k - 1) + pos] = last
    starts = pos == 0
    prefixes = decode_bases_np(words[starts], k - 1, k)
    buf[off[dense[starts]][:, None] + np.arange(k - 1)[None, :]] = prefixes
    return canonicalize_contig_buffer(buf, off)


def chains_to_contigs(g: DeBruijnGraph | torch.Tensor, chains: UnitigChains, k: int) -> set[bytes]:
    """Canonical contigs on the host from per-edge chain records and
    materialized edge keys [reference chains_to_contigs, :401]."""
    idx = torch.nonzero(chains.in_chain).squeeze(1)
    return assemble_contig_bytes(
        chains.chain[idx].cpu().numpy(),
        chains.pos[idx].cpu().numpy(),
        _edge_words_of(g)[idx].cpu().numpy(),
        k,
    )
