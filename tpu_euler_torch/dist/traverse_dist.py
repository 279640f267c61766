"""The sharded traversal: graph, chains and cleaning at O(E / world) a rank.

Counterpart of ``tpu_euler/dist/traverse_dist.py``. After counting and the
cutoff the spectrum stays sharded by hash owner, and so does every array of
the traversal:

1. **Successors by node-record exchange.** Each local edge (a spectrum row,
   and its reverse complement) sends two records, (tail key, OUT) and (head
   key, IN), to the hash owner of the node key. The owner sorts what it
   received by (key, OUT before IN), takes the degrees as sorted segment
   sums and answers along the same slab positions: the IN record of a
   simple node learns its successor's global edge id and last base, the OUT
   record its predecessor's id, and both whether their node is a dead end.
2. **Doubling over ranks.** The fused cycle detection and minimum
   transition, and the two Wyllie passes (chain id forward, position
   backward), are the single-device loops with the row gather replaced by
   ``exchange_gather`` over global edge ids.
3. **Cycle cutting** is local; the new chain starts are pushed to the cut
   edges' successors with ``exchange_push``.
4. **Tips and bubbles** are judged at each chain's home (its end edge) and
   read back by the member edges; a bubble's (start node, end node) group
   meets at the pair's hash owner.
5. **Emission**: a process reduces the shards it holds to compact fragments
   (chain id, position and one base an edge, the start edges' prefixes);
   processes that hold only some of the ranks exchange the fragments, so
   that each returns the whole canonical contig set.

Every step takes per-rank lists and a comm (``dist/mesh.py``), as
``dist/count_dist.py`` does. Global edge ids, chain ids and positions are
int64; -1 is "none" where the reference's uint32 rows are all ones, and a
transition key that does not exist is ``keys.SENT``. Whether a row of a
doubling state is dead is read from its pointer column only: a one-word
transition key is a tkey and may be any int64.

All slab drops are counted and summed over the ranks, and every count that
ends a loop or raises is all-reduced first, so that all ranks decide alike.

Differences from the reference, none of which changes a result:

* A slab record packs the edge id, the OUT bit and the last base into one
  int64 beside the key words, and a reply is one int64. Empty slab rows are
  ``keys.SENT`` in the key, and an owner compacts them away before it sorts.
* The doubling loops stop when no row of any rank has a pointer left (an
  all-reduced flag); the reference always runs ``log2(E) + 1`` rounds, the
  later ones without any request. A pure cycle keeps its rows alive, so
  the cycle detection runs all its rounds where there is one.
* The exact minimum key of a chain takes one push-min and gather a 62-bit
  word, where the reference takes one a 32-bit limb; the drops of those
  rounds are counted a word.
* Coverage sums are int64 (the reference's wrap at 2^32).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_euler_torch.dist.exchange import exchange_gather, exchange_push, owner_slots, take_rows
from tpu_euler_torch.dist.mesh import fetch_global
from tpu_euler_torch.kmer import keys
from tpu_euler_torch.kmer.count import Spectrum, apply_cutoff


class ShardChains(NamedTuple):
    """The traversal's output, one entry a held rank (``el_cap`` rows each:
    the rank's spectrum rows, then their reverse complements)."""

    edge_words: list  # a rank: [el_cap] (or [el_cap, W]) int64 edge k-mers
    valid: list  # a rank: [el_cap] bool
    chain: list  # a rank: [el_cap] int64 global chain id (its end edge's id); -1 where invalid
    pos: list  # a rank: [el_cap] int64 position from the chain's start
    is_start: list  # a rank: [el_cap] bool
    tail_dead: list  # a rank: [el_cap] bool, the edge's tail node has in-degree 0
    head_dead: list  # a rank: [el_cap] bool, the edge's head node has out-degree 0
    on_cycle: list  # a rank: [el_cap] bool, the edge lay on a pure cycle before the cut
    dropped: list  # a rank: 0-d int64 slab drops (must be 0)


def _log2_ceil(n: int) -> int:
    return max(1, (n - 1).bit_length())


def slab_sizes(c_local: int, world: int, slab_factor: float) -> tuple[int, int]:
    """(c_node, c_req): rows a destination in a node-record slab and in a
    request slab [reference make_dist_chains_step, :219-220]."""
    return int(slab_factor * 4 * c_local / world) + 256, int(slab_factor * 2 * c_local / world) + 256


def _cols(w: torch.Tensor) -> torch.Tensor:
    """Keys as [N, W] columns (a one-word key tensor is [N])."""
    return w[:, None] if w.dim() == 1 else w


def _gids(rank: int, el_cap: int, device) -> torch.Tensor:
    return rank * el_cap + torch.arange(el_cap, device=device)


def _any_alive(ptrs: list[torch.Tensor], comm) -> bool:
    """Whether any row of any rank still has a pointer: the same answer on
    every rank."""
    return bool(comm.all_reduce_sum([(p >= 0).any().to(torch.int64) for p in ptrs])[0])


def _segment_bounds(is_new: torch.Tensor):
    """(seg [n]: each row's run, starts [G], ends [G]) of the runs that
    ``is_new`` [n] opens."""
    starts = torch.nonzero(is_new).squeeze(1)
    ends = torch.cat([starts[1:], starts.new_tensor([is_new.shape[0]])])
    return torch.cumsum(is_new, 0) - 1, starts, ends


def _segment_sums(w: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Sums of int64 ``w`` over the sorted runs [starts, ends): differences
    of one prefix sum, no scatter."""
    c0 = torch.cat([w.new_zeros(1), torch.cumsum(w, 0)])
    return c0[ends] - c0[starts]


# --- phase 1: successors by node-record exchange ------------------------------


def _node_slab(edge_words, valid, rank: int, k: int, world: int, el_cap: int, c_node: int):
    """One rank's node records in send slabs [reference :71-122]: rows
    [0, el_cap) are the OUT records (key = the edge's tail, its prefix),
    rows [el_cap, 2 el_cap) the IN records (its head, the suffix). A slab
    row is the key's W words and ``gid * 8 + OUT * 4 + last base``.

    Returns (slab [world * c_node, W + 1], rows, slots, records dropped)."""
    gid = _gids(rank, el_cap, edge_words.device)
    lastb = keys.last_base(edge_words)
    rkeys = torch.cat([_cols(keys.prefix(edge_words)), _cols(keys.suffix(edge_words, k))])
    meta = torch.cat([gid * 8 + 4 + lastb, gid * 8 + lastb])
    owner = torch.where(torch.cat([valid, valid]), keys.bucket_hash(rkeys, keys.nlimbs(k)) % world, world)
    rows, slots, n_dropped = owner_slots(owner, world, c_node)
    slab = torch.full((world * c_node, rkeys.shape[1] + 1), keys.SENT, dtype=torch.int64, device=gid.device)
    slab[slots] = take_rows(torch.cat([rkeys, meta[:, None]], 1), rows)
    return slab, rows, slots, n_dropped


def _serve_node_records(recv: torch.Tensor) -> torch.Tensor:
    """The owner's half [reference :125-180]: group the records received by
    node key, OUT before IN, take the degrees, pair IN with OUT at simple
    nodes (one of each).

    Returns one int64 a slab row, ``(partner gid + 1) * 8 + last base * 2 +
    dead``: an IN record reads its successor (the node's OUT edge) and its
    last base, and ``dead`` = the node has no OUT edge; an OUT record reads
    its predecessor (the node's IN edge), and ``dead`` = no IN edge. The
    gid field is 0 where the node is not simple; an empty row reads 0."""
    W = recv.shape[1] - 1
    reply = torch.zeros(recv.shape[0], dtype=torch.int64, device=recv.device)
    idx = torch.nonzero(recv[:, 0] != keys.SENT).squeeze(1)  # arrival order kept
    n = idx.numel()
    if n == 0:
        return reply
    meta = recv[idx, W]
    # one sort by (key, OUT before IN): the IN bit rides below the last word
    # (a (k-1)-mer's last word is below 2^62, so the sum stays positive)
    sk = recv[idx, :W]
    sk[:, W - 1] = sk[:, W - 1] * 2 + (1 - ((meta >> 2) & 1))
    s, perm = keys.sort(sk[:, 0] if W == 1 else sk)
    del sk
    s = _cols(s)
    t_in = (s[:, W - 1] & 1) == 1
    s[:, W - 1] >>= 1
    is_new = torch.ones(n, dtype=torch.bool, device=recv.device)
    is_new[1:] = (s[1:] != s[:-1]).any(dim=1)
    del s
    seg, starts, ends = _segment_bounds(is_new)
    outdeg = _segment_sums((~t_in).to(torch.int64), starts, ends)
    indeg = (ends - starts) - outdeg
    od, idg, first = outdeg[seg], indeg[seg], starts[seg]
    simple = (od == 1) & (idg == 1)
    # a simple node's run is [its OUT record, its IN record]
    partner = meta[perm][torch.where(t_in, first, (first + 1).clamp(max=n - 1))]
    rep = torch.where(simple, ((partner >> 3) + 1) * 8 + torch.where(t_in, (partner & 3) * 2, 0), 0)
    rep += torch.where(t_in, od == 0, idg == 0)
    reply[idx[perm]] = rep
    return reply


def _node_record_exchange(edge_words: list, valid: list, comm, k: int, el_cap: int, c_node: int):
    """Distributed successor assignment [reference _node_record_exchange, :67].

    Returns per-rank lists (succ_gid [el_cap] int64, -1 = none; succ_lastb
    [el_cap]; has_pred [el_cap] bool; pred_gid [el_cap], -1 = none;
    tail_dead; head_dead; records dropped)."""
    world = comm.world
    placed = [
        _node_slab(w, v, rank, k, world, el_cap, c_node) for w, v, rank in zip(edge_words, valid, comm.ranks)
    ]
    recvs = comm.all_to_all([p[0] for p in placed])
    placed = [p[1:] for p in placed]  # the send slabs are free now
    replies = []
    while recvs:
        replies.append(_serve_node_records(recvs.pop(0)))
    out = ([], [], [], [], [], [], [])
    for (rows, slots, n_dropped), back, v in zip(placed, comm.all_to_all(replies), valid):
        per_record = torch.zeros(2 * el_cap, dtype=torch.int64, device=v.device)
        per_record[rows] = back[slots]
        out_r, in_r = per_record[:el_cap], per_record[el_cap:]
        pred = torch.where(v, (out_r >> 3) - 1, -1)
        fields = (
            torch.where(v, (in_r >> 3) - 1, -1), (in_r >> 1) & 3, pred >= 0, pred,
            v & ((out_r & 1) == 1), v & ((in_r & 1) == 1), n_dropped,
        )
        for col, x in zip(out, fields):
            col.append(x)
    return out


# --- phase 2: doubling over ranks ---------------------------------------------


def _detect_pass(succ: list, t: list, comm, el_cap: int, c_req: int, rounds: int):
    """The fused cycle detection and minimum transition key [reference
    detect_round, :248-265]: a state row is (pointer, the least transition
    key seen so far). After the rounds a row that still points somewhere
    lies on a pure cycle, and its key is the cycle's least.

    Returns (pointers, least keys as [el_cap, Wt] columns, requests dropped)."""
    tc = [_cols(x) for x in t]
    fill = torch.tensor([-1] + [keys.SENT] * tc[0].shape[1], dtype=torch.int64, device=comm.device)
    states = [torch.cat([p[:, None], x], 1) for p, x in zip(succ, tc)]
    drops = [torch.zeros((), dtype=torch.int64, device=comm.device) for _ in succ]
    for _ in range(rounds):
        ptrs = [s[:, 0] for s in states]
        if not _any_alive(ptrs, comm):
            break
        rows, dr = exchange_gather(states, ptrs, comm, el_cap, c_req, fill)
        # a dead row fetched ``fill``: pointer -1, and a key nothing is above
        states = [
            torch.cat([r[:, :1], torch.where(keys.key_less(r[:, 1:], s[:, 1:])[:, None], r[:, 1:], s[:, 1:])], 1)
            for s, r in zip(states, rows)
        ]
        drops = [a + b for a, b in zip(drops, dr)]
    return [s[:, 0] for s in states], [s[:, 1:] for s in states], drops


def _wyllie_pass(ptr: list, comm, el_cap: int, c_req: int, rounds: int):
    """Pointer doubling over ranks [reference wyllie, :282-305]: (steps to
    the terminal, the terminal's gid, requests dropped). Dead rows fetch
    nothing, which keeps the slabs balanced: their own ids would all go to
    one rank."""
    states = [
        torch.stack([p, (p >= 0).to(torch.int64), torch.where(p >= 0, p, _gids(rank, el_cap, p.device))], 1)
        for p, rank in zip(ptr, comm.ranks)
    ]
    drops = [torch.zeros((), dtype=torch.int64, device=comm.device) for _ in ptr]
    for _ in range(rounds):
        ptrs = [s[:, 0] for s in states]
        if not _any_alive(ptrs, comm):
            break
        rows, dr = exchange_gather(states, ptrs, comm, el_cap, c_req)
        nxt = []
        for s, r in zip(states, rows):
            alive = s[:, 0] >= 0
            nxt.append(torch.stack([
                torch.where(alive, r[:, 0], -1),
                s[:, 1] + torch.where(alive, r[:, 1], 0),
                torch.where(alive, r[:, 2], s[:, 2]),
            ], 1))
        states = nxt
        drops = [a + b for a, b in zip(drops, dr)]
    return [s[:, 1] for s in states], [s[:, 2] for s in states], drops


def dist_chains_step(words: list, n: list, comm, k: int, c_local: int, slab_factor: float = 2.0) -> ShardChains:
    """Sharded spectrum -> ``ShardChains`` [reference make_dist_chains_step,
    :207]. ``words[j]`` is a held rank's [c_local] (or [c_local, W]) shard,
    valid in rows [0, n[j])."""
    world, el_cap = comm.world, 2 * c_local
    rounds = _log2_ceil(world * el_cap) + 1
    c_node, c_req = slab_sizes(c_local, world, slab_factor)

    edge_words, valid = [], []
    for w, nj in zip(words, n):
        row_valid = torch.arange(c_local, device=w.device) < nj
        edge_words.append(torch.cat([w, keys.revcomp(w, k)]))
        valid.append(torch.cat([row_valid, row_valid]))

    succ, succ_lastb, has_pred, pred, tail_dead, head_dead, drops = _node_record_exchange(
        edge_words, valid, comm, k, el_cap, c_node
    )
    # transition keys, for the cycle cut: the canonical (k+1)-mer of an edge
    # and its successor's last base, as its words (never a dense rank, which
    # would take a global sort)
    t = [
        keys.select(s >= 0, keys.canonical_tkey(keys.append_base(w, lb, k), k + 1), keys.SENT)
        for w, lb, s in zip(edge_words, succ_lastb, succ)
    ]
    del succ_lastb
    ptr, least, dr = _detect_pass(succ, t, comm, el_cap, c_req, rounds)
    drops = [a + b for a, b in zip(drops, dr)]
    on_cycle = [(p >= 0) & v for p, v in zip(ptr, valid)]
    is_cut = [c & (_cols(x) == m).all(dim=1) for c, x, m in zip(on_cycle, t, least)]
    del ptr, least, t
    succ_cut = [torch.where(c, -1, s) for c, s in zip(is_cut, succ)]

    # a cut edge's successor starts a chain (one writer an edge)
    ones = [torch.ones((el_cap, 1), dtype=torch.int64, device=comm.device) for _ in succ]
    started, dp = exchange_push(ones, [torch.where(c, s, -1) for c, s in zip(is_cut, succ)], comm, el_cap, c_req)
    drops = [a + b for a, b in zip(drops, dp)]
    del ones, succ, is_cut
    is_start = [v & (~hp | (st[:, 0] == 1)) for v, hp, st in zip(valid, has_pred, started)]
    pred_cut = [torch.where(st, -1, p) for st, p in zip(is_start, pred)]
    del started, has_pred, pred

    # forward -> the chain id (its end edge's gid); backward -> the position
    _, end_gid, dr = _wyllie_pass(succ_cut, comm, el_cap, c_req, rounds)
    drops = [a + b for a, b in zip(drops, dr)]
    pos, _, dr = _wyllie_pass(pred_cut, comm, el_cap, c_req, rounds)
    drops = [a + b for a, b in zip(drops, dr)]
    return ShardChains(
        edge_words=edge_words,
        valid=valid,
        chain=[torch.where(v, e, -1) for v, e in zip(valid, end_gid)],
        pos=[torch.where(v, p, 0) for v, p in zip(valid, pos)],
        is_start=is_start,
        tail_dead=tail_dead,
        head_dead=head_dead,
        on_cycle=on_cycle,
        dropped=drops,
    )


def dist_cutoff_step(words: list, counts: list, n: list, min_count: int):
    """The frequency cutoff, shard by shard (a shard's counts are already
    the global ones) [reference make_dist_cutoff_step, :345]."""
    cut = [apply_cutoff(Spectrum(w, c, nj), min_count) for w, c, nj in zip(words, counts, n)]
    return [s.words for s in cut], [s.counts for s in cut], [s.n for s in cut]


def dist_compact_step(words: list, counts: list, n: list, keep: list):
    """Each shard compacted to its rows that ``keep`` [c_local] marks
    [reference make_dist_compact_step, :624]."""
    out_w, out_c, out_n = [], [], []
    for w, c, nj, kp in zip(words, counts, n, keep):
        k2 = kp & (torch.arange(w.shape[0], device=w.device) < nj)
        kept_w, kept_c = w[k2], c[k2]
        m = kept_w.shape[0]
        nw, nc = torch.zeros_like(w), torch.zeros_like(c)
        nw[:m], nc[:m] = kept_w, kept_c
        out_w.append(nw)
        out_c.append(nc)
        out_n.append(m)
    return out_w, out_c, out_n


# --- emission -----------------------------------------------------------------


def local_chain_fragments(sc: ShardChains, k: int) -> dict:
    """Contig fragments from the shards this process holds [reference
    local_chain_fragments, :363]: for every valid edge its chain id, its
    position and one base, and for every chain start held here its
    (k-1)-base prefix. The valid edges are selected on the device, so only
    this compact material is copied; ``d2h_bytes`` is what was copied.

    Returns dict(chain, pos, base, start_chain, start_prefix, d2h_bytes)."""
    from tpu_euler_torch.euler.extract import decode_bases_np

    d2h = 0

    def host(x: torch.Tensor) -> np.ndarray:
        nonlocal d2h
        a = x.cpu().numpy()
        d2h += a.nbytes
        return a

    chain, pos, base, start_chain, start_words = [], [], [], [], []
    for j in range(len(sc.valid)):
        idx = torch.nonzero(sc.valid[j]).squeeze(1)
        starts = idx[sc.is_start[j][idx]]
        chain.append(host(sc.chain[j][idx]))
        pos.append(host(sc.pos[j][idx]))
        base.append(host(keys.last_base(sc.edge_words[j][idx]).to(torch.uint8)))
        start_chain.append(host(sc.chain[j][starts]))
        start_words.append(host(sc.edge_words[j][starts]))
    start_words = np.concatenate(start_words)
    return dict(
        chain=np.concatenate(chain),
        pos=np.concatenate(pos),
        base=np.concatenate(base),
        start_chain=np.concatenate(start_chain),
        start_prefix=(
            decode_bases_np(start_words, k - 1, k) if start_words.shape[0] else np.zeros((0, k - 1), np.uint8)
        ),
        d2h_bytes=d2h,
    )


def assemble_contig_fragments(frags: list[dict], k: int) -> set[bytes]:
    """The processes' fragments merged into the canonical contig set, on
    the host [reference assemble_contig_fragments, :413]."""
    from tpu_euler_torch.euler.extract import _BASES, canonicalize_contig_buffer

    chain = np.concatenate([f["chain"] for f in frags])
    if chain.size == 0:
        return set()
    pos = np.concatenate([f["pos"] for f in frags])
    base = np.concatenate([f["base"] for f in frags])
    start_chain = np.concatenate([f["start_chain"] for f in frags])
    start_prefix = np.concatenate([f["start_prefix"] for f in frags], axis=0)

    uchain, dense = np.unique(chain, return_inverse=True)
    chain_len = np.zeros(uchain.size, dtype=np.int64)
    np.maximum.at(chain_len, dense, pos + 1)
    off = np.zeros(uchain.size + 1, dtype=np.int64)
    np.cumsum(chain_len + (k - 1), out=off[1:])
    buf = np.empty(off[-1], dtype=np.uint8)
    buf[off[dense] + (k - 1) + pos] = _BASES[base]
    sdense = np.searchsorted(uchain, start_chain)
    buf[off[sdense][:, None] + np.arange(k - 1)[None, :]] = start_prefix
    return canonicalize_contig_buffer(buf, off)


def _allgather_fragments(frag: dict, comm) -> list[dict]:
    """Every process's fragments on every process [reference
    _allgather_fragments, :467]: the ragged arrays are padded to the
    longest and gathered through the comm's device, (chain, pos) as int64
    and the bases and prefixes as bytes."""
    sizes = comm.process_allgather([frag["chain"].size, frag["start_chain"].size])
    # at least a row, so that no collective is empty
    me, ms = max(1, int(sizes[:, 0].max())), max(1, int(sizes[:, 1].max()))

    def gather(a: np.ndarray, m: int) -> np.ndarray:
        out = np.zeros((m,) + a.shape[1:], a.dtype)
        out[: a.shape[0]] = a
        got = comm.all_gather([torch.from_numpy(out).to(comm.device)])[0]
        return got.cpu().numpy().reshape((comm.world, m) + a.shape[1:])

    edges = gather(np.stack([frag["chain"], frag["pos"]], 1), me)
    base = gather(frag["base"], me)
    start_chain = gather(frag["start_chain"], ms)
    start_prefix = gather(frag["start_prefix"], ms)
    return [
        dict(
            chain=edges[p, :ne, 0], pos=edges[p, :ne, 1], base=base[p, :ne],
            start_chain=start_chain[p, :ns], start_prefix=start_prefix[p, :ns], d2h_bytes=0,
        )
        for p, (ne, ns) in enumerate((int(a), int(b)) for a, b in sizes)
    ]


def shard_chains_to_contigs(sc: ShardChains, comm, k: int) -> set[bytes]:
    """The canonical contigs of sharded chains, the full set on every
    process [reference shard_chains_to_contigs, :446]. A process that holds
    every rank (``LoopbackComm``) has all fragments already; otherwise the
    processes exchange theirs."""
    frag = local_chain_fragments(sc, k)
    frags = [frag] if len(comm.ranks) == comm.world else _allgather_fragments(frag, comm)
    return assemble_contig_fragments(frags, k)


# --- tips ---------------------------------------------------------------------


def _sum_over_ranks(comm, *per_rank: list) -> list[int]:
    """The sums over all ranks of per-rank 0-d counts, the same on every
    rank: one all-reduce of a row a rank."""
    rows = [torch.stack([x.to(torch.int64) for x in xs]) for xs in zip(*per_rank)]
    return [int(x) for x in comm.all_reduce_sum(rows)[0]]


def dist_tip_step(sc: ShardChains, comm, tip_len: int, c_local: int, slab_factor: float = 2.0):
    """Sharded tip identification [reference make_dist_tip_step, :517]: a
    chain is a tip iff it has fewer than ``tip_len`` edges and exactly one
    dead end. A chain's home is its end edge, which knows the length (its
    own position + 1) and ``head_dead``; the start edge pushes its
    ``tail_dead`` there (one writer a home), and every member reads the
    verdict back.

    Returns (keep: a rank's [c_local] bool spectrum rows to keep; tip edges
    and slab drops, each summed over all ranks)."""
    world, el_cap = comm.world, 2 * c_local
    _, c_req = slab_sizes(c_local, world, slab_factor)
    held = range(len(sc.valid))
    dead_start, d1 = exchange_push(
        [sc.tail_dead[j].to(torch.int64)[:, None] for j in held],
        [torch.where(sc.valid[j] & (sc.pos[j] == 0), sc.chain[j], -1) for j in held],
        comm, el_cap, c_req, combine="max",
    )
    tip_home = []
    for j, rank in zip(held, comm.ranks):
        is_home = sc.valid[j] & (sc.chain[j] == _gids(rank, el_cap, comm.device))
        tip_home.append(
            (is_home & (sc.pos[j] + 1 < tip_len) & ((dead_start[j][:, 0] == 1) ^ sc.head_dead[j])).to(torch.int64)[:, None]
        )
    tips, d2 = exchange_gather(
        tip_home, [torch.where(sc.valid[j], sc.chain[j], -1) for j in held], comm, el_cap, c_req,
        fill=torch.zeros(1, dtype=torch.int64, device=comm.device),
    )
    tip_edge = [sc.valid[j] & (tips[j][:, 0] == 1) for j in held]
    keep = [~(te[:c_local] | te[c_local:]) for te in tip_edge]
    n_tips, drops = _sum_over_ranks(comm, [te.sum() for te in tip_edge], [a + b for a, b in zip(d1, d2)])
    return keep, n_tips, drops


def find_tip_rows(sc: ShardChains, comm, tip_len: int, c_local: int):
    """Tips on the host from the whole fetched arrays: the cross-check of
    ``dist_tip_step`` [reference find_tip_rows, :578].

    Returns (keep [world * c_local] bool numpy, tip edges)."""
    valid = fetch_global(comm, sc.valid)
    chain = fetch_global(comm, sc.chain)
    pos = fetch_global(comm, sc.pos)
    tail_dead = fetch_global(comm, sc.tail_dead)
    head_dead = fetch_global(comm, sc.head_dead)
    idx = np.flatnonzero(valid)
    uchain, dense = np.unique(chain[idx], return_inverse=True)
    length = np.zeros(uchain.size, np.int64)
    np.maximum.at(length, dense, pos[idx] + 1)
    ds, de = np.zeros(uchain.size, bool), np.zeros(uchain.size, bool)
    starts = pos[idx] == 0
    ds[dense[starts]] = tail_dead[idx][starts]
    ends = pos[idx] == length[dense] - 1
    de[dense[ends]] = head_dead[idx][ends]
    tip_edge = np.zeros(valid.shape[0], bool)
    tip_edge[idx] = ((length < tip_len) & (ds ^ de))[dense]
    # edge row i of rank r is spectrum row r * c_local + i % c_local
    tip_edge = tip_edge.reshape(comm.world, 2, c_local)
    return ~tip_edge.any(axis=1).reshape(-1), int(tip_edge.sum())


# --- bubbles --------------------------------------------------------------------


def _serve_bubble_records(recv: torch.Tensor, W: int, bubble_len: int) -> torch.Tensor:
    """The (u, v) owner's half [reference :780-827]. A record is (u [W], v
    [W], -coverage, minimum key [W], length). Sorted by all but the length,
    a group's first record is its winner; every other record of a group is
    popped, unless the group holds a chain of ``bubble_len`` edges or more,
    or its first two records tie. Returns one int64 a slab row, 1 = popped."""
    reply = torch.zeros(recv.shape[0], dtype=torch.int64, device=recv.device)
    idx = torch.nonzero(recv[:, 0] != keys.SENT).squeeze(1)
    n = idx.numel()
    if n == 0:
        return reply
    s, perm = keys.sort(recv[idx, : 3 * W + 1])
    t_len = recv[idx, 3 * W + 1][perm]
    prev_same = torch.zeros(n, dtype=torch.bool, device=recv.device)
    prev_same[1:] = (s[1:, : 2 * W] == s[:-1, : 2 * W]).all(dim=1)
    seg, starts, ends = _segment_bounds(~prev_same)
    seg_big = _segment_sums((t_len >= bubble_len).to(torch.int64), starts, ends)
    # the second record of a group equal to the first in coverage and key
    tie = torch.zeros(n, dtype=torch.bool, device=recv.device)
    tie[1:] = prev_same[1:] & ~prev_same[:-1] & (s[1:, 2 * W :] == s[:-1, 2 * W :]).all(dim=1)
    seg_tie = _segment_sums(tie.to(torch.int64), starts, ends)
    reply[idx[perm]] = (prev_same & (seg_big[seg] == 0) & (seg_tie[seg] == 0)).to(torch.int64)
    return reply


def dist_bubble_step(
    sc: ShardChains, counts: list, comm, k: int, bubble_len: int, c_local: int, slab_factor: float = 2.0
):
    """Sharded simple-bubble identification [reference make_dist_bubble_step,
    :648]: the chains that are not cut cycles group by (start node u, end
    node v); a group of two or more, all shorter than ``bubble_len`` edges,
    keeps only its winner by (coverage descending, minimum canonical k-mer
    ascending), and a tie at the top skips the group.

    1. Member edges push their chain's aggregates to its home (the end
       edge): the coverage sum (``add``, int64) and the start edge's
       canonical tail (k-1)-mer. That one is a ``max`` push of several
       columns, which ``scatter_reduce_`` combines a column apart: it is
       right only because one edge, the start, writes each home.
    2. The chain's minimum canonical k-mer, exactly: a column-wise minimum
       of several words would mix words of different keys, so the words go
       one at a time, most significant first, and word j's candidates are
       only the edges whose words before j equal the minimum so far (one
       push-min and one gather a word).
    3. The homes send (u, v, -coverage, minimum key, length) to the owner
       of hash(u, v), which sorts and judges (``_serve_bubble_records``),
       and the verdicts come back along the slabs.
    4. Every member reads its chain's verdict from the home.

    The home's own ``on_cycle`` excludes cut cycles: every edge of one lay
    on the cycle. ``counts[j]`` is a rank's [c_local] spectrum counts.

    Returns (keep: a rank's [c_local] bool spectrum rows to keep; edges
    popped and slab drops, each summed over all ranks)."""
    world, el_cap = comm.world, 2 * c_local
    _, c_req = slab_sizes(c_local, world, slab_factor)
    c_grp = c_req
    L = keys.nlimbs(k)
    held = range(len(sc.valid))
    dev = comm.device
    member = [sc.valid[j] & ~sc.on_cycle[j] for j in held]
    to_home = [torch.where(m, sc.chain[j], -1) for j, m in zip(held, member)]
    drops = [torch.zeros((), dtype=torch.int64, device=dev) for _ in held]

    def add_drops(d):
        nonlocal drops
        drops = [a + b for a, b in zip(drops, d)]

    # --- 1: coverage sum and the start node to the home
    covs, d = exchange_push(
        [torch.where(m, torch.cat([c, c]).to(torch.int64), 0)[:, None] for m, c in zip(member, counts)],
        to_home, comm, el_cap, c_req, combine="add",
    )
    add_drops(d)
    starts = [sc.is_start[j] & m for j, m in zip(held, member)]
    u_home, d = exchange_push(
        [
            torch.where(st[:, None], _cols(keys.canonical(keys.prefix(sc.edge_words[j]), k - 1)[0]), 0)
            for j, st in zip(held, starts)
        ],
        [torch.where(st, sc.chain[j], -1) for j, st in zip(held, starts)],
        comm, el_cap, c_req, combine="max",
    )
    add_drops(d)
    del starts

    # --- 2: the exact minimum canonical k-mer, a word at a time
    # an edge's canonical k-mer is its spectrum row (rows >= c_local mirror)
    rk = [_cols(torch.cat([sc.edge_words[j][:c_local], sc.edge_words[j][:c_local]])) for j in held]
    W = rk[0].shape[1]
    sent = torch.full((1,), keys.SENT, dtype=torch.int64, device=dev)
    pref_ok = member
    min_cols = []
    for w in range(W):
        mw, d = exchange_push(
            [torch.where(ok, r[:, w], keys.SENT)[:, None] for ok, r in zip(pref_ok, rk)],
            to_home, comm, el_cap, c_req, combine="min",
        )
        add_drops(d)
        back, d = exchange_gather(mw, to_home, comm, el_cap, c_req, fill=sent)
        add_drops(d)
        pref_ok = [ok & (r[:, w] == b[:, 0]) for ok, r, b in zip(pref_ok, rk, back)]
        min_cols.append(mw)
    del rk, pref_ok, back

    # --- 3: a record a chain to the owner of hash(u, v)
    placed, slabs = [], []
    for j, rank in zip(held, comm.ranks):
        home = member[j] & (sc.chain[j] == _gids(rank, el_cap, dev))
        v = _cols(keys.canonical(keys.suffix(sc.edge_words[j], k), k - 1)[0])
        owner = torch.where(home, keys.bucket_hash(v, L, keys.bucket_hash(u_home[j], L)) % world, world)
        rows, slots, n_dropped = owner_slots(owner, world, c_grp)
        rec = torch.cat([u_home[j], v, -covs[j]] + [m[j] for m in min_cols] + [(sc.pos[j] + 1)[:, None]], 1)
        slab = torch.full((world * c_grp, rec.shape[1]), keys.SENT, dtype=torch.int64, device=dev)
        slab[slots] = take_rows(rec, rows)
        slabs.append(slab)
        placed.append((rows, slots))
        drops[j] = drops[j] + n_dropped
    del u_home, covs, min_cols
    replies = [_serve_bubble_records(recv, W, bubble_len) for recv in comm.all_to_all(slabs)]
    del slabs
    popped_home = []
    for (rows, slots), back in zip(placed, comm.all_to_all(replies)):
        ph = torch.zeros((el_cap, 1), dtype=torch.int64, device=dev)
        ph[rows, 0] = back[slots]
        popped_home.append(ph)

    # --- 4: the members read their chain's verdict
    verdict, d = exchange_gather(
        popped_home, to_home, comm, el_cap, c_req, fill=torch.zeros(1, dtype=torch.int64, device=dev)
    )
    add_drops(d)
    pop_edge = [m & (vd[:, 0] == 1) for m, vd in zip(member, verdict)]
    keep = [~(pe[:c_local] | pe[c_local:]) for pe in pop_edge]
    n_popped, n_drops = _sum_over_ranks(comm, [pe.sum() for pe in pop_edge], drops)
    return keep, n_popped, n_drops
