"""Sparse-ruling-set list ranking: O(E) traversal instead of O(E log E).

Counterpart of ``tpu_euler/euler/ranking.py``, step for step, so rulers,
walk rounds and tables are the reference's:

1. rulers = every chain head + a deterministic 1/RULER_STRIDE hash sample of
   element ids (+ self-loops for the cycle phase);
2. all rulers walk their sublists, one successor hop at a time, writing
   the packed owner word (gid << 8 | offset) into each visited element. A
   round stops after WALK_CAP hops; walks still alive continue next round
   from "virtual rulers" at their continuation elements. A round is
   ``ranking_kernel.walk_round``: one kernel launch on the card (a thread a
   ruler), the lockstep plain version on the CPU;
3. the contracted ruler-level list is ranked by pointer doubling
   (``ranking_kernel.jump_min`` / ``jump_rank``: one kernel launch a
   doubling on the card);
4. per-element results are one gather from the ruler tables.

Cycles that no ruler reached are resolved by doubling over the compacted
uncovered elements. ``None`` returns mean an overflow or a broken invariant;
callers fall back to full doubling.

Sentinels: pointers and element ids use -1; an element no walk covered has
owner word -1 (the reference's all-ones uint32); transition keys use
``keys.SENT``. Scatters that the reference drops with an out-of-range index
write to one spare slot past the end of the target instead, so no scatter
needs a host-side mask. A spare slot is cheap for a plain ``index_put_``,
whose dead lanes store to it without reading it; an atomic reduction
(``scatter_reduce_``) there costs one atomic a dead lane on one address,
one after another. So ``_cut_tables``, whose two minima run over every edge
for the few cut edges, no longer scatters on the card:
``ranking_kernel.cut_tables`` folds only the covered cut lanes (the plain
version, the two scatters, is the CPU path).
"""

from __future__ import annotations

import torch

from tpu_euler_torch.euler import ranking_kernel
from tpu_euler_torch.kmer import keys

RULER_STRIDE = 64  # expected elements per hash-sampled ruler
WALK_CAP = 128  # max hops per walk round (offsets must fit 8 bits)
_GID_BITS = 24  # packed owner word: [gid:24 | offset:8]
_INF = ranking_kernel.NO_CUT  # a gid's first-cut offset where it owns no cut


def _log2_ceil(n: int) -> int:
    return max(1, (n - 1).bit_length())


def _pow2(n: int, lo: int = 1 << 12) -> int:
    return 1 << max(_log2_ceil(max(1, n)), _log2_ceil(lo))


def _cap_rows(n: int, lo: int = 1 << 12) -> int:
    """Walk-frontier capacity: pow2 up to 64k, then a 16k granule."""
    n = max(int(n), lo)
    if n <= (1 << 16):
        return 1 << _log2_ceil(n)
    g = 1 << 14
    return -(-n // g) * g


def _hash_sample(n: int, device) -> torch.Tensor:
    h = keys._mix32(torch.arange(n, dtype=torch.int64, device=device))
    return h < (1 << 32) // RULER_STRIDE


def _pick_rulers(succ, valid, with_self: bool):
    """Ruler mask: valid chain heads + hash sample (+ self-loops)."""
    E = succ.shape[0]
    has_pred = torch.zeros(E + 1, dtype=torch.bool, device=succ.device)
    has_pred[torch.where(succ >= 0, succ, E)] = True
    is_ruler = valid & (~has_pred[:E] | _hash_sample(E, succ.device))
    if with_self:
        is_ruler |= succ == torch.arange(E, device=succ.device)
    return is_ruler


def _build_succ2(succ, is_ruler):
    """succ2[e] = succ[e], -1 at chain ends, -2-succ[e] when succ[e] is a
    ruler: the walk learns 'next is a ruler' from the same gather."""
    E = succ.shape[0]
    nxt_is_ruler = is_ruler[torch.clamp(succ, 0, E - 1)] & (succ >= 0)
    return torch.where(nxt_is_ruler, -2 - succ, succ)


def _compact(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """Element ids of the first ``cap`` set entries of ``mask``, -1 padded."""
    ids = torch.nonzero(mask).squeeze(1)[:cap]
    out = torch.full((cap,), -1, dtype=torch.int64, device=mask.device)
    out[: ids.numel()] = ids
    return out


def _empty_tables(S_cap: int, device, track_min: bool) -> dict:
    tabs = dict(
        elem=torch.full((S_cap,), -1, dtype=torch.int64, device=device),
        next_r=torch.full((S_cap,), -1, dtype=torch.int64, device=device),
        end_e=torch.full((S_cap,), -1, dtype=torch.int64, device=device),
        hops=torch.zeros(S_cap, dtype=torch.int64, device=device),
    )
    if track_min:
        tabs["mmin"] = torch.full((S_cap,), keys.SENT, dtype=torch.int64, device=device)
    return tabs


def _walk_start(succ, valid, t, with_self: bool):
    """A walk's state before its first round: (succ2 and owner_off, each
    with a spare slot at E, the t the walk reads, and the first frontier).
    With ``t`` (the cycle walk), succ2 and t are words 0 and 1 of one
    [E + 1, 2] record array, so the kernel reads both in one load a hop;
    the record holds a copy of t for the walk's life."""
    E = succ.shape[0]
    is_ruler = _pick_rulers(succ, valid, with_self)
    s_cap = _cap_rows(int(is_ruler.sum()))
    owner_off = torch.full((E + 1,), -1, dtype=torch.int64, device=succ.device)
    if t is None:
        succ2 = torch.cat([_build_succ2(succ, is_ruler), succ.new_zeros(1)])  # spare slot E: scatter drops
        return succ2, None, owner_off, _compact(is_ruler, s_cap)
    rec = torch.empty((E + 1, 2), dtype=torch.int64, device=succ.device)
    rec[:E, 0] = _build_succ2(succ, is_ruler)
    rec[E] = 0
    rec[:E, 1] = t[:E]
    return rec[:, 0], rec[:E, 1], owner_off, _compact(is_ruler, s_cap)


def _run_walk(succ, valid, t, track_min: bool, with_self: bool):
    """All walk rounds; returns (owner_off [E], ruler tables) or (None, None)
    on gid overflow. A round (``ranking_kernel.walk_round``: one kernel
    launch on the card) fills its rows of the tables and reads one count on
    the host (the capped walks, which size the next round)."""
    E = succ.shape[0]
    dev = succ.device
    succ2, t_walk, owner_off, frontier = _walk_start(succ, valid, t if track_min else None, with_self)
    s_cap = frontier.shape[0]
    base = 0
    S_cap = _pow2(2 * s_cap)  # headroom for virtual rulers
    tabs = _empty_tables(S_cap, dev, track_min)
    while True:
        if base + s_cap >= (1 << _GID_BITS):
            return None, None
        if base + s_cap > S_cap:
            S_cap = _pow2(base + s_cap)
            grown = _empty_tables(S_cap, dev, track_min)
            for name, v in tabs.items():
                grown[name][: v.shape[0]] = v
            tabs = grown
        capped, n = ranking_kernel.walk_round(succ2, t_walk, frontier, base, owner_off, WALK_CAP, tabs)
        base += s_cap
        if n == 0:
            break
        s_cap = _cap_rows(n)
        frontier = torch.full((s_cap,), -1, dtype=torch.int64, device=dev)
        frontier[:n] = capped
    return owner_off[:E], tabs


def _contract_succ(elem, next_r, E: int):
    """Contracted successor over ruler slots: slot -> slot of next ruler."""
    S = elem.shape[0]
    slot_of = torch.full((E + 1,), -1, dtype=torch.int64, device=elem.device)
    slot_of[torch.where(elem >= 0, elem, E)] = torch.arange(S, device=elem.device)
    return torch.where(next_r >= 0, slot_of[torch.clamp(next_r, 0, E - 1)], -1)


def _contracted_cycle_min(succ_c, mmin):
    """Min-propagating pointer doubling: (on_cycle, cycle min) per slot."""
    p, m = ranking_kernel.jump_min(succ_c, mmin, _log2_ceil(succ_c.shape[0]) + 1)
    return p >= 0, m


def _contracted_rank(succ_c, hops, end_e):
    """Weighted Wyllie over the contracted list: per slot (hops to chain end,
    chain-end element id, whether any slot never reached an end)."""
    S = succ_c.shape[0]
    q = torch.where(succ_c >= 0, succ_c, torch.arange(S, device=succ_c.device))
    p, d, q = ranking_kernel.jump_rank(succ_c, hops, q, _log2_ceil(S) + 1)
    chain_end = end_e[torch.clamp(q, 0, S - 1)]
    return d, chain_end, (p >= 0).any()


def _owner(owner_off, S: int):
    covered = owner_off >= 0
    gid = torch.clamp(owner_off >> 8, 0, S - 1)
    return covered, gid, owner_off & 0xFF


def _uncovered_cycle_min(succ, t, uncovered, u_cap: int):
    """Min-propagating doubling over the compacted uncovered elements (the
    members of ruler-free cycles, a subset closed under succ)."""
    E = succ.shape[0]
    dev = succ.device
    elem = _compact(uncovered, u_cap)
    live = elem >= 0
    ec = torch.clamp(elem, 0, E - 1)
    slot_of = torch.full((E + 1,), -1, dtype=torch.int64, device=dev)
    slot_of[torch.where(live, elem, E)] = torch.arange(u_cap, device=dev)
    succ_u = torch.where(live, slot_of[torch.clamp(succ[ec], 0, E - 1)], -1)
    m0 = torch.where(live, t[ec], keys.SENT)
    _, cmin_u = _contracted_cycle_min(succ_u, m0)
    cyc_min = torch.full((E + 1,), keys.SENT, dtype=torch.int64, device=dev)
    cyc_min[torch.where(live, ec, E)] = cmin_u
    return cyc_min[:E]


def cycle_min_ruling_tables(succ, valid, t):
    """(on_cycle [E], cycle-min transition key [E], owner_off, tables,
    contracted successor), or None on gid overflow. The tables let
    ``rank_chains_with_cut`` rank the cut list without a second walk."""
    owner_off, tabs = _run_walk(succ, valid, t, track_min=True, with_self=True)
    if owner_off is None:
        return None
    E = succ.shape[0]
    succ_c = _contract_succ(tabs["elem"], tabs["next_r"], E)
    ruler_on_cycle, ruler_min = _contracted_cycle_min(succ_c, tabs["mmin"])
    covered, g, _ = _owner(owner_off, succ_c.shape[0])
    on_cycle = covered & ruler_on_cycle[g]
    cyc_min = torch.where(on_cycle, ruler_min[g], keys.SENT)
    uncovered = (succ >= 0) & ~covered
    n_unc = int(uncovered.sum())
    if n_unc:
        cyc_min_u = _uncovered_cycle_min(succ, t, uncovered, _pow2(n_unc))
        on_cycle = on_cycle | uncovered
        cyc_min = torch.where(uncovered, cyc_min_u, cyc_min)
    return on_cycle, cyc_min, owner_off, tabs, succ_c


# ---------------------------------------------------------------------------
# Rank the CUT list from the cycle walk's tables. The cut changes the list
# only at cut edges, so per-gid first-cut tables + a contracted re-rank + a
# small compacted patch (elements past an intra-sublist cut, plus ruler-free
# cycle members) give every edge's (distance to end, end edge) exactly as
# rank_chains_ruling would.
# ---------------------------------------------------------------------------


def _cut_tables(is_cut, owner_off, succ_c):
    """Per gid (first-cut offset, cut-edge id at that offset); INF / E if
    none (``ranking_kernel.cut_tables``: the kernel on the card)."""
    return ranking_kernel.cut_tables(is_cut, owner_off, succ_c.shape[0])


def _patch_rank(succ_cut, patch, d_known, end_known, u_cap: int):
    """Weighted Wyllie over the compacted patch set with absorbing boundaries.

    A patch element whose successor is outside the patch absorbs that
    successor's known (d, end) as its initial hop weight / label. Returns
    per-edge (d, end, leaked); ``leaked`` flags a pointer still live after
    full doubling or an overflow of ``u_cap``.
    """
    E = succ_cut.shape[0]
    dev = succ_cut.device
    elem = _compact(patch, u_cap)
    live = elem >= 0
    ec = torch.clamp(elem, 0, E - 1)
    slot_of = torch.full((E + 1,), -1, dtype=torch.int64, device=dev)
    slot_of[torch.where(live, elem, E)] = torch.arange(u_cap, device=dev)
    slot_of = slot_of[:E]
    overflow = int(patch.sum()) > u_cap

    x = torch.where(live, succ_cut[ec], -1)
    xc = torch.clamp(x, 0, E - 1)
    x_in = (x >= 0) & (slot_of[xc] >= 0)
    sid = torch.arange(u_cap, device=dev)
    p = torch.where(live & x_in, slot_of[xc], -1)
    d = torch.where(~live | (x < 0), 0, torch.where(x_in, 1, 1 + d_known[xc]))
    e0 = torch.where(x < 0, ec, end_known[xc])  # own element at a real end
    q = torch.where(p >= 0, p, sid)
    p, d, q = ranking_kernel.jump_rank(p, d, q, _log2_ceil(u_cap) + 1)
    leaked = bool((live & (p >= 0)).any()) or overflow
    endp = e0[torch.clamp(q, 0, u_cap - 1)]
    d_e = torch.zeros(E + 1, dtype=torch.int64, device=dev)
    d_e[torch.where(live, ec, E)] = d
    end_e = torch.full((E + 1,), -1, dtype=torch.int64, device=dev)
    end_e[torch.where(live, ec, E)] = endp
    return d_e[:E], end_e[:E], leaked


def rank_chains_with_cut(succ_cut, valid, is_cut, owner_off, tabs, succ_c):
    """(distance to chain end, end-edge label) of the cut list from the cycle
    walk's tables; equals ``rank_chains_ruling(succ_cut, valid)``. Returns
    None if an invariant breaks."""
    E = valid.shape[0]
    m1, cut_edge = _cut_tables(is_cut, owner_off, succ_c)
    has_cut = m1 < _INF
    D, chain_end, has_cycle = _contracted_rank(
        torch.where(has_cut, -1, succ_c),
        torch.where(has_cut, m1, tabs["hops"]),
        torch.where(has_cut, cut_edge, tabs["end_e"]),
    )
    covered, g, off = _owner(owner_off, D.shape[0])
    known = valid & covered & (off <= m1[g])
    d = torch.where(known, D[g] - off, 0)
    end_edge = torch.where(known, chain_end[g], torch.arange(E, device=valid.device))
    patch = valid & ~known
    n = int(patch.sum())
    if n:
        dp, ep, leaked = _patch_rank(succ_cut, patch, d, end_edge, _pow2(n, lo=1 << 10))
        if leaked:
            return None
        d = torch.where(patch, dp, d)
        end_edge = torch.where(patch, ep, end_edge)
    if bool(has_cycle):
        return None  # a contracted cycle survived the cut
    return d, end_edge


def rank_chains_ruling(succ, valid):
    """(distance to chain end, end-edge label) per element of a cycle-free
    successor array. Returns None if a cycle leaked or on gid overflow."""
    owner_off, tabs = _run_walk(succ, valid, None, track_min=False, with_self=False)
    if owner_off is None:
        return None
    E = succ.shape[0]
    succ_c = _contract_succ(tabs["elem"], tabs["next_r"], E)
    D, chain_end, has_cycle = _contracted_rank(succ_c, tabs["hops"], tabs["end_e"])
    covered, g, off = _owner(owner_off, D.shape[0])
    d = torch.where(covered, D[g] - off, 0)
    end_edge = torch.where(covered, chain_end[g], torch.arange(E, device=succ.device))
    uncovered = (succ >= 0) & ~covered
    if bool(has_cycle) or bool(uncovered.any()):
        return None
    return d, end_edge
