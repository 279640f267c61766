"""Unitig chains by successor assignment, cycle cutting and list ranking.

Counterpart of ``tpu_euler/euler/unitigs.py`` (the spectrum-based path):

1. ``successor``: succ[e] = the unique out-edge of head(e) when head(e) is
   simple (in = out = 1), else -1. Chains of succ links are the unitigs.
2. Pure cycles are cut at every transition whose canonical (k+1)-mer
   (``transition_keys_spec``) is the cycle's minimum: strand-symmetric and
   deterministic, as in the CPU oracle.
3. The cut list is ranked (distance to chain end, end-edge label); positions
   and lengths follow.

``chains_from_t`` uses the sparse-ruling-set walk (``ranking.py``) above
``min_edges`` and pointer doubling below it or when the walk reports an
overflow. Pointers use -1 for "none" where the reference used an all-ones
uint32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_euler_torch.euler import ranking_kernel
from tpu_euler_torch.graph.build import DeBruijnGraph
from tpu_euler_torch.kmer import keys


class UnitigChains(NamedTuple):
    """Per-edge chain assignment. Edges with ``in_chain`` False are padding."""

    chain: torch.Tensor  # [E] int64 chain id (the id of the chain's END edge), -1 if none
    pos: torch.Tensor  # [E] int64 0-based position of the edge within its chain
    length: torch.Tensor  # [E] int64 total chain length (edges), per edge
    is_start: torch.Tensor  # [E] bool pos == 0
    from_cycle: torch.Tensor  # [E] bool chain was cut from a pure cycle
    in_chain: torch.Tensor  # [E] bool edge is valid / participates


def _log2_ceil(n: int) -> int:
    return max(1, (n - 1).bit_length())


def successor(g: DeBruijnGraph) -> torch.Tensor:
    """succ[e]: the unique following edge through a simple head node, else -1."""
    h = torch.clamp(g.head, 0, g.succ_cand.shape[0] - 1)
    return torch.where(g.edge_valid, g.succ_cand[h], -1)


def transition_keys_spec(words: torch.Tensor, succ: torch.Tensor, k: int) -> torch.Tensor:
    """t[e] = canonical (k+1)-mer of edge e + its successor's last base;
    ``keys.SENT`` where succ < 0. Edge keys come from the virtual doubled
    array: a reverse row's last base is the complement of its forward row's
    first base.

    For k <= 31, t is the (k+1)-mer as a tkey (``keys.to_tkey``). For k > 31
    the (k+1)-mers are multi-word keys, and t is their dense rank among the
    valid ones (``keys.dense_rank``): the cycle cut and the ruling walk use
    only the order and equality of t, which the rank keeps, so everything
    downstream stays one int64 per edge."""
    C = words.shape[0]
    E = succ.shape[0]
    sc = torch.clamp(succ, 0, E - 1)
    is_rev = sc >= C
    w = words[torch.where(is_rev, sc - C, sc)]
    nb = torch.where(is_rev, 3 - keys.first_base(w, k), keys.last_base(w))
    t_f = keys.canonical_tkey(keys.append_base(words, nb[:C], k), k + 1)
    t_r = keys.canonical_tkey(
        keys.append_base(keys.revcomp(words, k), nb[C:], k), k + 1
    )
    t = keys.select(succ >= 0, torch.cat([t_f, t_r]), keys.SENT)
    return t if keys.nwords(k) == 1 else keys.dense_rank(t)


def transition_keys(g: DeBruijnGraph, succ: torch.Tensor, k: int) -> torch.Tensor:
    """``transition_keys_spec`` of a graph with materialized edge keys in
    the doubled layout of ``build_graph``: its first half is the spectrum
    [reference transition_keys, :123]."""
    return transition_keys_spec(g.edge_words[: g.edge_words.shape[0] // 2], succ, k)


def wyllie_rank(succ: torch.Tensor, rounds: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Wyllie list ranking: (distance to chain end, end-edge label) per edge,
    ``rounds`` rounds of ``ranking_kernel.jump_rank`` (a kernel launch a
    round on the card)."""
    eid = torch.arange(succ.shape[0], device=succ.device)
    d = (succ >= 0).to(torch.int64)
    q = torch.where(succ >= 0, succ, eid)
    _, d, q = ranking_kernel.jump_rank(succ, d, q, rounds)
    return d, q


def cut_cycles_from_t(
    t: torch.Tensor, edge_valid: torch.Tensor, succ: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Cut pure cycles at their minimum transition keys by min-propagating
    pointer doubling (``ranking_kernel.jump_min``). Returns (cut successor
    array, on_cycle)."""
    p, m = ranking_kernel.jump_min(succ, t, _log2_ceil(succ.shape[0]) + 1)
    on_cycle = (p >= 0) & edge_valid
    is_cut = on_cycle & (t == m)
    return torch.where(is_cut, -1, succ), on_cycle


def _chains_from_rank(edge_valid, succ, d, end_edge, on_cycle) -> UnitigChains:
    """Assemble the UnitigChains record from a ranked cut successor array."""
    E = succ.shape[0]
    has_pred = torch.zeros(E + 1, dtype=torch.bool, device=succ.device)
    has_pred[torch.where(succ >= 0, succ, E)] = True
    is_start = edge_valid & ~has_pred[:E]
    len_at_end = torch.zeros(E + 1, dtype=torch.int64, device=succ.device)
    len_at_end[torch.where(is_start, end_edge, E)] = d + 1
    length = torch.where(edge_valid, len_at_end[torch.clamp(end_edge, 0, E - 1)], 0)
    return UnitigChains(
        chain=torch.where(edge_valid, end_edge, -1),
        pos=torch.where(edge_valid, length - 1 - d, 0),
        length=length,
        is_start=is_start,
        from_cycle=on_cycle,
        in_chain=edge_valid,
    )


def _doubling_chains_from_t(t, edge_valid, succ0) -> UnitigChains:
    """Doubling-path chain computation from precomputed transition keys."""
    succ, on_cycle = cut_cycles_from_t(t, edge_valid, succ0)
    d, end_edge = wyllie_rank(succ, _log2_ceil(succ0.shape[0]) + 1)
    return _chains_from_rank(edge_valid, succ, d, end_edge, on_cycle)


def unitig_chains(g: DeBruijnGraph, k: int) -> UnitigChains:
    """Chains of a ``build_graph`` graph by pointer doubling [reference
    unitig_chains, :277]."""
    succ0 = successor(g)
    return _doubling_chains_from_t(transition_keys(g, succ0, k), g.edge_valid, succ0)


def _apply_cut(succ0, t, on_cycle, cyc_min):
    is_cut = on_cycle & (t == cyc_min)
    return torch.where(is_cut, -1, succ0), is_cut


def chains_from_t(
    t: torch.Tensor | list,
    edge_valid: torch.Tensor,
    succ0: torch.Tensor,
    min_edges: int = 1 << 17,
    t_factory=None,
) -> UnitigChains:
    """Chains via the ruling-set walk (one walk: the cycle walk's tables also
    rank the cut list); doubling for E <= ``min_edges`` and as the fallback
    when the walk reports an overflow or a broken invariant.

    ``t`` may be handed over as a one-element list ``[t]``: it is popped
    here and, when ``t_factory`` is given, dropped right after the cycle cut,
    so its [E] int64 is freed before the cut-rank phase; the fallbacks then
    recompute it with ``t_factory()``. A bare tensor, or no factory, keeps t
    for the fallbacks."""
    from tpu_euler_torch.euler import ranking

    if isinstance(t, list):
        t = t.pop()
    E = succ0.shape[0]
    if E <= min_edges:
        return _doubling_chains_from_t(t, edge_valid, succ0)
    res = ranking.cycle_min_ruling_tables(succ0, edge_valid, t)
    if res is None:
        return _doubling_chains_from_t(t, edge_valid, succ0)
    on_cycle, cyc_min, owner_off, tabs, succ_c = res
    succ, is_cut = _apply_cut(succ0, t, on_cycle, cyc_min)
    del res, cyc_min
    if t_factory is not None:
        t = None
    rr = ranking.rank_chains_with_cut(succ, edge_valid, is_cut, owner_off, tabs, succ_c)
    del owner_off, tabs, succ_c, is_cut
    if rr is None:
        rr = ranking.rank_chains_ruling(succ, edge_valid)
    if rr is None:
        return _doubling_chains_from_t(t if t_factory is None else t_factory(), edge_valid, succ0)
    d, end_edge = rr
    return _chains_from_rank(edge_valid, succ, d, end_edge, on_cycle)


def chains_from_successors_spec(
    words: torch.Tensor,
    edge_valid: torch.Tensor,
    succ0: torch.Tensor,
    k: int,
    min_edges: int = 1 << 17,
) -> UnitigChains:
    """``chains_from_t`` over the virtual doubled edge array."""
    return chains_from_t(
        transition_keys_spec(words, succ0, k), edge_valid, succ0, min_edges
    )
