"""Eulerian tour: successor pairing, circuit labels, rotation merge.

Counterpart of ``tpu_euler/euler/tour.py`` (see its docstring for why the
merge converges):

* pairing: the i-th in-edge of every node is followed by its i-th out-edge
  (two stable sorts, one gather);
* labels: a cycle's edges take the smallest edge id on the cycle and a
  path's edges take E + the id of its last edge, the reference's pointer
  doubling at its converged round count (on the card a ruling-set pass of
  hand kernels, ``ranking_kernel.ruling_labels``; the plain doubling on the
  CPU);
* merge: each round, every circuit that is not the smallest-label chain at
  one of its vertices is spliced into that chain there, all circuits at a
  vertex in one rotation of successors. Only circuits are merged, always into
  a smaller label, so a round never splits a chain and the number of
  circuits falls geometrically. An Eulerian component ends as one circuit;
  a component with unbalanced nodes as paths that have absorbed every
  circuit they touch.

The reference runs the merge as one compiled ``while_loop``; here it is a
host loop that reads one flag a round (did any circuit merge) and stops at
the first round without a merge or at the same bound of 2 log2(E) + 4
rounds. Every minimum is taken by edge id, so the tour is the reference's
field by field. Pointers use -1 for "none".
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_euler_torch.euler import ranking_kernel
from tpu_euler_torch.euler.unitigs import _chains_from_rank, _log2_ceil, wyllie_rank
from tpu_euler_torch.graph.build import DeBruijnGraph


class EulerTour(NamedTuple):
    succ: torch.Tensor  # [E] int64 successor in the final tour (-1 = chain end)
    chain: torch.Tensor  # [E] int64 chain label (id of the chain's end edge), -1 if invalid
    pos: torch.Tensor  # [E] int64 position of the edge within its chain
    length: torch.Tensor  # [E] int64 chain length, per edge
    n_chains: int  # circuits + paths
    in_tour: torch.Tensor  # [E] bool valid edges
    merge_rounds: int  # merge rounds run


def _group_starts(node: torch.Tensor, valid: torch.Tensor, n_slots: int):
    """Edges in stable order of ``node`` (invalid edges last): (sorted node
    ids, edge ids in that order, rows that hold a valid edge, first sorted
    row of each node [n_slots], E where the node has no edge)."""
    E = node.shape[0]
    s_node, order = torch.sort(torch.where(valid, node, n_slots), stable=True)
    sv = s_node < n_slots
    row = torch.arange(E, device=node.device)
    first = torch.full((n_slots,), E, dtype=torch.int64, device=node.device)
    first.scatter_reduce_(0, s_node[sv], row[sv], "amin")
    return s_node, order, sv, first


def _pair_successors(g: DeBruijnGraph) -> torch.Tensor:
    """Pair the i-th in-edge of every node with its i-th out-edge."""
    E = g.tail.shape[0]
    dev = g.tail.device
    row = torch.arange(E, device=dev)
    # out-CSR: edges by tail; offset[v] = first slot of v's out-edges
    _, out_csr, _, offset = _group_starts(g.tail, g.edge_valid, 2 * E)
    # in-rank: position of e among the in-edges of head[e]
    s_head, in_edges, sv, head_start = _group_starts(g.head, g.edge_valid, 2 * E)
    inrank = torch.zeros(E, dtype=torch.int64, device=dev)
    inrank[in_edges[sv]] = row[sv] - head_start[s_head[sv]]

    h = torch.clamp(g.head, 0, g.outdeg.shape[0] - 1)
    slot = offset[h] + inrank
    paired = inrank < g.outdeg[h]  # the head has an out-edge left to pair with
    return torch.where(g.edge_valid & paired, out_csr[torch.clamp(slot, 0, E - 1)], -1)


def _labels(succ: torch.Tensor, valid: torch.Tensor, rounds: int):
    """(label [E], on_cycle [E]): a cycle's edges carry the smallest edge id
    on it, a path's edges E + their last edge's id, invalid edges 2E. The
    tour's ``rounds`` are log2_ceil(E) + 1, where the doubling has converged;
    fewer raise. On the card the ruling label kernels (``succ`` is
    injective: the pairing and the splices give each edge at most one
    predecessor)."""
    return ranking_kernel.ruling_labels(succ, valid, rounds)


def _merge_round(g: DeBruijnGraph, succ: torch.Tensor, rounds: int) -> tuple[torch.Tensor, bool]:
    """One merge round: (new successors, whether any circuit merged)."""
    E = succ.shape[0]
    dev = succ.device
    eid = torch.arange(E, device=dev)
    valid, tail = g.edge_valid, g.tail
    label, on_cycle = _labels(succ, valid, rounds)

    linked = succ >= 0
    pred = torch.full((E,), -1, dtype=torch.int64, device=dev)
    pred[succ[linked]] = eid[linked]

    # smallest label at each vertex (over its out-edges), and that chain's
    # representative out-edge there
    lmin = torch.full((2 * E,), 2 * E, dtype=torch.int64, device=dev)
    lmin.scatter_reduce_(0, tail[valid], label[valid], "amin")
    at_v = lmin[tail]
    is_min = valid & (label == at_v)
    rep = torch.full((2 * E,), E, dtype=torch.int64, device=dev)
    rep.scatter_reduce_(0, tail[is_min], eid[is_min], "amin")

    # sources: one edge a circuit whose label is not its vertex's smallest
    cand = valid & on_cycle & (label != at_v)
    by_label = torch.full((2 * E,), E, dtype=torch.int64, device=dev)
    by_label.scatter_reduce_(0, label[cand], eid[cand], "amin")
    is_src = cand & (by_label[torch.clamp(label, 0, 2 * E - 1)] == eid)
    if not bool(is_src.any()):
        return succ, False

    # a vertex with a source hosts a rotation, which its representative joins
    has_src = torch.zeros(2 * E, dtype=torch.bool, device=dev)
    has_src[tail[is_src]] = True
    is_rep = valid & has_src[tail] & (rep[tail] == eid)

    # rotation order at a vertex: the representative, then sources by label.
    # (vertex, source?, label) is one int64: vertex and label are below 2^31
    x = torch.nonzero(is_src | is_rep).squeeze(1)
    key = (tail[x] << 32) | (is_src[x].to(torch.int64) << 31) | label[x]
    sx = x[torch.sort(key).indices]
    sv = tail[sx]
    n = sx.shape[0]
    idx = torch.arange(n, device=dev)
    grp_new = torch.ones(n, dtype=torch.bool, device=dev)
    grp_new[1:] = sv[1:] != sv[:-1]
    gstart = torch.cummax(torch.where(grp_new, idx, -1), 0).values
    nxt_same = torch.zeros(n, dtype=torch.bool, device=dev)
    nxt_same[:-1] = ~grp_new[1:]
    nxt = torch.where(nxt_same, torch.roll(sx, -1), sx[gstart])
    # splice: succ[pred[x_i]] = x_{i+1 (mod group)}
    px = pred[sx]
    succ = succ.clone()
    succ[px[px >= 0]] = nxt[px >= 0]
    return succ, True


def eulerian_tour(g: DeBruijnGraph, max_rounds: int = 0) -> EulerTour:
    """Pair, then merge circuits to the fixed point (at most ``max_rounds``
    rounds, 0 = 2 log2(E) + 4), break what circuits remain at their smallest
    edge, and rank [reference eulerian_tour, :124]."""
    E = g.tail.shape[0]
    if E >= 1 << 30:
        raise ValueError(f"the rotation sort packs vertex and label into 31 bits each; E={E}")
    rounds = _log2_ceil(E) + 1
    succ = _pair_successors(g)
    limit = merge_limit(E, max_rounds)
    merge_rounds, changed = 0, True
    while changed and merge_rounds < limit:
        succ, changed = _merge_round(g, succ, rounds)
        merge_rounds += 1
    return _cut_and_rank(g, succ, rounds, merge_rounds)


def merge_limit(E: int, max_rounds: int = 0) -> int:
    """Most merge rounds: ``max_rounds``, or 2 log2(E) + 4 where it is 0."""
    return max_rounds or 2 * _log2_ceil(E) + 4


def _cut_and_rank(g: DeBruijnGraph, succ: torch.Tensor, rounds: int, merge_rounds: int) -> EulerTour:
    """Break each circuit left after the merge at its smallest edge, and
    rank the chains."""
    E = succ.shape[0]
    valid = g.edge_valid
    eid = torch.arange(E, device=succ.device)
    # the predecessor of each remaining circuit's smallest edge ends its chain
    label, on_cycle = _labels(succ, valid, rounds)
    is_cyc_min = on_cycle & (label == eid)
    cut = (succ >= 0) & is_cyc_min[torch.clamp(succ, 0, E - 1)] & on_cycle
    succ_cut = torch.where(cut, -1, succ)

    d, end_edge = wyllie_rank(succ_cut, rounds)
    c = _chains_from_rank(valid, succ_cut, d, end_edge, on_cycle)
    return EulerTour(
        succ=succ_cut,
        chain=c.chain,
        pos=c.pos,
        length=c.length,
        n_chains=int(c.is_start.sum()),
        in_tour=valid,
        merge_rounds=merge_rounds,
    )
