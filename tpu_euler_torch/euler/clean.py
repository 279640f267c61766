"""Graph cleaning: tip clipping and simple-bubble popping.

Counterpart of ``tpu_euler/euler/clean.py``. Reads with errors leave what
the frequency cutoff cannot always remove: short dead-end branches (tips) and
short parallel branches between the same two nodes (bubbles). Both passes
work round by round on a cut spectrum: build the graph, compute the unitig
chains, mark chains, drop the marked chains' spectrum rows (a row underlies
edges r and r + C, so both orientations go at once), and stop at the first
round that removes nothing. The rules are the CPU oracle's
(``oracle.find_tip_kmers``, ``oracle.find_bubble_kmers``).

One route a round. The reference has two (a monolithic graph with doubling
chains below 2^22 doubled edges, the staged build with the ruling-set walk
above) whose outputs are bit-identical; the port keeps the staged one, and
``chains_from_successors_spec`` itself takes the doubling chains on a small
graph.

Each round records two spans in the current trace (``trace.py``): ``clean:
graph`` round ``round_graph`` and ``clean: mark`` round the mark and the
compaction, both with the attributes ``kind`` ("tips" or "bubbles") and
``round``. Neither is a stage's: the pipeline's ``clean`` span holds them.

Scatters write through index sets selected first (``idx = id[mask]``). The
chain-table writes hit each slot once (one start and one end a chain); the
sums, minima and maxima over repeated indices go through ``scatter_add_``
and ``scatter_reduce_``, whose result does not depend on the order of the
writes.
"""

from __future__ import annotations

import torch

from tpu_euler_torch import trace
from tpu_euler_torch.euler.unitigs import (
    UnitigChains,
    chains_from_successors_spec,
    successor,
)
from tpu_euler_torch.graph.build import DeBruijnGraph, build_graph_staged
from tpu_euler_torch.kmer.count import Spectrum


def round_graph(spec: Spectrum, k: int) -> tuple[DeBruijnGraph, UnitigChains]:
    """One round's graph and chains [reference clip_tips_once_big, :94-101]."""
    g = build_graph_staged(spec, k)
    chains = chains_from_successors_spec(spec.words, g.edge_valid, successor(g), k)
    return g, chains


def _compact_rows(spec: Spectrum, drop_row: torch.Tensor) -> tuple[Spectrum, int]:
    """Remove the flagged rows; the rest keep their (key) order. Returns
    (spectrum of the same capacity, rows removed) [reference :131]."""
    valid_row = torch.arange(spec.words.shape[0], device=spec.words.device) < spec.n
    keep = valid_row & ~drop_row
    m = int(keep.sum())
    words = torch.zeros_like(spec.words)
    counts = torch.zeros_like(spec.counts)
    words[:m] = spec.words[keep]
    counts[:m] = spec.counts[keep]
    return Spectrum(words, counts, m), spec.n - m


def _chain_ends(g: DeBruijnGraph, chains: UnitigChains, member: torch.Tensor):
    """Of the chains whose edges are ``member``: (chain id, start node) at
    their start edges and (chain id, end node) at their end edges."""
    is_start = chains.is_start & member
    is_end = member & (chains.pos == chains.length - 1)
    return chains.chain[is_start], g.tail[is_start], chains.chain[is_end], g.head[is_end]


def _tip_mark(spec: Spectrum, g: DeBruijnGraph, chains: UnitigChains, tip_len: int):
    """Drop the rows of every chain of fewer than ``tip_len`` edges with
    exactly one dead end [reference _tip_mark, :28]."""
    E = chains.chain.shape[0]
    C = E // 2
    dev = chains.chain.device
    c_start, u, c_end, v = _chain_ends(g, chains, chains.in_chain)
    # chain-indexed dead flags (a chain's id is its end edge's id)
    dead_s = torch.zeros(E, dtype=torch.bool, device=dev)
    dead_s[c_start] = g.indeg[u] == 0
    dead_e = torch.zeros(E, dtype=torch.bool, device=dev)
    dead_e[c_end] = g.outdeg[v] == 0
    cid = torch.clamp(chains.chain, 0, E - 1)
    is_tip = chains.in_chain & (chains.length < tip_len) & (dead_s[cid] ^ dead_e[cid])
    return _compact_rows(spec, is_tip[:C] | is_tip[C:])


def _lexsort(*cols: torch.Tensor) -> torch.Tensor:
    """Permutation that orders rows by ``cols``, first column most
    significant: one stable pass a column, last column first."""
    perm = torch.sort(cols[-1], stable=True).indices
    for c in reversed(cols[:-1]):
        perm = perm[torch.sort(c[perm], stable=True).indices]
    return perm


def _bubble_mark(spec: Spectrum, g: DeBruijnGraph, chains: UnitigChains, bubble_len: int):
    """Drop the rows of every popped bubble branch [reference _bubble_mark,
    :145]: the chains not cut from a cycle group by (start node, end node);
    a group of two or more whose longest chain is under ``bubble_len`` keeps
    its first chain by (coverage descending, smallest row ascending) and
    loses the others, unless the first two tie on both.

    The reference sorts all E chain slots, the empty ones behind a
    sentinel, on four keys in one variadic sort; here only the slots that
    hold a chain are sorted, by (u, v) packed into one int64, then coverage,
    then smallest row, a stable pass each. Chains that tie on all four keys
    may come out in another order than the reference's. No output depends
    on it: a tie between the first two poisons the whole group, and the
    chains behind the first are all popped whatever their order.

    Coverage is an int64 sum (the reference's int32 sum wraps on a chain
    of some 10^8 edges); only groups of short chains pop, where the two
    agree.
    """
    E = chains.chain.shape[0]
    C = E // 2
    dev = chains.chain.device
    member = chains.in_chain & ~chains.from_cycle
    c_start, u, c_end, v = _chain_ends(g, chains, member)
    # chain-level tables, compact: slot j is chain c_start[j]
    n = c_start.numel()
    slot_of = torch.full((E,), -1, dtype=torch.int64, device=dev)
    slot_of[c_start] = torch.arange(n, device=dev)
    v_slot = torch.empty(n, dtype=torch.int64, device=dev)
    v_slot[slot_of[c_end]] = v
    clen = chains.length[chains.is_start & member]
    row = torch.arange(E, device=dev) % C
    e_slot = slot_of[chains.chain[member]]
    e_row = row[member]
    cov = torch.zeros(n, dtype=torch.int64, device=dev)
    cov.scatter_add_(0, e_slot, spec.counts[e_row].to(torch.int64))
    minrow = torch.full((n,), E, dtype=torch.int64, device=dev)
    minrow.scatter_reduce_(0, e_slot, e_row, "amin")

    uv = (u << 31) | v_slot  # node ids are below 2^31
    perm = _lexsort(uv, -cov, minrow)
    suv, scov, smin, slen = uv[perm], cov[perm], minrow[perm], clen[perm]
    prev_same = torch.zeros(n, dtype=torch.bool, device=dev)
    prev_same[1:] = suv[1:] == suv[:-1]
    seg = torch.cumsum(~prev_same, 0) - 1
    seg_maxlen = torch.zeros(n, dtype=torch.int64, device=dev)
    seg_maxlen.scatter_reduce_(0, seg, slen, "amax")
    second = prev_same.clone()
    second[1:] &= ~prev_same[:-1]
    tie = second.clone()
    tie[1:] &= (scov[1:] == scov[:-1]) & (smin[1:] == smin[:-1])
    seg_tied = torch.zeros(n, dtype=torch.int64, device=dev)
    seg_tied.scatter_reduce_(0, seg, tie.to(torch.int64), "amax")
    pop_sorted = prev_same & (seg_maxlen[seg] < bubble_len) & (seg_tied[seg] == 0)

    popped_chain = torch.zeros(E, dtype=torch.bool, device=dev)
    popped_chain[c_start[perm[pop_sorted]]] = True
    edge_popped = member & popped_chain[torch.clamp(chains.chain, 0, E - 1)]
    return _compact_rows(spec, edge_popped[:C] | edge_popped[C:])


def _rounds(spec: Spectrum, k: int, rounds: int, mark, threshold: int, kind: str) -> tuple[Spectrum, int]:
    total = 0
    for r in range(rounds):
        with trace.span("clean: graph", kind=kind, round=r):
            g, chains = round_graph(spec, k)
        with trace.span("clean: mark", kind=kind, round=r):
            spec, n = mark(spec, g, chains, threshold)
        total += n
        if n == 0:
            break
    return spec, total


def clip_tips(spec: Spectrum, k: int, tip_rounds: int, tip_len: int = 0) -> tuple[Spectrum, int]:
    """Clip tips for at most ``tip_rounds`` rounds, to the first round that
    removes nothing. Returns (spectrum, k-mers removed) [reference
    clip_tips, :109]."""
    return _rounds(spec, k, tip_rounds, _tip_mark, tip_len or 2 * k, "tips")


def pop_bubbles(
    spec: Spectrum, k: int, bubble_rounds: int, bubble_len: int = 0
) -> tuple[Spectrum, int]:
    """Pop simple bubbles for at most ``bubble_rounds`` rounds, to the first
    round that removes nothing [reference pop_bubbles, :250]."""
    return _rounds(spec, k, bubble_rounds, _bubble_mark, bubble_len or 2 * k, "bubbles")
