"""Checks of graph and chain invariants, on the host, off the hot path.

Counterpart of ``tpu_euler/graph/validate.py``: each function returns the
list of violations it found, empty for a well-formed graph. The tensors are
brought to the host and checked with numpy.
"""

from __future__ import annotations

import numpy as np

from tpu_euler_torch.euler.unitigs import UnitigChains
from tpu_euler_torch.graph.build import DeBruijnGraph


def _np(t) -> np.ndarray:
    return t.cpu().numpy()


def validate_graph(g: DeBruijnGraph, k: int) -> list[str]:
    """Edge count, id ranges, degree sums and the strand symmetry of the
    degrees."""
    errs: list[str] = []
    valid = _np(g.edge_valid)
    tail, head = _np(g.tail)[valid], _np(g.head)[valid]
    n_nodes, n_edges = int(g.n_nodes), int(g.n_edges)
    if valid.sum() != n_edges:
        errs.append(f"edge_valid sum {valid.sum()} != n_edges {n_edges}")
    if n_edges % 2 != 0:
        errs.append("doubled graph must have an even number of edges")
    if tail.size and (tail.min() < 0 or tail.max() >= n_nodes):
        errs.append("tail ids out of range")
    if head.size and (head.min() < 0 or head.max() >= n_nodes):
        errs.append("head ids out of range")
    indeg, outdeg = _np(g.indeg)[:n_nodes], _np(g.outdeg)[:n_nodes]
    if indeg.sum() != n_edges or outdeg.sum() != n_edges:
        errs.append("degree sums != edge count")
    # every edge has its mirror, so the two degree multisets are equal
    if not np.array_equal(np.sort(indeg), np.sort(outdeg)):
        errs.append("in/out degree multisets differ (strand asymmetry)")
    return errs


def validate_chains(g: DeBruijnGraph, chains: UnitigChains, k: int) -> list[str]:
    """Every valid edge in exactly one (chain, position) slot, positions
    contiguous within a chain, consecutive edges adjacent in the graph."""
    errs: list[str] = []
    idx = np.flatnonzero(_np(chains.in_chain))
    chain, pos, length = _np(chains.chain)[idx], _np(chains.pos)[idx], _np(chains.length)[idx]
    tail, head = _np(g.tail)[idx], _np(g.head)[idx]
    order = np.lexsort((pos, chain))
    c, p = chain[order], pos[order]
    same = c[1:] == c[:-1]
    if (same & (p[1:] == p[:-1])).any():
        errs.append("duplicate (chain, pos) slots")
    gap = np.flatnonzero(same & (p[1:] != p[:-1] + 1))
    if gap.size:
        errs.append(f"non-contiguous positions in chain {c[gap[0]]}")
    else:
        apart = np.flatnonzero(same & (head[order][:-1] != tail[order][1:]))
        if apart.size:
            errs.append(f"non-adjacent consecutive edges in chain {c[apart[0]]}")
    out = np.flatnonzero((pos < 0) | (pos >= length))
    if out.size:
        errs.append(f"pos out of range at edge {idx[out[0]]}")
    return errs
