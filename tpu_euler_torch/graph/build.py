"""De Bruijn graph build over the virtual doubled edge array.

Counterpart of ``tpu_euler/graph/build.py``: the staged build
(``build_graph_staged`` and its stages) and ``build_graph``, which is the
same stages plus the materialized doubled edge keys. Graph semantics are
the reference's:
the doubled directed graph holds both orientations of every surviving
canonical k-mer as edges, nodes are (k-1)-mers, edge w runs w[:-1] -> w[1:].
Edge row r < C is spectrum row r; row r >= C is revcomp(spectrum row r - C)
and is never materialized (``gather_edge_rows``).

Node ids, degrees and the successor table are bit-identical to the
reference's. The reference sorts (limbs..., payload) with the payload as the
last key; here the endpoint (k-1)-mer key (one word, or W words for
k > 31, sorted in W stable passes) is the only sort key and the payload
follows the permutation. Row order inside a run of equal keys then differs,
but every output is a function of the run, not of its order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_euler_torch.kmer import keys
from tpu_euler_torch.kmer.count import Spectrum


class DeBruijnGraph(NamedTuple):
    """Doubled de Bruijn graph in dense-array form.

    E = 2C edges; node arrays have capacity ``node_cap`` (2E by default).
    The edge keys are virtual on the staged route (``edge_words`` is None
    and callers read them from the spectrum with ``gather_edge_rows``).
    ``build_graph`` and ``load_graph`` materialize them for the callers that
    read edge keys by edge id: the tour's walks, the graph checkpoint, the
    host emission.
    """

    edge_valid: torch.Tensor  # [E] bool
    tail: torch.Tensor  # [E] int64 node id of the prefix (k-1)-mer, 0 if invalid
    head: torch.Tensor  # [E] int64 node id of the suffix (k-1)-mer, 0 if invalid
    n_edges: int
    n_nodes: int
    indeg: torch.Tensor  # [node_cap] int64
    outdeg: torch.Tensor  # [node_cap] int64
    out_first: torch.Tensor  # [node_cap] int64 min out-edge id (E if none)
    succ_cand: torch.Tensor  # [node_cap] int64 out_first where node is simple, else -1
    edge_words: torch.Tensor | None = None  # [E] (or [E, W]) int64 edge keys, where materialized


def _canon_endpoint_parts(words: torch.Tensor, n: int, k: int):
    """Endpoint sort keys + payload + per-row strand bits.

    Returns (ends [2C] or [2C, 2], payload [2C], strands [C]). ends = canonical (k-1)-mer
    of each spectrum row's prefix (rows [0, C)) and suffix (rows [C, 2C)),
    ``keys.SENT`` for invalid rows; payload = pos | out_strand << 30 | pal << 31;
    strands = s_pre | s_suf << 1.
    """
    C = words.shape[0]
    if 2 * C >= 1 << 30:
        raise ValueError(f"endpoint payload packs row ids into 30 bits; 2C={2 * C}")
    dev = words.device
    valid = torch.arange(C, device=dev) < n
    pre = keys.prefix(words)
    suf = keys.suffix(words, k)

    def canon3(m):
        rc = keys.revcomp(m, k - 1)
        rc_smaller = keys.key_less(rc, m)
        return keys.select(rc_smaller, rc, m), rc_smaller, keys.key_eq(m, rc)

    cpre, s_pre, pal_pre = canon3(pre)
    csuf, s_suf, pal_suf = canon3(suf)
    valid2 = torch.cat([valid, valid])
    ends = keys.select(valid2, torch.cat([cpre, csuf]), keys.SENT)
    pal2 = torch.cat([pal_pre, pal_suf])
    # out-strand of each occurrence: pre rows are fwd-edge tails (strand s);
    # suf rows are rev-edge tails through rc (strand 1-s). Pal rows fold to 0.
    s_out2 = torch.cat([s_pre, ~s_suf]) & ~pal2
    payload = (
        torch.arange(2 * C, device=dev)
        | (s_out2.to(torch.int64) << 30)
        | (pal2.to(torch.int64) << 31)
    )
    strands = s_pre.to(torch.int64) | (s_suf.to(torch.int64) << 1)
    return ends, payload, strands


def sort_endpoints(ends: torch.Tensor, payload: torch.Tensor):
    """The endpoint sort: keys ascending, payload carried."""
    s, perm = keys.sort(ends)
    return s, payload[perm]


class _Runs(NamedTuple):
    """Per sorted endpoint row: the run (distinct canonical (k-1)-mer) it is in."""

    sv: torch.Tensor  # row holds a valid endpoint
    is_new: torch.Tensor  # first row of its run
    rank: torch.Tensor  # run index
    pal: torch.Tensor  # run's (k-1)-mer is its own reverse complement
    base: torch.Tensor  # node id of the run's canonical strand; other = base+1
    n_canon: int
    n_nodes: int


def _runs(s: torch.Tensor, spay: torch.Tensor) -> _Runs:
    """base = 2*rank - (# palindromic runs before this one): dense node ids."""
    sv = keys.is_valid(s)
    is_new = torch.ones_like(sv)
    is_new[1:] = keys.key_ne(s[1:], s[:-1])
    is_new &= sv
    rank = torch.cumsum(is_new, 0) - 1
    pal = (spay >> 31) & 1 == 1
    pal_seg = torch.cumsum(is_new & pal, 0) - pal.to(torch.int64)
    n_canon = int(is_new.sum())
    n_pal = int((is_new & pal).sum())
    return _Runs(sv, is_new, rank, pal, 2 * rank - pal_seg, n_canon, 2 * n_canon - n_pal)


def _ids_from_sorted(runs: _Runs, spay, strands, edge_valid):
    """(tail [E], head [E]) from the sorted endpoints."""
    sv, pal, base = runs.sv, runs.pal, runs.base
    M = sv.shape[0]  # = 2C
    C = M // 2
    pos = spay & ((1 << 30) - 1)
    back = torch.zeros(M, dtype=torch.int64, device=sv.device)
    back[pos[sv]] = (base[sv] << 1) | pal[sv].to(torch.int64)
    base_pre, palp = back[:C] >> 1, (back[:C] & 1) == 1
    base_suf, pals = back[C:] >> 1, (back[C:] & 1) == 1
    sp = ((strands & 1) == 1) & ~palp  # strand of raw pre (pal -> 0)
    ss = ((strands >> 1) == 1) & ~pals
    tail = torch.cat([base_pre + sp, base_suf + (~ss & ~pals)])
    head = torch.cat([base_suf + ss, base_pre + (~sp & ~palp)])
    return torch.where(edge_valid, tail, 0), torch.where(edge_valid, head, 0)


def _degrees_from_sorted(runs: _Runs, spay, node_cap: int):
    """(outdeg, indeg) [node_cap] from the sorted endpoints.

    Per run, the out-strand counts (s0, s1) give outdeg = (s0, s1) at
    (base, base+1) and indeg = (s1, s0): in-strand = 1 - out-strand off
    palindromes. A palindromic run has one node with in = out = s0.
    """
    sv, rank = runs.sv, runs.rank
    M, n = sv.shape[0], runs.n_canon
    s_out = (spay >> 30) & 1
    o0 = torch.bincount(rank[sv & (s_out == 0)], minlength=M)[:n]
    o1 = torch.bincount(rank[sv & (s_out == 1)], minlength=M)[:n]
    pal_r = runs.pal[runs.is_new]  # per rank
    base_r = runs.base[runs.is_new]
    outdeg = torch.zeros(node_cap, dtype=torch.int64, device=sv.device)
    indeg = torch.zeros(node_cap, dtype=torch.int64, device=sv.device)
    outdeg[base_r] = o0
    indeg[base_r] = torch.where(pal_r, o0, o1)
    two = ~pal_r
    outdeg[base_r[two] + 1] = o1[two]
    indeg[base_r[two] + 1] = o0[two]
    return outdeg, indeg


def succ_tables(tail, edge_valid, indeg, outdeg, node_cap: int):
    """Min out-edge per node + the folded simple-node successor table."""
    E = tail.shape[0]
    eid = torch.arange(E, device=tail.device)
    out_first = torch.full((node_cap,), E, dtype=torch.int64, device=tail.device)
    out_first.scatter_reduce_(0, tail[edge_valid], eid[edge_valid], "amin")
    simple = (indeg == 1) & (outdeg == 1) & (out_first < E)
    return out_first, torch.where(simple, out_first, -1)


def build_graph_staged(spec: Spectrum, k: int, node_cap: int = 0) -> DeBruijnGraph:
    """Graph of a compacted, cut spectrum. ``node_cap`` 0 means 2E."""
    C = spec.words.shape[0]
    E = 2 * C
    node_cap = node_cap or 2 * E
    ends, payload, strands = _canon_endpoint_parts(spec.words, spec.n, k)
    s, spay = sort_endpoints(ends, payload)
    del ends, payload
    runs = _runs(s, spay)
    del s
    if runs.n_nodes > node_cap:
        raise RuntimeError(
            f"node capacity {node_cap} < n_nodes {runs.n_nodes}: raise "
            f"AssemblyConfig.node_cap_factor"
        )
    v = torch.arange(C, device=spay.device) < spec.n
    edge_valid = torch.cat([v, v])
    outdeg, indeg = _degrees_from_sorted(runs, spay, node_cap)
    tail, head = _ids_from_sorted(runs, spay, strands, edge_valid)
    n_nodes = runs.n_nodes
    del runs, spay
    out_first, succ_cand = succ_tables(tail, edge_valid, indeg, outdeg, node_cap)
    return DeBruijnGraph(
        edge_valid=edge_valid,
        tail=tail,
        head=head,
        n_edges=2 * spec.n,
        n_nodes=n_nodes,
        indeg=indeg,
        outdeg=outdeg,
        out_first=out_first,
        succ_cand=succ_cand,
    )


def doubled_edges(spec: Spectrum, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Both orientations of every spectrum row as edge keys: (edge_words
    [2C] or [2C, W], edge_valid [2C]) [reference doubled_edges, :57]."""
    v = torch.arange(spec.words.shape[0], device=spec.words.device) < spec.n
    return torch.cat([spec.words, keys.revcomp(spec.words, k)]), torch.cat([v, v])


def build_graph(spec: Spectrum, k: int, node_cap: int = 0) -> DeBruijnGraph:
    """``build_graph_staged`` with the doubled edge keys materialized
    [reference build_graph, :425]. The reference sorts the endpoints a
    second time in a program of its own; the staged stages give the same
    ids, degrees and successor table, so this is those stages and one
    ``doubled_edges``."""
    return build_graph_staged(spec, k, node_cap)._replace(edge_words=doubled_edges(spec, k)[0])


def gather_edge_rows(words: torch.Tensor, idx: torch.Tensor, k: int) -> torch.Tensor:
    """Edge keys of the virtual doubled edge array at ``idx`` (clipped)."""
    C = words.shape[0]
    is_rev = idx >= C
    base = words[torch.clamp(torch.where(is_rev, idx - C, idx), 0, C - 1)]
    return keys.select(is_rev, keys.revcomp(base, k), base)
