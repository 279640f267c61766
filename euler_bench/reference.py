"""The plain reference assembler: the canonical contig set of a read set.

Plain PyTorch (and NumPy for the last step on the host), written for this
benchmark; it imports nothing of the assembler it judges. Its semantics are
those the assembler states for its output:

- count the canonical k-mers (the lesser of a window and its reverse
  complement) of every window of k bases without an N;
- keep those counted at least ``min_count`` times; each kept k-mer is an
  edge in both orientations of the de Bruijn graph whose nodes are
  (k-1)-mers;
- a node is simple when one edge enters it and one leaves it; an edge's
  successor is the edge that leaves its head, where the head is simple;
- every edge whose tail is not simple starts an open chain, which follows
  the successors to its end;
- cleaning, where the settings ask for it, runs between the cutoff and the
  spelling: up to ``tip_rounds`` rounds of tip clipping, then up to
  ``bubble_rounds`` rounds of bubble popping, each pass ending at the first
  round that removes nothing. A tip is an open chain of fewer than
  ``tip_len`` edges with exactly one dead end (its first edge's tail has no
  edge in, or its last edge's head has no edge out). A bubble is a group of
  two or more open chains with the same first tail and last head, all of
  fewer than ``bubble_len`` edges; its chains rank by their summed count
  (descending), then by their least canonical k-mer, and all but the first
  are popped, unless the first two tie on both. A removed k-mer goes in
  both orientations; a length of 0 means 2k;
- what is left after the open chains are pure cycles: each is cut at every
  transition (an edge and its successor's last base, a (k+1)-mer) whose
  canonical form is the cycle's least, and each arc runs from the edge
  after one cut to the next cut's edge;
- a chain or arc spells its first edge's first k-1 bases and then each
  edge's last base; the contig is the lesser of that and its reverse
  complement.

Keys are kept as lists of int64 words, the first word holding the first 31
bases, each base two bits (A, C, G, T = 0..3), so that comparing the word
lists in order compares the strings. Base arrays are column-major,
[bases, rows], so that a base position of every row is one contiguous
tensor. The reads are counted in chunks and the distinct keys reduced by
sorts, so that config 5's 2.4 G windows fit beside nothing else on one card.
The distinct keys stay sorted through the cutoff and the cleaning, so a
key's index orders the canonical k-mers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

WORD_BASES = 31
CHUNK_WINDOWS = 1 << 27  # windows turned into keys at a time
REDUCE_ROWS = 1 << 29  # distinct rows held before they are reduced together


@dataclasses.dataclass
class Reference:
    windows: int  # windows of k bases without an N
    distinct: int  # canonical k-mers kept by the cutoff and the cleaning
    contigs: set[bytes]  # canonical contigs, ASCII
    clipped: list[int] = dataclasses.field(default_factory=list)  # canonical k-mers each tip round removed
    popped: list[int] = dataclasses.field(default_factory=list)  # ... each bubble round


def spans(n: int) -> list[tuple[int, int]]:
    """(first base, bases) of each word of an n-base key."""
    return [(a, min(WORD_BASES, n - a)) for a in range(0, n, WORD_BASES)]


def lex_less(a: list[torch.Tensor], b: list[torch.Tensor], or_equal: bool = False) -> torch.Tensor:
    """Row-wise a < b (a <= b) over word lists."""
    out = a[-1] <= b[-1] if or_equal else a[-1] < b[-1]
    for x, y in zip(reversed(a[:-1]), reversed(b[:-1])):
        out = (x < y) | ((x == y) & out)
    return out


def lexsort(words: list[torch.Tensor]) -> torch.Tensor:
    """The permutation that sorts rows by their word lists (stable passes
    from the last word to the first)."""
    idx = torch.argsort(words[-1], stable=True)
    for w in reversed(words[:-1]):
        idx = idx[torch.argsort(w[idx], stable=True)]
    return idx


def _runs(words: list[torch.Tensor]) -> torch.Tensor:
    """[n] bool: row i of sorted rows differs from row i - 1."""
    n = words[0].numel()
    new = torch.zeros(n, dtype=torch.bool, device=words[0].device)
    new[:1] = True
    for w in words:
        new[1:] |= w[1:] != w[:-1]
    return new


def reduce_counts(words: list[torch.Tensor], counts: torch.Tensor) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Distinct rows, sorted, with their summed counts."""
    if counts.numel() == 0:
        return words, counts
    idx = lexsort(words)
    words = [w[idx] for w in words]
    counts = counts[idx]
    del idx
    starts = torch.nonzero(_runs(words)).squeeze(1)
    ends = torch.cat([starts[1:], starts.new_tensor([counts.numel()])])
    cs = torch.cumsum(counts, 0)
    sums = cs[ends - 1] - cs[starts] + counts[starts]
    return [w[starts] for w in words], sums


def sliding_values(c: torch.Tensor, n: int) -> torch.Tensor:
    """[r, L] int64 codes 0..3 -> [r, L - n + 1]: the value of bases j..j+n-1
    of each row, the first base most significant (n <= 31), by doubling."""
    powers = {1: c}
    m = 1
    while 2 * m <= n:
        p = powers[m]
        powers[2 * m] = (p[:, :-m] << (2 * m)) | p[:, m:]
        m *= 2
    width = c.shape[1] - n + 1
    acc, offset = None, 0
    for b in sorted(powers, reverse=True):
        if offset + b <= n:
            part = powers[b][:, offset : offset + width]
            acc = part if acc is None else (acc << (2 * b)) | part
            offset += b
    return acc


def window_words(c: torch.Tensor, k: int) -> list[torch.Tensor]:
    """Word lists of every k-base window of [r, L] int64 codes 0..3: each
    word [r, L - k + 1]."""
    width = c.shape[1] - k + 1
    by_len = {n: sliding_values(c, n) for n in {n for _, n in spans(k)}}
    return [by_len[n][:, a : a + width] for a, n in spans(k)]


def canonical_windows(codes: torch.Tensor, k: int) -> tuple[list[torch.Tensor], int]:
    """The canonical keys of the windows without an N of [r, L] int8 codes
    (N = 4), flattened, and their number."""
    isn = (codes > 3) | (codes < 0)
    cs = torch.nn.functional.pad(torch.cumsum(isn, 1, dtype=torch.int32), (1, 0))
    valid = (cs[:, k:] - cs[:, :-k]) == 0
    c = codes.to(torch.int64) & 3
    fwd = window_words(c, k)
    rev = [w.flip(1) for w in window_words(3 - c.flip(1), k)]
    del c
    take_fwd = lex_less(fwd, rev, or_equal=True)
    keys = [torch.where(take_fwd, f, r)[valid] for f, r in zip(fwd, rev)]
    return keys, int(valid.sum())


def count_kmers(codes: np.ndarray, k: int, device) -> tuple[list[torch.Tensor], torch.Tensor, int]:
    """(distinct canonical keys, sorted; their counts; windows counted) of
    an [R, L] int8 host code matrix."""
    R, L = codes.shape
    rows = max(1, CHUNK_WINDOWS // max(1, L - k + 1))
    held: list[tuple[list[torch.Tensor], torch.Tensor]] = []
    held_rows, windows = 0, 0
    W = len(spans(k))
    for lo in range(0, R, rows):
        chunk = torch.from_numpy(np.ascontiguousarray(codes[lo : lo + rows])).to(device)
        keys, n = canonical_windows(chunk, k)
        del chunk
        windows += n
        held.append(reduce_counts(keys, torch.ones(n, dtype=torch.int64, device=device)))
        del keys
        held_rows += held[-1][1].numel()
        if held_rows > REDUCE_ROWS and len(held) > 1:
            held = [_merge(held, W)]
            held_rows = held[0][1].numel()
    if not held:  # no reads
        empty = torch.empty(0, dtype=torch.int64, device=device)
        return [empty] * W, empty, 0
    words, counts = _merge(held, W) if len(held) > 1 else held[0]
    return words, counts, windows


def _merge(held, W: int):
    words = [torch.cat([h[0][w] for h in held]) for w in range(W)]
    counts = torch.cat([h[1] for h in held])
    held.clear()
    return reduce_counts(words, counts)


def decode(words: list[torch.Tensor], k: int) -> torch.Tensor:
    """[k, n] int8 bases of n keys."""
    n = words[0].numel()
    out = torch.empty((k, n), dtype=torch.int8, device=words[0].device)
    for w, (a, m) in zip(words, spans(k)):
        for i in range(m):
            out[a + i] = (w >> (2 * (m - 1 - i))) & 3
    return out


def encode(bases: torch.Tensor, start: int, n: int) -> list[torch.Tensor]:
    """Word list of the n-base keys at rows start..start+n-1 of [*, m] int8
    bases."""
    out = []
    for a, m in spans(n):
        acc = torch.zeros(bases.shape[1], dtype=torch.int64, device=bases.device)
        for i in range(m):
            acc = (acc << 2) | bases[start + a + i].to(torch.int64)
        out.append(acc)
    return out


def dense_ids(words: list[torch.Tensor]) -> tuple[torch.Tensor, int]:
    """Each row's rank among the distinct rows, and their number."""
    idx = lexsort(words)
    new = _runs([w[idx] for w in words])
    seg = torch.cumsum(new, 0) - 1
    ids = torch.empty_like(seg)
    ids[idx] = seg
    return ids, int(seg[-1]) + 1 if seg.numel() else 0


def jump_roots(pred: torch.Tensor, rounds: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Pointer jumping along ``pred`` (-1 = none): each element's root and
    its distance from it. Without ``rounds`` it runs until nothing moves;
    an element on a cycle has no root, and its result then means nothing."""
    E = pred.numel()
    eid = torch.arange(E, device=pred.device)
    j = torch.where(pred >= 0, pred, eid)
    d = (pred >= 0).to(torch.int64)
    r = 0
    while rounds is None or r < rounds:
        jj = j[j]
        if rounds is None and bool((jj == j).all()):
            break
        d = d + d[j]
        j = jj
        r += 1
    return j, d


@dataclasses.dataclass
class Graph:
    """The doubled de Bruijn graph of n canonical k-mers: edge e < n is
    k-mer e, edge e >= n its reverse complement."""

    edges: torch.Tensor  # [k, E] int8 bases
    tail: torch.Tensor  # [E] node id of an edge's first k - 1 bases
    head: torch.Tensor  # [E] node id of its last k - 1
    in_deg: torch.Tensor  # [nodes]
    out_deg: torch.Tensor  # [nodes]
    succ: torch.Tensor  # [E] the edge that leaves e's head where the head is simple, else -1


def graph_of(words: list[torch.Tensor], k: int) -> Graph:
    n = words[0].numel()
    dev = words[0].device
    fwd = decode(words, k)
    edges = torch.cat([fwd, 3 - fwd.flip(0)], dim=1)
    del fwd
    E = 2 * n
    ends = [torch.cat([t, h]) for t, h in zip(encode(edges, 0, k - 1), encode(edges, 1, k - 1))]
    node, n_nodes = dense_ids(ends)
    del ends
    tail, head = node[:E], node[E:]
    out_deg = torch.bincount(tail, minlength=n_nodes)
    in_deg = torch.bincount(head, minlength=n_nodes)
    simple = (out_deg == 1) & (in_deg == 1)
    leaving = torch.full((n_nodes,), -1, dtype=torch.int64, device=dev)
    leaving[tail] = torch.arange(E, device=dev)
    succ = torch.where(simple[head], leaving[head], -1)
    return Graph(edges, tail, head, in_deg, out_deg, succ)


def on_cycles(succ: torch.Tensor) -> torch.Tensor:
    """[E] bool: the edges of pure cycles, from which the successors never
    end."""
    E = succ.numel()
    f = torch.where(succ >= 0, succ, torch.arange(E, device=succ.device))
    for _ in range(max(1, (E - 1).bit_length()) + 1):
        f = f[f]
    return succ[f] >= 0


def chain_roots(succ: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each edge's chain (its first edge) and its place on it, along
    ``succ``, which holds no cycle."""
    E = succ.numel()
    eid = torch.arange(E, device=succ.device)
    pred = torch.full((E,), -1, dtype=torch.int64, device=succ.device)
    has = succ >= 0
    pred[succ[has]] = eid[has]
    return jump_roots(pred)


@dataclasses.dataclass
class OpenChains:
    """The open chains of a graph, each named by its first edge."""

    root: torch.Tensor  # [E] each edge's chain
    is_open: torch.Tensor  # [E] bool: the edge lies on an open chain, not on a pure cycle
    first: torch.Tensor  # [c] the chains' first edges
    length: torch.Tensor  # [c] edges
    start: torch.Tensor  # [c] the first edge's tail node
    end: torch.Tensor  # [c] the last edge's head node

    def kmers(self, chosen: torch.Tensor, n: int) -> torch.Tensor:
        """[n] bool: the canonical k-mers of the chosen chains' edges."""
        E = self.root.numel()
        flag = torch.zeros(E, dtype=torch.bool, device=chosen.device)
        flag[self.first[chosen]] = True
        out = torch.zeros(n, dtype=torch.bool, device=chosen.device)
        out[torch.nonzero(self.is_open & flag[self.root]).squeeze(1) % n] = True
        return out


def open_chains(g: Graph) -> OpenChains:
    cyc = on_cycles(g.succ)
    succ = torch.where(cyc, -1, g.succ)
    root, _ = chain_roots(succ)
    eid = torch.arange(root.numel(), device=root.device)
    first = torch.nonzero(~cyc & (root == eid)).squeeze(1)
    last = ~cyc & (succ < 0)
    end = torch.full_like(root, -1)
    end[root[last]] = g.head[last]
    length = torch.bincount(root[~cyc], minlength=root.numel())[first]
    return OpenChains(root, ~cyc, first, length, g.tail[first], end[first])


def tip_kmers(g: Graph, counts: torch.Tensor, tip_len: int) -> torch.Tensor:
    """[n] bool: the k-mers of every tip: an open chain of fewer than
    ``tip_len`` edges with exactly one dead end. A chain dead at both ends
    is a contig of its own and stays."""
    ch = open_chains(g)
    dead_start = g.in_deg[ch.start] == 0
    dead_end = g.out_deg[ch.end] == 0
    return ch.kmers((ch.length < tip_len) & (dead_start != dead_end), counts.numel())


def bubble_kmers(g: Graph, counts: torch.Tensor, bubble_len: int) -> torch.Tensor:
    """[n] bool: the k-mers of every popped bubble branch. The open chains
    are grouped by (start node, end node); a group of two or more, all of
    fewer than ``bubble_len`` edges, is a bubble. Its chains rank by summed
    count (descending), then by least canonical k-mer (ascending); where
    the first two tie on both the group stays (they spell one canonical
    sequence), else all but the first are popped."""
    n = counts.numel()
    ch = open_chains(g)
    c = ch.first.numel()
    if c == 0:
        return torch.zeros(n, dtype=torch.bool, device=counts.device)
    E = ch.root.numel()
    on = torch.nonzero(ch.is_open).squeeze(1)
    kmer = on % n
    cov = torch.zeros(E, dtype=torch.int64, device=on.device).index_add_(0, ch.root[on], counts[kmer])[ch.first]
    least = torch.full((E,), n, dtype=torch.int64, device=on.device)
    least = least.scatter_reduce_(0, ch.root[on], kmer, "amin")[ch.first]  # sorted keys: the least index
    order = lexsort([ch.start, ch.end, -cov, least])
    cov, least, length = cov[order], least[order], ch.length[order]
    new = _runs([ch.start[order], ch.end[order]])  # each group's first chain
    gid = torch.cumsum(new, 0) - 1
    top = torch.nonzero(new).squeeze(1)
    second = (top + 1).clamp(max=c - 1)
    size = torch.bincount(gid)
    longest = torch.zeros(size.numel(), dtype=torch.int64, device=on.device).scatter_reduce_(0, gid, length, "amax")
    tie = (cov[top] == cov[second]) & (least[top] == least[second])
    bubble = (size >= 2) & (longest < bubble_len) & ~tie
    chosen = torch.zeros(c, dtype=torch.bool, device=on.device)
    chosen[order] = bubble[gid] & ~new
    return ch.kmers(chosen, n)


def clean_rounds(words, counts, k: int, rounds: int, find) -> tuple[list[torch.Tensor], torch.Tensor, list[int]]:
    """Up to ``rounds`` rounds of ``find(graph, counts)``, each removing the
    k-mers it marks, ending at the first round that marks none; returns the
    words and counts kept and the k-mers each round removed."""
    removed: list[int] = []
    for _ in range(rounds):
        drop = find(graph_of(words, k), counts) if counts.numel() else torch.zeros(0, dtype=torch.bool)
        removed.append(int(drop.sum()))
        if not removed[-1]:
            break
        words, counts = [w[~drop] for w in words], counts[~drop]
    return words, counts, removed


def contigs_from_kmers(words: list[torch.Tensor], k: int, canonicalize: bool = True) -> set[bytes]:
    """The contig set of the de Bruijn graph of these canonical k-mers.
    ``canonicalize=False`` keeps each chain as walked (the control)."""
    n = words[0].numel()
    if n == 0:
        return set()
    dev = words[0].device
    g = graph_of(words, k)
    edges, succ = g.edges, g.succ
    del g
    cyc = torch.nonzero(on_cycles(succ)).squeeze(1)
    if cyc.numel():
        # each cycle edge's transition, canonical, as a dense rank
        nxt_last = edges[k - 1, succ[cyc]]
        trans = torch.cat([edges[:, cyc], nxt_last[None]])  # [k + 1, c]
        tf = encode(trans, 0, k + 1)
        tr = encode(3 - trans.flip(0), 0, k + 1)
        del trans, nxt_last
        take_f = lex_less(tf, tr, or_equal=True)
        rank, _ = dense_ids([torch.where(take_f, a, b) for a, b in zip(tf, tr)])
        del tf, tr, take_f
        # each cycle's least transition, by doubling along the successors
        local = torch.full((2 * n,), -1, dtype=torch.int64, device=dev)
        local[cyc] = torch.arange(cyc.numel(), device=dev)
        s = local[succ[cyc]]
        m = rank
        for _ in range(max(1, (cyc.numel() - 1).bit_length()) + 1):
            m = torch.minimum(m, m[s])
            s = s[s]
        succ[cyc[rank == m]] = -1  # cut after each least transition
        del local, s, m, rank
    root, pos = chain_roots(succ)
    del succ
    # spell: chain c (rooted at edge r) takes (k - 1) + length bytes
    heads = torch.nonzero(root == torch.arange(2 * n, device=dev)).squeeze(1)
    length = torch.bincount(root, minlength=2 * n)[heads]
    size = length + (k - 1)
    off = torch.cumsum(size, 0) - size
    slot = torch.full((2 * n,), -1, dtype=torch.int64, device=dev)
    slot[heads] = off
    buf = torch.empty(int(size.sum()), dtype=torch.int8, device=dev)
    buf[slot[root] + (k - 1) + pos] = edges[k - 1]
    for i in range(k - 1):
        buf[off + i] = edges[i, heads]
    del edges, root, pos, slot
    return _contig_bytes(buf.cpu().numpy(), off.cpu().numpy(), size.cpu().numpy(), canonicalize)


_ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)


def _contig_bytes(buf: np.ndarray, off: np.ndarray, size: np.ndarray, canonicalize: bool) -> set[bytes]:
    seq = _ASCII[buf]
    comp = _ASCII[3 - buf]
    out = set()
    for a, n in zip(off.tolist(), size.tolist()):
        fwd = seq[a : a + n].tobytes()
        if canonicalize:
            rev = comp[a : a + n][::-1].tobytes()
            fwd = min(fwd, rev)
        out.add(fwd)
    return out


def assemble(codes: np.ndarray, settings: dict, device, canonicalize: bool = True) -> Reference:
    """The reference's answer for an [R, L] int8 host code matrix under the
    assembler's ``settings`` (``k``, ``min_count``, and where set
    ``tip_rounds``, ``tip_len``, ``bubble_rounds``, ``bubble_len``)."""
    k, min_count = settings["k"], settings["min_count"]
    if k < 3 or k % 2 == 0:
        raise ValueError("k must be odd and >= 3")
    tip_len = settings.get("tip_len") or 2 * k
    bubble_len = settings.get("bubble_len") or 2 * k
    words, counts, windows = count_kmers(codes, k, device)
    keep = counts >= min_count
    words, counts = [w[keep] for w in words], counts[keep]
    del keep
    words, counts, clipped = clean_rounds(
        words, counts, k, settings.get("tip_rounds", 0), lambda g, c: tip_kmers(g, c, tip_len))
    words, counts, popped = clean_rounds(
        words, counts, k, settings.get("bubble_rounds", 0), lambda g, c: bubble_kmers(g, c, bubble_len))
    del counts
    distinct = words[0].numel()
    return Reference(windows, distinct, contigs_from_kmers(words, k, canonicalize), clipped, popped)
