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
- every edge whose tail is not simple starts a chain, which follows the
  successors to its end;
- what is left are pure cycles: each is cut at every transition (an edge
  and its successor's last base, a (k+1)-mer) whose canonical form is the
  cycle's least, and each arc runs from the edge after one cut to the next
  cut's edge;
- a chain or arc spells its first edge's first k-1 bases and then each
  edge's last base; the contig is the lesser of that and its reverse
  complement.

Cleaning (tip clipping, bubble popping) is not part of this reference: a
cell whose traffic asks for it needs a reference that has it.

Keys are kept as lists of int64 words, the first word holding the first 31
bases, each base two bits (A, C, G, T = 0..3), so that comparing the word
lists in order compares the strings. Base arrays are column-major,
[bases, rows], so that a base position of every row is one contiguous
tensor. The reads are counted in chunks and the distinct keys reduced by
sorts, so that config 5's 2.4 G windows fit beside nothing else on one card.
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
    distinct: int  # canonical k-mers kept by the cutoff
    contigs: set[bytes]  # canonical contigs, ASCII


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


def contigs_from_kmers(words: list[torch.Tensor], k: int, canonicalize: bool = True) -> set[bytes]:
    """The contig set of the de Bruijn graph of these canonical k-mers.
    ``canonicalize=False`` keeps each chain as walked (the control)."""
    n = words[0].numel()
    if n == 0:
        return set()
    dev = words[0].device
    fwd = decode(words, k)
    edges = torch.cat([fwd, 3 - fwd.flip(0)], dim=1)  # [k, E]: edge e >= n is rc(edge e - n)
    del fwd
    E = 2 * n
    eid = torch.arange(E, device=dev)
    ends = [torch.cat([t, h]) for t, h in zip(encode(edges, 0, k - 1), encode(edges, 1, k - 1))]
    node, n_nodes = dense_ids(ends)
    del ends
    tail, head = node[:E], node[E:]
    out_deg = torch.bincount(tail, minlength=n_nodes)
    in_deg = torch.bincount(head, minlength=n_nodes)
    simple = (out_deg == 1) & (in_deg == 1)
    leaving = torch.full((n_nodes,), -1, dtype=torch.int64, device=dev)
    leaving[tail] = eid
    succ = torch.where(simple[head], leaving[head], -1)
    del leaving, out_deg, in_deg, node, tail, head

    # pure cycles: the edges from which the successors never end
    rounds = max(1, (E - 1).bit_length()) + 1
    f = torch.where(succ >= 0, succ, eid)
    for _ in range(rounds):
        f = f[f]
    cyc = torch.nonzero(succ[f] >= 0).squeeze(1)
    del f
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
        local = torch.full((E,), -1, dtype=torch.int64, device=dev)
        local[cyc] = torch.arange(cyc.numel(), device=dev)
        s = local[succ[cyc]]
        m = rank
        for _ in range(max(1, (cyc.numel() - 1).bit_length()) + 1):
            m = torch.minimum(m, m[s])
            s = s[s]
        succ[cyc[rank == m]] = -1  # cut after each least transition
        del local, s, m, rank
    pred = torch.full((E,), -1, dtype=torch.int64, device=dev)
    has = succ >= 0
    pred[succ[has]] = eid[has]
    del has, succ
    root, pos = jump_roots(pred)
    del pred
    # spell: chain c (rooted at edge r) takes (k - 1) + length bytes
    heads = torch.nonzero(root == eid).squeeze(1)
    length = torch.bincount(root, minlength=E)[heads]
    size = length + (k - 1)
    off = torch.cumsum(size, 0) - size
    slot = torch.full((E,), -1, dtype=torch.int64, device=dev)
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
    assembler's ``settings`` (``k``, ``min_count``; no cleaning rounds)."""
    k, min_count = settings["k"], settings["min_count"]
    if settings.get("tip_rounds") or settings.get("bubble_rounds"):
        raise NotImplementedError("this reference does not clean")
    if k < 3 or k % 2 == 0:
        raise ValueError("k must be odd and >= 3")
    words, counts, windows = count_kmers(codes, k, device)
    keep = counts >= min_count
    words = [w[keep] for w in words]
    del counts, keep
    distinct = words[0].numel()
    return Reference(windows, distinct, contigs_from_kmers(words, k, canonicalize))
