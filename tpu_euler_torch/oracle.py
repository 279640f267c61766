"""Pure-Python CPU oracle: the canonical contig set of a read set.

The port's own copy of ``tpu_euler/reference_impl/oracle.py`` (see its
docstring for the shared semantics): count canonical k-mers, keep those seen
``min_count`` times, build the doubled de Bruijn graph, clip tips and pop
simple bubbles where asked, spell the unitigs, cut each pure cycle at every
transition that reaches the cycle's smallest canonical (k+1)-mer, and
canonicalize. It shares no code with the port's device path, so it can judge
that path on a machine without the reference package.
"""

from __future__ import annotations

from collections import Counter, defaultdict

_COMP = str.maketrans("ACGT", "TGCA")


def rc(s: str) -> str:
    return s.translate(_COMP)[::-1]


def canon(s: str) -> str:
    r = rc(s)
    return s if s <= r else r


def count_canonical_kmers(reads, k: int) -> Counter:
    counts: Counter = Counter()
    for read in reads:
        for i in range(len(read) - k + 1):
            w = read[i : i + k]
            if "N" not in w:
                counts[canon(w)] += 1
    return counts


def assemble_oracle(
    reads,
    k: int,
    min_count: int = 1,
    tip_rounds: int = 0,
    tip_len: int = 0,
    bubble_rounds: int = 0,
    bubble_len: int = 0,
) -> set[str]:
    """The canonical contig set of ``reads`` at ``k``; with ``tip_rounds``
    and ``bubble_rounds``, after that many rounds (at most) of
    ``find_tip_kmers`` and then of ``find_bubble_kmers``, each stopping at
    the first round that removes nothing. The thresholds default to 2k."""
    if k % 2 == 0 or k < 3:
        raise ValueError("k must be odd and >= 3")
    counts = count_canonical_kmers(reads, k)
    edges = set()
    for km, c in counts.items():
        if c >= min_count:
            edges.add(km)
            edges.add(rc(km))
    for _ in range(tip_rounds):
        tips = find_tip_kmers(edges, k, tip_len or 2 * k)
        if not tips:
            break
        edges -= tips
    for _ in range(bubble_rounds):
        pops = find_bubble_kmers(edges, counts, k, bubble_len or 2 * k)
        if not pops:
            break
        edges -= pops
    return contigs_from_edges(edges)


def _adjacency(edges: set[str]):
    """(in_deg, out_deg, succ) of a doubled edge set: succ(e) is the edge
    that follows e through a simple head node (in = out = 1), else None."""
    out_edges: dict[str, list[str]] = defaultdict(list)
    in_deg: Counter = Counter()
    out_deg: Counter = Counter()
    for e in edges:
        out_edges[e[:-1]].append(e)
        out_deg[e[:-1]] += 1
        in_deg[e[1:]] += 1

    def simple(node: str) -> bool:
        return in_deg[node] == 1 and out_deg[node] == 1

    def succ(e: str):
        return out_edges[e[1:]][0] if simple(e[1:]) else None

    return in_deg, out_deg, simple, succ


def _open_chains(edges: set[str], simple, succ):
    """The unitig chains that start at an edge whose tail is not simple
    (every chain but the pure cycles)."""
    for s0 in edges:
        if simple(s0[:-1]):
            continue
        chain = [s0]
        e = succ(s0)
        while e is not None and e != s0:
            chain.append(e)
            e = succ(e)
        yield chain


def find_tip_kmers(edges: set[str], k: int, tip_len: int) -> set[str]:
    """k-mers (both orientations) of every tip: a chain of fewer than
    ``tip_len`` edges with exactly one dead end (start node of in-degree 0,
    or end node of out-degree 0). A chain dead at both ends is a contig of
    its own and stays."""
    in_deg, out_deg, simple, succ = _adjacency(edges)
    tips: set[str] = set()
    for chain in _open_chains(edges, simple, succ):
        dead_start = in_deg[chain[0][:-1]] == 0
        dead_end = out_deg[chain[-1][1:]] == 0
        if len(chain) < tip_len and dead_start != dead_end:
            for e in chain:
                tips.add(e)
                tips.add(rc(e))
    return tips


def find_bubble_kmers(edges: set[str], counts: Counter, k: int, bubble_len: int) -> set[str]:
    """k-mers (both orientations) of every popped bubble branch.

    The open chains are grouped by (start node, end node). A group of two
    or more chains that are all shorter than ``bubble_len`` edges is a
    bubble; its chains rank by (summed canonical count, descending; smallest
    canonical k-mer, ascending), both strand-symmetric, so the mirror group
    pops the mirror branches. A tie of the top two on both skips the group
    (they spell the same canonical sequence); otherwise every chain but the
    first is popped."""
    _, _, simple, succ = _adjacency(edges)
    groups: dict[tuple[str, str], list] = defaultdict(list)
    for chain in _open_chains(edges, simple, succ):
        cov = sum(counts[canon(w)] for w in chain)
        groups[(chain[0][:-1], chain[-1][1:])].append((-cov, min(canon(w) for w in chain), chain))
    pops: set[str] = set()
    for members in groups.values():
        if len(members) < 2 or any(len(c) >= bubble_len for _, _, c in members):
            continue
        members.sort(key=lambda m: (m[0], m[1]))
        if members[0][:2] == members[1][:2]:
            continue
        for _, _, chain in members[1:]:
            for w in chain:
                pops.add(w)
                pops.add(rc(w))
    return pops


def contigs_from_edges(edges: set[str]) -> set[str]:
    """Unitigs of an explicit doubled edge set, canonicalized."""
    _, _, simple, succ = _adjacency(edges)

    contigs: set[str] = set()
    used: set[str] = set()

    def emit(chain: list[str]):
        contigs.add(canon(chain[0][:-1] + "".join(e[-1] for e in chain)))

    for s0 in [e for e in edges if not simple(e[:-1])]:
        chain = [s0]
        used.add(s0)
        e = succ(s0)
        while e is not None and e not in used:
            chain.append(e)
            used.add(e)
            e = succ(e)
        emit(chain)

    # what is left forms pure cycles (every node simple)
    for e0 in sorted(edges - used):
        if e0 in used:
            continue
        cycle = [e0]
        used.add(e0)
        e = succ(e0)
        while e != e0:
            cycle.append(e)
            used.add(e)
            e = succ(e)
        m = len(cycle)
        trans = [canon(cycle[i] + cycle[(i + 1) % m][-1]) for i in range(m)]
        best = min(trans)
        cuts = [i for i in range(m) if trans[i] == best]
        for ci, cut in enumerate(cuts):
            arc_len = (cuts[(ci + 1) % len(cuts)] - cut) % m or m
            emit([cycle[(cut + 1 + j) % m] for j in range(arc_len)])
    return contigs


def canonical_contig_set(contigs) -> set[str]:
    """Canonical forms of an iterable of contig str/bytes."""
    return {canon((c.decode() if isinstance(c, bytes) else c).upper()) for c in contigs}


def diff_contig_sets(a, b) -> tuple[set[str], set[str]]:
    """(only in a, only in b) after canonicalization."""
    ca, cb = canonical_contig_set(a), canonical_contig_set(b)
    return ca - cb, cb - ca
