"""Pure-Python CPU oracle: the canonical contig set of a read set.

The port's own copy of the non-cleaning part of
``tpu_euler/reference_impl/oracle.py`` (see its docstring for the shared
semantics): count canonical k-mers, keep those seen ``min_count`` times, build
the doubled de Bruijn graph, spell its unitigs, cut each pure cycle at every
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


def assemble_oracle(reads, k: int, min_count: int = 1) -> set[str]:
    """The canonical contig set of ``reads`` at ``k``."""
    if k % 2 == 0 or k < 3:
        raise ValueError("k must be odd and >= 3")
    edges = set()
    for km, c in count_canonical_kmers(reads, k).items():
        if c >= min_count:
            edges.add(km)
            edges.add(rc(km))
    return contigs_from_edges(edges)


def contigs_from_edges(edges: set[str]) -> set[str]:
    """Unitigs of an explicit doubled edge set, canonicalized."""
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
