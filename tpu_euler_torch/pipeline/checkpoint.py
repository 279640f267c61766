"""Checkpoints at the pipeline's two stage boundaries.

Counterpart of ``tpu_euler/pipeline/checkpoint.py``:

* the counted spectrum (``--save/--resume-spectrum``): a resume skips the
  reads and the counting;
* the graph with its unitig chains (``--save/--resume-graph``): a resume
  goes straight to the emission.

The files are the reference's, field by field (``.npz``; keys as big-endian
uint32 limbs ``[n, ceil(k/16)]``, int32 ids, the same two version numbers),
so a checkpoint written by one package loads in the other;
``convert.words_to_limbs`` and ``limbs_to_words`` carry the keys across. A
graph checkpoint holds the valid edges only, compacted, with node and chain
ids renumbered densely: its size follows the live edges, not the capacities.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_euler_torch import convert
from tpu_euler_torch.euler.unitigs import UnitigChains
from tpu_euler_torch.graph.build import DeBruijnGraph, gather_edge_rows
from tpu_euler_torch.kmer import keys
from tpu_euler_torch.kmer.count import Spectrum

FORMAT_VERSION = 1
GRAPH_FORMAT_VERSION = 1


def _nlimbs(k: int) -> int:
    return -(-k // 16)


def _check_version(z, version: int, what: str) -> None:
    if int(z["version"]) != version:
        raise ValueError(f"unsupported {what} checkpoint version {z['version']}")


def save_spectrum(path: str, spec: Spectrum, k: int) -> None:
    n = spec.n
    np.savez_compressed(
        path,
        version=FORMAT_VERSION,
        k=k,
        n=n,
        limbs=convert.words_to_limbs(spec.words[:n], _nlimbs(k)),
        counts=spec.counts[:n].cpu().numpy().astype(np.int32),
    )


def load_spectrum(path: str, device, capacity: int | None = None) -> tuple[Spectrum, int]:
    """Returns (spectrum padded to ``capacity`` rows on ``device``, k)."""
    with np.load(path) as z:
        _check_version(z, FORMAT_VERSION, "spectrum")
        k, n = int(z["k"]), int(z["n"])
        limbs, counts = z["limbs"], z["counts"]
    cap = capacity or max(1, n)
    if n > cap:
        raise ValueError(f"checkpoint has {n} kmers > capacity {cap}")
    words = torch.zeros((cap,) + keys.word_shape(k), dtype=torch.int64, device=device)
    pc = torch.zeros(cap, dtype=torch.int32, device=device)
    words[:n] = convert.limbs_to_words(limbs, device, keys.nwords(k))
    pc[:n] = torch.from_numpy(counts.astype(np.int32)).to(device)
    return Spectrum(words, pc, n), k


def save_graph(path: str, g, chains: UnitigChains, k: int, spec_words: torch.Tensor | None = None) -> None:
    """Checkpoint a graph and its chains. ``g`` gives ``tail``, ``head`` and
    the edge keys: its ``edge_words`` where they are materialized, else the
    rows of the virtual doubled array over ``spec_words``. Either way only
    the valid edges' keys are gathered, never all E rows."""
    idx_t = torch.nonzero(chains.in_chain).squeeze(1)
    idx = idx_t.cpu().numpy()
    if getattr(g, "edge_words", None) is not None:
        rows = g.edge_words[idx_t]
    else:
        rows = gather_edge_rows(spec_words, idx_t, k)
    # dense ids over the nodes that valid edges touch
    ends = torch.cat([g.tail[idx_t], g.head[idx_t]]).cpu().numpy()
    nodes, inv = np.unique(ends, return_inverse=True)

    def at(t, dtype=np.int32):
        return t[idx_t].cpu().numpy().astype(dtype)

    np.savez_compressed(
        path,
        version=GRAPH_FORMAT_VERSION,
        k=k,
        n_nodes=nodes.size,
        edge_limbs=convert.words_to_limbs(rows, _nlimbs(k)),
        tail=inv[: idx.size].astype(np.int32),
        head=inv[idx.size :].astype(np.int32),
        chain=np.searchsorted(idx, at(chains.chain, np.int64)).astype(np.int32),
        pos=at(chains.pos),
        length=at(chains.length),
        is_start=at(chains.is_start, bool),
        from_cycle=at(chains.from_cycle, bool),
    )


def load_graph(path: str, device) -> tuple[DeBruijnGraph, UnitigChains, int]:
    """Returns (graph, chains, k) on ``device``. The graph carries the edge
    keys and tail/head over the renumbered nodes; degrees and the successor
    tables are not stored (the chains are already resolved) and read as
    zeros and -1. The emission needs the keys and the chains only."""
    with np.load(path) as z:
        _check_version(z, GRAPH_FORMAT_VERSION, "graph")
        k = int(z["k"])
        E = z["edge_limbs"].shape[0]

        def ids(name):
            return torch.from_numpy(z[name].astype(np.int64)).to(device)

        def flags(name):
            return torch.from_numpy(z[name].astype(bool)).to(device)

        ones = torch.ones(E, dtype=torch.bool, device=device)
        zeros = torch.zeros(2 * E, dtype=torch.int64, device=device)
        g = DeBruijnGraph(
            edge_valid=ones,
            tail=ids("tail"),
            head=ids("head"),
            n_edges=E,
            n_nodes=int(z["n_nodes"]),
            indeg=zeros,
            outdeg=zeros.clone(),
            out_first=zeros.clone(),
            succ_cand=torch.full((2 * E,), -1, dtype=torch.int64, device=device),
            edge_words=convert.limbs_to_words(z["edge_limbs"], device, keys.nwords(k)),
        )
        chains = UnitigChains(
            chain=ids("chain"),
            pos=ids("pos"),
            length=ids("length"),
            is_start=flags("is_start"),
            from_cycle=flags("from_cycle"),
            in_chain=ones,
        )
    return g, chains, k
