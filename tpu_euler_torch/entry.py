"""The multi-rank dry run.

Counterpart of ``__graft_entry__.py`` ``dryrun_multichip``: three small
assemblies through the sharded mode's real machinery, each held to the CPU
oracle. The reference's ``entry()`` has no counterpart here: it hands XLA a
function to compile.

    python -m tpu_euler_torch.entry 4            # four ranks held on the default device
    python -m tpu_euler_torch.entry 8 --device cpu

``dryrun_multichip(n, comm=...)`` runs on the ranks of any comm
(``dist/mesh.py``): inside a ``spawn_ranks`` target that is a
``ProcessComm``, one rank a GPU over NCCL.
"""

from __future__ import annotations

import logging


def dryrun_multichip(n_ranks: int, comm=None, device=None) -> dict:
    """Three phases, each with exact canonical contig-set equality against
    the oracle [reference dryrun_multichip, __graft_entry__.py:31]:

    1. reads with errors, a frequency cutoff and tip clipping through the
       sharded traversal, with a first slab factor that is too small on
       purpose, so that the overflow's retry runs;
    2. the same reads with tips and bubbles through the sharded traversal
       and through the replicated one;
    3. k = 41 (keys of two words) through the sharded traversal.

    ``comm`` defaults to a ``LoopbackComm`` of ``n_ranks`` on ``device``
    (default: the first CUDA device; there is no silent CPU run). Returns
    a summary of the three phases, and prints a line of it."""
    import torch

    from tpu_euler_torch.config import AssemblyConfig
    from tpu_euler_torch.dist.mesh import LoopbackComm
    from tpu_euler_torch.dist.pipeline import assemble_reads_distributed
    from tpu_euler_torch.oracle import assemble_oracle, canonical_contig_set
    from tpu_euler_torch.simulate import random_genome, simulate_reads

    if comm is None:
        comm = LoopbackComm(n_ranks, torch.device(device if device is not None else "cuda:0"))
    assert comm.world == n_ranks, f"need {n_ranks} ranks, the comm has {comm.world}"

    # --- phase 1: errors, cutoff + tips, sharded, a forced slab overflow, at
    # a size where sharding matters (a graph of about 37 k edges)
    genome = random_genome(60_000, seed=1234)
    reads = simulate_reads(genome, read_len=100, coverage=20, seed=5678, error_rate=0.003, circular=True)
    cfg = AssemblyConfig(
        k=31, read_batch=max(64, 2048 // n_ranks), read_len=100, spectrum_capacity=1 << 18,
        min_count=3, tip_rounds=3,
    )
    expected = assemble_oracle(reads, cfg.k, min_count=cfg.min_count, tip_rounds=cfg.tip_rounds)
    retries: list[str] = []

    class _Catch(logging.Handler):
        def emit(self, record):
            if "retrying with a bigger slab" in record.getMessage():
                retries.append(record.getMessage())

    h = _Catch()
    logging.getLogger("tpu_euler_torch").addHandler(h)
    try:
        result = assemble_reads_distributed(
            reads, cfg, comm, shard_traversal=True, slab_factors=(0.02, 2.0, 8.0),  # the first must overflow
        )
    finally:
        logging.getLogger("tpu_euler_torch").removeHandler(h)
    got = canonical_contig_set(result.contig_strings)
    assert got == expected, f"sharded errored-read dryrun mismatch: {len(got)} vs {len(expected)}"
    assert retries, "slab factor 0.02 did not exercise the retry"

    # --- phase 2: tips and bubbles, sharded and replicated
    cfg_b = AssemblyConfig(
        k=31, read_batch=max(64, 2048 // n_ranks), read_len=100, spectrum_capacity=1 << 18,
        min_count=3, tip_rounds=3, bubble_rounds=2,
    )
    expected_b = assemble_oracle(reads, cfg_b.k, min_count=3, tip_rounds=3, bubble_rounds=2)
    result_b = assemble_reads_distributed(reads, cfg_b, comm, shard_traversal=True)
    got_b = canonical_contig_set(result_b.contig_strings)
    assert got_b == expected_b, f"sharded tips+bubbles dryrun mismatch: {len(got_b)} vs {len(expected_b)}"
    result_br = assemble_reads_distributed(reads, cfg_b, comm, shard_traversal=False)
    assert canonical_contig_set(result_br.contig_strings) == expected_b, "replicated tips+bubbles dryrun mismatch"

    # --- phase 3: k = 41 through the sharded traversal
    genome3 = random_genome(3_000, seed=4321)
    reads3 = simulate_reads(genome3, read_len=120, coverage=15, seed=8765, circular=True)
    cfg3 = AssemblyConfig(k=41, read_batch=64, read_len=120, spectrum_capacity=max(1 << 13, n_ranks * 64))
    expected3 = assemble_oracle(reads3, cfg3.k)
    result3 = assemble_reads_distributed(reads3, cfg3, comm, shard_traversal=True)
    got3 = canonical_contig_set(result3.contig_strings)
    assert got3 == expected3, f"k=41 sharded dryrun mismatch: {len(got3)} vs {len(expected3)}"

    summary = {
        "ranks": n_ranks, "reads": result.n_reads, "kmers": result.n_distinct_kmers, "contigs": len(got),
        "retries": len(retries), "contigs_tips_bubbles": len(got_b), "contigs_k41": len(got3),
    }
    print(
        f"dryrun_multichip({n_ranks}): OK: "
        f"[1] {result.n_reads} errored reads, cutoff+tips, sharded traversal "
        f"({result.n_distinct_kmers} kmers, {len(got)} contigs, {len(retries)} slab retries), "
        f"[2] tips+bubbles sharded and replicated ({len(got_b)} contigs), "
        f"[3] k=41 sharded ({len(got3)} contigs): all equal to the CPU oracle"
    )
    return summary


def dryrun_rank(comm) -> dict:
    """A ``spawn_ranks`` target: the dry run on this process's rank."""
    return dryrun_multichip(comm.world, comm=comm)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=8, help="ranks held on the device")
    ap.add_argument("--device", default="cuda:0", help="cuda:0 (default) or cpu")
    args = ap.parse_args()
    dryrun_multichip(args.n, device=args.device)
