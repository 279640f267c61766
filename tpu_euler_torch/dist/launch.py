"""Start the ranks of a process group on this host and collect their results.

``spawn_ranks`` is what ``--mesh N`` does where no launcher started the
ranks: N processes (``torch.multiprocessing``, start method ``spawn``), rank
r on GPU r or all on the CPU, which meet through a ``file://`` store in a
temporary directory (no port to agree on). Each rank calls
``target(comm, *args)`` with its ``ProcessComm`` and sends the result back.
A rank that fails or does not finish in time ends the others and raises
here: nothing waits forever for a dead rank.
"""

from __future__ import annotations

import os
import queue
import tempfile
import time

import torch


def _rank_main(rank: int, world: int, store: str, device_type: str, threads: int, target, args, results) -> None:
    from tpu_euler_torch.dist.mesh import init_process_comm

    torch.set_num_threads(threads)
    comm = init_process_comm(device_type, rank, world, f"file://{store}")
    # a rank that raises exits non-zero without closing the group, which
    # could wait for ranks that are inside a collective
    results.put((rank, target(comm, *args)))
    comm.close()


def assemble_rank(
    comm, codes_path, cfg, local_input: bool = False, warm_up: bool = False,
    shard_traversal: bool = False, slab_factors: tuple = (2.0, 4.0, 8.0),
):
    """A ``spawn_ranks`` target: ``assemble_reads_distributed`` on the
    [R, read_len] int8 code matrix saved at ``codes_path`` (``np.save``),
    which the rank maps rather than loads; a list of paths gives each rank
    its own, for ``local_input``. ``warm_up`` runs it once before the run
    whose result and stage times are returned. ``shard_traversal`` and
    ``slab_factors`` are the pipeline's."""
    import numpy as np

    from tpu_euler_torch.dist.pipeline import assemble_reads_distributed

    path = codes_path if isinstance(codes_path, str) else codes_path[comm.ranks[0]]
    codes = np.load(path, mmap_mode="c")  # mapped, and writable in memory only
    for _ in range(2 if warm_up else 1):
        result = assemble_reads_distributed(
            None, cfg, comm, codes=codes, local_input=local_input,
            shard_traversal=shard_traversal, slab_factors=slab_factors,
        )
    return result


def spawn_ranks(world: int, device_type: str, target, args=(), timeout_s: float = 600.0, threads: int = 0) -> list:
    """Run ``target(comm, *args)`` on ``world`` ranks of a new process group
    and return their results in rank order.

    ``target`` must be importable (a module-level function) and ``args``
    picklable and small: hand a large array over as a file to map. On
    ``cuda`` more ranks than GPUs raises ``requested N devices, have M``.
    ``threads`` bounds each rank's CPU threads (0: the cores divided among
    the ranks)."""
    import torch.multiprocessing as mp

    from tpu_euler_torch.dist.mesh import rank_device

    rank_device(device_type, 0, world)  # enough devices, before anything starts
    threads = threads or max(1, (os.cpu_count() or 1) // world)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    deadline = time.monotonic() + timeout_s
    with tempfile.TemporaryDirectory() as d:
        store = os.path.join(d, "store")
        procs = [
            ctx.Process(
                target=_rank_main, args=(r, world, store, device_type, threads, target, args, results), daemon=True
            )
            for r in range(world)
        ]
        for p in procs:
            p.start()
        got: dict = {}
        try:
            # results are read before any join: a child blocks in exit until
            # its queued result has been taken
            while len(got) < world:
                try:
                    rank, result = results.get(timeout=0.2)
                    got[rank] = result
                    continue
                except queue.Empty:
                    pass
                failed = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError(f"rank {failed[0][0]} of {world} exited with code {failed[0][1]}")
                if all(p.exitcode == 0 for p in procs) and results.empty():
                    raise RuntimeError(f"{world - len(got)} of {world} ranks ended without a result")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks did not finish in {timeout_s:.0f} s")
            for r, p in enumerate(procs):
                p.join(max(1.0, deadline - time.monotonic()))
                if p.exitcode != 0:
                    raise RuntimeError(f"rank {r} of {world} exited with code {p.exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join(10)
    return [got[r] for r in range(world)]
