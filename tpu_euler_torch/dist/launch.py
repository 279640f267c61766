"""Start the ranks of a process group on this host and collect their results.

``spawn_ranks`` is what ``--mesh N`` does where no launcher started the
ranks: N processes (``torch.multiprocessing``, start method ``spawn``), rank
r on GPU r or all on the CPU, which meet through a ``file://`` store in a
temporary directory (no port to agree on). Each rank calls
``target(comm, *args)`` with its ``ProcessComm`` and sends the result back
through a pipe of its own. A rank that fails or does not finish in time
ends the others and raises here, naming the first rank to exit: nothing
waits forever for a dead rank.
"""

from __future__ import annotations

import os
import tempfile
import time
from multiprocessing.connection import wait

import torch


def _rank_main(rank: int, world: int, store: str, device_type: str, threads: int, target, args, conn) -> None:
    from tpu_euler_torch.dist.mesh import init_process_comm

    torch.set_num_threads(threads)
    comm = init_process_comm(device_type, rank, world, f"file://{store}")
    # a rank that raises exits non-zero without closing the group, which
    # could wait for ranks that are inside a collective
    conn.send(target(comm, *args))
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
    deadline = time.monotonic() + timeout_s
    with tempfile.TemporaryDirectory() as d:
        store = os.path.join(d, "store")
        pipes = [ctx.Pipe(duplex=False) for _ in range(world)]
        procs = [
            ctx.Process(
                target=_rank_main, args=(r, world, store, device_type, threads, target, args, pipes[r][1]), daemon=True
            )
            for r in range(world)
        ]
        for p in procs:
            p.start()
        for _, w in pipes:
            w.close()  # a rank's read end reports EOF once that rank is gone
        readers = {c: r for r, (c, _) in enumerate(pipes)}
        sentinels = {p.sentinel: r for r, p in enumerate(procs)}
        got: dict = {}
        try:
            # block on every result pipe and every rank's exit at once, so a
            # rank's exit is seen when it happens: the first rank to fail is
            # named, not a peer that failed because of it. A result is read
            # as soon as it is sent (a rank blocks in send on a full pipe).
            while sentinels:
                left = deadline - time.monotonic()
                ready = wait([*readers, *sentinels], timeout=max(left, 0))
                if not ready:
                    raise TimeoutError(f"{world} ranks did not finish in {timeout_s:.0f} s")
                for c in ready:
                    if c in readers:
                        r = readers.pop(c)
                        try:
                            got[r] = c.recv()
                        except EOFError:
                            pass  # the rank ended without a result; its exit code says how
                for r in sorted(sentinels.pop(c) for c in ready if c in sentinels):
                    procs[r].join()
                    if procs[r].exitcode != 0:
                        raise RuntimeError(f"rank {r} of {world} exited with code {procs[r].exitcode}")
            for c, r in readers.items():  # a result sent just before its rank's exit
                if c.poll():
                    got[r] = c.recv()
            if len(got) < world:
                raise RuntimeError(f"{world - len(got)} of {world} ranks ended without a result")
        finally:
            for c, w in pipes:
                c.close()
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join(10)
    return [got[r] for r in range(world)]
