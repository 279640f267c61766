"""Ranks, devices and collectives of the sharded mode.

Counterpart of ``tpu_euler/dist/mesh.py``. The reference is one process over
a device mesh, and ``shard_map`` hands each device its block of every
array. ``torch.distributed`` is one process a rank. The port writes each
shard-local computation as a plain function of one rank's tensors, and each
step of the sharded mode as a function of per-rank lists and a *comm*: the
step maps the shard-local function over the ranks the comm holds and calls
the comm where the reference calls a collective. Two comms share that
interface:

* ``ProcessComm``: this process is one rank of a ``torch.distributed`` group
  (NCCL where its device is a CUDA device, gloo on the CPU), so its lists
  hold one tensor. One rank a GPU.
* ``LoopbackComm``: this process holds all ``world`` ranks on one device,
  so its lists hold ``world`` tensors, and a collective is a transpose of
  slabs between them. It runs the sharded mode on one card (or the CPU)
  with every shard's contents what the process group would give.

The interface: ``world``; ``ranks`` (the ranks held here); ``device``;
``all_to_all`` (equal slabs along dimension 0: the reference's tiled
``lax.all_to_all``), ``all_gather`` (concatenated along dimension 0, in rank
order), ``all_reduce_sum`` (``lax.psum``), each from a list with one tensor
a held rank to such a list; ``process_allgather`` (a few host integers from
every process).
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch


#: how long a rank waits in a collective for the others before it fails
COLLECTIVE_TIMEOUT_S = 600.0


def rank_device(device_type: str, local_rank: int, n_local: int) -> torch.device:
    """The device of local rank ``local_rank`` of ``n_local`` on this host
    [reference make_mesh, :23]: GPU ``local_rank`` on CUDA, one rank a GPU
    (NCCL refuses two ranks on one), and the CPU otherwise."""
    if device_type != "cuda":
        return torch.device(device_type)
    have = torch.cuda.device_count()
    if n_local > have:
        raise ValueError(f"requested {n_local} devices, have {have}")
    return torch.device("cuda", local_rank)


def _check_slabs(xs: list[torch.Tensor], world: int) -> None:
    if any(x.shape[0] % world for x in xs):
        raise ValueError(f"all_to_all of {xs[0].shape[0]} rows does not split into {world} equal slabs")


class LoopbackComm:
    """All ``world`` ranks in this process, on one device."""

    def __init__(self, world: int, device):
        if world < 1:
            raise ValueError(f"a comm needs at least one rank, got {world}")
        self.world = world
        self.ranks = list(range(world))
        self.device = torch.device(device)

    def all_to_all(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        _check_slabs(xs, self.world)
        c = xs[0].shape[0] // self.world
        return [torch.cat([x[r * c : (r + 1) * c] for x in xs]) for r in self.ranks]

    def all_gather(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        return [torch.cat(xs)] * self.world

    def all_reduce_sum(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        return [torch.stack(xs).sum(0)] * self.world

    def process_allgather(self, values) -> np.ndarray:
        return np.asarray([values], dtype=np.int64)


class ProcessComm:
    """This process as one rank of the default ``torch.distributed`` group,
    which ``init_process_comm`` sets up."""

    def __init__(self, device):
        import torch.distributed as dist

        self._dist = dist
        self.world = dist.get_world_size()
        self.ranks = [dist.get_rank()]
        self.device = torch.device(device)

    def all_to_all(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        _check_slabs(xs, self.world)
        (x,) = xs
        out = torch.empty_like(x)
        self._dist.all_to_all_single(out, x.contiguous())
        return [out]

    def all_gather(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        (x,) = xs
        parts = [torch.empty_like(x) for _ in range(self.world)]
        self._dist.all_gather(parts, x.contiguous())
        return [torch.cat(parts)]

    def all_reduce_sum(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        (x,) = xs
        out = x.clone()
        self._dist.all_reduce(out)
        return [out]

    def process_allgather(self, values) -> np.ndarray:
        x = torch.tensor(list(values), dtype=torch.int64, device=self.device)
        return self.all_gather([x])[0].cpu().numpy().reshape(self.world, -1)

    def close(self) -> None:
        self._dist.destroy_process_group()


def init_process_comm(
    device_type: str,
    rank: int | None = None,
    world: int | None = None,
    init_method: str | None = None,
) -> ProcessComm:
    """Join the process group as one rank and return its comm [reference
    maybe_initialize_distributed, :17].

    With ``rank``, ``world`` and ``init_method`` given (``file://...`` or
    ``tcp://host:port``) the ranks are taken to share this host, rank r on
    GPU r. Without them the launcher's environment is read (``torchrun``:
    RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and
    MASTER_PORT). The backend follows the device: NCCL for ``cuda``, gloo
    for ``cpu``; there is no second choice where one fails.
    """
    import torch.distributed as dist

    if rank is None:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        n_local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        init_method = "env://"
    else:
        local_rank, n_local = rank, world
    device = rank_device(device_type, local_rank, n_local)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
    )
    return ProcessComm(device)


def fetch_global(comm, xs: list[torch.Tensor]) -> np.ndarray:
    """A sharded array whole on this host: the ranks' blocks along
    dimension 0, in rank order [reference fetch_global, :37]."""
    return comm.all_gather(xs)[0].cpu().numpy()
