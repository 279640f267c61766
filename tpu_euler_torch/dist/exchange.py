"""Request/reply row gather and row push between ranks.

Counterpart of ``tpu_euler/dist/exchange.py``. ``state`` is an array sharded
by rows, ``el_cap`` rows a rank, and ``gids`` are global row ids pointing
anywhere: ``rows = state[gids]`` becomes

1. requests: group the local gids by owner rank (one stable sort of the
   owner), pack them into fixed [world, c_req] slabs, all-to-all;
2. serve: each rank gathers its local rows for the gids it received;
3. replies: all-to-all back (slab positions are symmetric, so the reply to
   the request at (rank d, slot p) comes back at (chunk d, slot p)), then
   to the requests' order.

``exchange_push`` is the scatter dual. A slab that fills up drops the rest
of its group; the drops are counted and returned, so the caller can sum
them over the ranks and fail.

Each function takes per-rank lists and a comm (``dist/mesh.py``). Rows, ids
and fills are int64; an unfetched row reads -1 where the reference's reads
all-ones uint32, and a row that no ``min`` push reached reads ``keys.SENT``
(the reference's all-ones is its largest value, too). ``add`` sums in int64.
Where the reference scatters with a drop slot, the rows are selected first.
"""

from __future__ import annotations

import torch

from tpu_euler_torch.kmer import keys


def owner_slots(owner: torch.Tensor, world: int, cap: int):
    """Slab slots for rows grouped by ``owner`` [M] (``world`` = not sent).

    One stable sort of the owner alone, so that the rows of one owner keep
    their order. Returns (rows [S]: the rows that got a slot, in slab order;
    slots [S]: ``owner * cap + rank in its group``; the number of rows
    dropped because their group holds more than ``cap``)."""
    so, perm = torch.sort(owner, stable=True)
    # a group's first row: a search in the sorted owners (a scatter-min over
    # all rows, the reference's way, serializes on world + 1 addresses)
    seg_start = torch.searchsorted(so, torch.arange(world + 1, device=owner.device))
    pos = torch.arange(owner.shape[0], device=owner.device) - seg_start[so]
    sent = so < world
    ok = sent & (pos < cap)
    return perm[ok], (so * cap + pos)[ok], (sent & ~ok).sum()


def _request_slots(gids: torch.Tensor, world: int, el_cap: int, c_req: int):
    gids = gids.to(torch.int64)
    owner = torch.where(gids >= 0, gids // el_cap, world)
    return (gids, *owner_slots(owner, world, c_req))


def exchange_gather(
    states: list[torch.Tensor], gids: list[torch.Tensor], comm, el_cap: int, c_req: int,
    fill: torch.Tensor | None = None,
):
    """Fetch rows of the sharded ``states`` (a rank: [el_cap, width] int64)
    at global ids ``gids`` (a rank: [M]; -1 = no fetch).

    Returns (rows, dropped): a rank's [M, width] rows and its count of
    requests dropped. Rows for gids < 0 and for dropped requests are
    ``fill`` [width] (default all -1)."""
    world = comm.world
    width = states[0].shape[1]
    if fill is None:
        fill = torch.full((width,), -1, dtype=torch.int64, device=states[0].device)
    placed = [_request_slots(g, world, el_cap, c_req) for g in gids]
    reqs = []
    for g, rows, slots, _ in placed:
        req = torch.full((world * c_req,), -1, dtype=torch.int64, device=g.device)
        req[slots] = g[rows]
        reqs.append(req)
    served = [
        torch.where((recv >= 0)[:, None], state[recv.clamp(min=0) % el_cap], fill)
        for state, recv in zip(states, comm.all_to_all(reqs))
    ]
    outs = []
    for (g, rows, slots, _), reply in zip(placed, comm.all_to_all(served)):
        out = fill.expand(g.shape[0], width).clone()
        out[rows] = reply[slots]
        outs.append(out)
    return outs, [p[3] for p in placed]


def exchange_push(
    values: list[torch.Tensor], gids: list[torch.Tensor], comm, el_cap: int, c_req: int,
    combine: str = "set",
):
    """Deliver rows ``values`` (a rank: [M, width] int64) to the owners of
    global ids ``gids`` (a rank: [M]; -1 = no send).

    Returns (local, dropped): a rank's [el_cap, width] rows combined per
    local id, and its count of rows dropped. ``combine``: "set" (callers
    keep to one writer an id; 0 where none), "min" (``keys.SENT`` where
    none), "max" or "add" (0 where none)."""
    if combine not in ("set", "min", "max", "add"):
        raise ValueError(combine)
    world = comm.world
    width = values[0].shape[1]
    slab_gids, slab_vals, dropped = [], [], []
    for v, g in zip(values, gids):
        g, rows, slots, n_dropped = _request_slots(g, world, el_cap, c_req)
        slab_gid = torch.full((world * c_req,), -1, dtype=torch.int64, device=g.device)
        slab_gid[slots] = g[rows]
        slab_val = torch.zeros((world * c_req, width), dtype=torch.int64, device=g.device)
        slab_val[slots] = v[rows]
        slab_gids.append(slab_gid)
        slab_vals.append(slab_val)
        dropped.append(n_dropped)
    outs = []
    for recv_gid, recv_val in zip(comm.all_to_all(slab_gids), comm.all_to_all(slab_vals)):
        got = recv_gid >= 0
        li, v = recv_gid[got] % el_cap, recv_val[got]
        out = torch.full(
            (el_cap, width), keys.SENT if combine == "min" else 0, dtype=torch.int64, device=v.device
        )
        if combine == "set":
            out[li] = v
        elif combine == "add":
            out.index_add_(0, li, v)
        else:
            out.scatter_reduce_(0, li[:, None].expand(-1, width), v, "amin" if combine == "min" else "amax")
        outs.append(out)
    return outs, dropped
