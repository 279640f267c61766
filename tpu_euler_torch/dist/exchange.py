"""Request/reply row gather and row push between ranks.

Counterpart of ``tpu_euler/dist/exchange.py``. ``state`` is an array sharded
by rows, ``el_cap`` rows a rank, and ``gids`` are global row ids pointing
anywhere: ``rows = state[gids]`` becomes

1. requests: group the local gids by owner rank (one stable sort of the
   owner), pack them into fixed [world, c_req] slabs, all-to-all;
2. serve: each rank looks its local rows up for the gids it received (a
   slab is mostly empty, so only for the rows that hold a request);
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


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for a 2-D ``x``. Rows whose size is a multiple of 16
    bytes are taken a column at a time: torch's CUDA index kernel for such
    rows (``vectorized_gather_kernel``, torch 2.11) works a block a row, and
    took 4.3 ms for 6 M rows of two int64 where two column gathers took 1.2
    (H100; ``time_kernels.py --gather``). Other widths are faster whole."""
    if x.shape[1] > 1 and x.shape[1] * x.element_size() % 16 == 0:
        return torch.stack([x[:, c][idx] for c in range(x.shape[1])], 1)
    return x[idx]


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


def _serve(state: torch.Tensor, recv: torch.Tensor, el_cap: int, fill: torch.Tensor) -> torch.Tensor:
    """A rank's replies to the request slab ``recv`` it received (global
    ids, -1 = empty): ``state``'s rows, ``fill`` where there is no request.
    A slab is sized for the worst imbalance and mostly empty, so only the
    rows that hold a request are looked up."""
    idx = torch.nonzero(recv >= 0).squeeze(1)
    served = fill.expand(recv.shape[0], state.shape[1]).clone()
    served[idx] = take_rows(state, recv[idx] % el_cap)
    return served


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
    served = [_serve(state, recv, el_cap, fill) for state, recv in zip(states, comm.all_to_all(reqs))]
    outs = []
    for (g, rows, slots, _), reply in zip(placed, comm.all_to_all(served)):
        out = fill.expand(g.shape[0], width).clone()
        out[rows] = take_rows(reply, slots)
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
        slab_val[slots] = take_rows(v, rows)
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
