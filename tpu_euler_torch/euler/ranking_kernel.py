"""The ruling walk's round and the pointer-jump doubling: hand-written CUDA kernels.

Replace the reference's device loops, each of which ran as one XLA program
(``csrc/ruling_walk.cu``; its source note says what bounds them on the card
and how the design answers that):

* ``walk_round``: one capped walk round, the reference's ``_walk_round``
  (``tpu_euler/euler/ranking.py:135-256``, a ``lax.while_loop`` of hops)
  with its table append. One thread a frontier slot; it writes the owner
  words, the succ2 patch and its row of the ruler tables. With the minimum,
  the kernel takes ``succ2`` and ``t`` as words 0 and 1 of one [E + 1, 2]
  record array (``interleaved``; ``ranking._walk_start`` builds it), so a
  hop reads both in one load. The host compacts the continuations and
  reads their count, one host read a round (``walk_launch`` is the launch
  alone).
* ``jump_min`` and ``jump_rank``: every round of one of the reference's
  doubling ``fori_loop``s, min-propagating (``_contracted_cycle_min``,
  ``cut_cycles_from_t``) and weighted Wyllie (``_contracted_rank``,
  ``_patch_rank``, ``wyllie_rank``), in one cooperative launch over records
  of the state, with a grid barrier between rounds and no host read.

Each wrapper launches its kernel for CUDA tensors and runs its plain PyTorch
version (``walk_round_plain``, ``jump_min_plain``, ``jump_rank_plain``: the
rounds ``jump_min_round_plain`` and ``jump_rank_round_plain`` through
``jump``) for CPU tensors only; any other device raises. On a CUDA tensor it
launches or raises; it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_euler_torch.kmer import keys

#: kernel launches made by ``walk_round`` / ``walk_launch`` (reset freely by callers)
launches_walk = 0
#: kernel launches made by ``jump_min`` and ``jump_rank`` (one a doubling)
launches_jump = 0
#: doubling rounds those launches ran
rounds_jump = 0

_LIVENESS_EVERY = 8  # the plain walk's hops between host checks for live walks
_TABLES = ("elem", "next_r", "end_e", "hops")


def _check_i64(strided=(), **named) -> torch.device:
    """Each tensor 1-D int64 and contiguous (but those named in
    ``strided``), all on one device."""
    dev = None
    for name, x in named.items():
        if x.dtype != torch.int64 or x.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int64 tensor, got {x.dtype} {tuple(x.shape)}")
        if name not in strided and not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if dev is None:
            dev = x.device
        elif x.device != dev:
            raise ValueError(f"{name} on {x.device}, not {dev}")
    return dev


def interleaved(succ2, t) -> bool:
    """Whether ``succ2`` and ``t`` are words 0 and 1 of one [E + 1, 2]
    int64 record array (``succ2 = rec[:, 0]``, ``t = rec[:E, 1]``), aligned
    to a record: the layout the kernel reads the minimum's walk in."""
    return (
        t is not None and succ2.dim() == 1 and t.dim() == 1 and succ2.stride(0) == 2 and t.stride(0) == 2
        and succ2.dtype == t.dtype == torch.int64 and succ2.device == t.device
        and t.data_ptr() == succ2.data_ptr() + 8 and succ2.data_ptr() % 16 == 0
    )


def _check_walk(succ2, t, frontier, base: int, owner_off, walk_cap: int, tabs: dict) -> torch.device:
    if (t is None) != ("mmin" not in tabs):
        raise ValueError("the tables hold mmin exactly when t is given")
    names = _TABLES + (("mmin",) if t is not None else ())
    extra = {} if t is None else {"t": t}
    strided = ("succ2", "t") if interleaved(succ2, t) else ()
    dev = _check_i64(strided, succ2=succ2, frontier=frontier, owner_off=owner_off, **extra,
                     **{f"tabs[{n!r}]": tabs[n] for n in names})
    E = succ2.shape[0] - 1
    if owner_off.shape[0] != E + 1 or (t is not None and t.shape[0] < E):
        raise ValueError(f"succ2 and owner_off need E + 1 slots and t E: {succ2.shape}, {owner_off.shape}")
    if not 0 <= walk_cap <= 255:
        raise ValueError(f"walk_cap {walk_cap}: a hop's offset has 8 bits of the owner word")
    if base < 0 or any(tabs[n].shape[0] < base + frontier.shape[0] for n in names):
        raise ValueError(f"the tables do not hold rows [{base}, {base + frontier.shape[0]})")
    return dev


def _on_card(dev: torch.device) -> bool:
    """False for the CPU (the plain version), True for CUDA; raises else."""
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return True


def walk_round_plain(succ2, t, frontier, base: int, owner_off, walk_cap: int, tabs: dict):
    """Plain PyTorch version of the walk kernel, on any device: one capped
    lockstep walk round from ``frontier`` (element ids, -1 pad), with the
    minimum of ``t`` along each span where ``t`` is given.

    ``succ2`` and ``owner_off`` carry a spare slot at index E and are
    updated in place; the round's rows ``[base, base + s_cap)`` of ``tabs``
    get elem, next_r (next ruler element id, -1 none), end_e (chain-end
    element id, -1 none), hops (to the recorded stop) and mmin (the span's
    min key). Returns (capped, n): the continuation elements (next round's
    virtual rulers) in slot order, and their count.
    """
    _check_walk(succ2, t, frontier, base, owner_off, walk_cap, tabs)
    track_min = t is not None
    E = succ2.shape[0] - 1
    s_cap = frontier.shape[0]
    dev = frontier.device
    gid = base + torch.arange(s_cap, device=dev)

    live0 = frontier >= 0
    f_c = torch.clamp(frontier, 0, E - 1)
    owner_off[torch.where(live0, frontier, E)] = gid << 8  # rulers own themselves
    x = torch.where(live0, frontier, -1)
    raw = torch.where(live0, succ2[f_c], -1)  # succ2[x], read when x was entered
    step = torch.zeros(s_cap, dtype=torch.int64, device=dev)
    next_r = torch.full((s_cap,), -1, dtype=torch.int64, device=dev)
    end_e = torch.full((s_cap,), -1, dtype=torch.int64, device=dev)
    hops = torch.zeros(s_cap, dtype=torch.int64, device=dev)
    mmin = torch.where(live0, t[f_c], keys.SENT) if track_min else None

    # A hop with no live walk changes nothing, so liveness is read on the
    # host only every few hops instead of after each one.
    it = 0
    while it < walk_cap:
        for _ in range(min(_LIVENESS_EVERY, walk_cap - it)):
            alive = x >= 0
            stop_ruler = alive & (raw <= -2)
            stop_end = alive & (raw == -1)
            advance = alive & (raw >= 0)
            next_r = torch.where(stop_ruler, -2 - raw, next_r)
            end_e = torch.where(stop_end, x, end_e)
            hops = torch.where(stop_ruler, step + 1, torch.where(stop_end, step, hops))
            step = step + advance
            x = torch.where(advance, raw, -1)
            owner_off[torch.where(advance, raw, E)] = (gid << 8) | step
            g = torch.clamp(x, 0, E - 1)
            raw = torch.where(advance, succ2[g], -1)
            if track_min:
                mmin = torch.minimum(mmin, torch.where(advance, t[g], keys.SENT))
        it += _LIVENESS_EVERY
        if not bool((x >= 0).any()):
            break

    # classify walks still alive at the cap
    alive = x >= 0
    cap_ruler = alive & (raw <= -2)
    cap_end = alive & (raw == -1)
    cap_cont = alive & (raw >= 0)
    next_r = torch.where(cap_cont, raw, torch.where(cap_ruler, -2 - raw, next_r))
    end_e = torch.where(cap_end, x, end_e)
    hops = torch.where(cap_ruler | cap_cont, step + 1, torch.where(cap_end, step, hops))
    # continuation elements become next round's rulers; patch succ2 at their
    # (unique) predecessor so later walks stop there.
    succ2[torch.where(cap_cont, x, E)] = torch.where(cap_cont, -2 - raw, 0)
    sl = slice(base, base + s_cap)
    tabs["elem"][sl] = frontier
    tabs["next_r"][sl] = next_r
    tabs["end_e"][sl] = end_e
    tabs["hops"][sl] = hops
    if track_min:
        tabs["mmin"][sl] = mmin
    capped = raw[cap_cont]
    return capped, capped.numel()


def jump_min_round_plain(p, m, p_out, m_out) -> None:
    """Plain PyTorch version of the min-propagating jump kernel, on any
    device: ``m_out = min(m, alive ? m[p] : SENT)``, ``p_out = alive ?
    p[p] : -1`` (alive = p >= 0), from the old state only."""
    n = p.shape[0]
    alive = p >= 0
    pc = torch.clamp(p, 0, n - 1)
    m_out.copy_(torch.minimum(m, torch.where(alive, m[pc], keys.SENT)))
    p_out.copy_(torch.where(alive, p[pc], -1))


def jump_rank_round_plain(p, d, q, p_out, d_out, q_out) -> None:
    """Plain PyTorch version of the weighted Wyllie jump kernel, on any
    device: with idx = alive ? p : own index, ``p_out = alive ? p[idx] :
    -1``, ``d_out = d + (alive ? d[idx] : 0)``, ``q_out = q[idx]``, from
    the old state only."""
    n = p.shape[0]
    alive = p >= 0
    idx = torch.where(alive, p, torch.arange(n, device=p.device))
    p_out.copy_(torch.where(alive, p[idx], -1))
    d_out.copy_(d + torch.where(alive, d[idx], 0))
    q_out.copy_(q[idx])


def jump(round_fn, state: tuple, rounds: int) -> tuple:
    """``rounds`` synchronous rounds of ``round_fn(*old, *new)`` from
    ``state``, which is left as it is, through two ping-pong buffers.
    Returns the final state (``state`` itself after no round)."""
    bufs = [tuple(torch.empty_like(x) for x in state) for _ in range(min(rounds, 2))]
    for r in range(rounds):
        new = bufs[r % 2]
        round_fn(*state, *new)
        state = new
    return state


def jump_min_plain(p, m, rounds: int) -> tuple:
    """Plain PyTorch version of the min-propagating doubling kernel, on any
    device: ``rounds`` rounds of ``jump_min_round_plain``."""
    return jump(jump_min_round_plain, (p, m), rounds)


def jump_rank_plain(p, d, q, rounds: int) -> tuple:
    """Plain PyTorch version of the weighted Wyllie doubling kernel, on any
    device: ``rounds`` rounds of ``jump_rank_round_plain``."""
    return jump(jump_rank_round_plain, (p, d, q), rounds)


_ARGS = {
    "ruling_walk_round": [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_void_p] * 7
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    "pointer_jump_min": [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    "pointer_jump_rank": [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
}


def _lib(name: str):
    from tpu_euler_torch import _build

    lib = _build.load("ruling_walk", ["ruling_walk.cu"], headers=("ruling_walk.cuh",))
    fn = getattr(lib, name)
    fn.argtypes = _ARGS[name]
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Compile and load the kernels now (they are otherwise built at first use)."""
    _lib("ruling_walk_round")


def _launch(name: str, dev: torch.device, *args) -> None:
    fn = _lib(name)
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _ptr(x):
    return None if x is None else x.data_ptr()


def _check_record(succ2, t) -> None:
    """The kernel's walk with the minimum reads succ2 and t from one record."""
    if t is not None and not interleaved(succ2, t):
        raise ValueError("on the card succ2 and t must be words 0 and 1 of one [E + 1, 2] int64 record "
                         "(ranking._walk_start)")


def walk_launch(succ2, t, frontier, base: int, owner_off, walk_cap: int, tabs: dict):
    """The walk kernel's launch alone, on CUDA tensors that ``walk_round``
    has checked: no compaction and no host read. Returns the continuation
    element of each slot (-1 for none)."""
    global launches_walk
    _check_record(succ2, t)
    dev = frontier.device
    s_cap = frontier.shape[0]
    cont = torch.empty(s_cap, dtype=torch.int64, device=dev)
    if s_cap:
        _launch(
            "ruling_walk_round", dev, succ2.data_ptr(), frontier.data_ptr(), s_cap, owner_off.data_ptr(),
            *(tabs[n].data_ptr() for n in _TABLES), _ptr(tabs.get("mmin")), cont.data_ptr(), base, walk_cap,
        )
        launches_walk += 1
    return cont


def walk_round(succ2, t, frontier, base: int, owner_off, walk_cap: int, tabs: dict):
    """Same contract as ``walk_round_plain``; launches the CUDA kernel for
    CUDA tensors, where ``t`` (if given) must be ``interleaved`` with
    ``succ2``. Returns after one host read: the continuations' count."""
    dev = _check_walk(succ2, t, frontier, base, owner_off, walk_cap, tabs)
    if not _on_card(dev):
        return walk_round_plain(succ2, t, frontier, base, owner_off, walk_cap, tabs)
    cont = walk_launch(succ2, t, frontier, base, owner_off, walk_cap, tabs)
    capped = cont[cont >= 0]  # slot order, as the plain version's raw[cap_cont]
    return capped, capped.numel()


def _check_jump(rounds: int, **named) -> torch.device:
    dev = _check_i64(**named)
    if len({x.shape[0] for x in named.values()}) != 1:
        raise ValueError(f"{', '.join(named)} must have one length")
    if rounds < 0:
        raise ValueError(f"rounds {rounds} < 0")
    return dev


def _jump_launch(name: str, dev: torch.device, state: tuple, rounds: int, record_words: int) -> tuple:
    """One launch of every round into new output arrays, through two
    buffers of records of ``record_words`` int64 words."""
    global launches_jump, rounds_jump
    if rounds == 0:
        return state
    n = state[0].shape[0]
    outs = tuple(torch.empty_like(x) for x in state)
    if n:
        bufs = torch.empty((2, n, record_words), dtype=torch.int64, device=dev)
        _launch(name, dev, *(x.data_ptr() for x in (*state, *outs)), bufs[0].data_ptr(), bufs[1].data_ptr(),
                n, rounds)
        launches_jump += 1
        rounds_jump += rounds
    return outs


def jump_min(p, m, rounds: int) -> tuple:
    """Min-propagating pointer jumping: the final (p, m) after ``rounds``
    synchronous rounds (``(p, m)`` itself after none); on the card one
    launch of the kernel."""
    dev = _check_jump(rounds, p=p, m=m)
    if not _on_card(dev):
        return jump_min_plain(p, m, rounds)
    return _jump_launch("pointer_jump_min", dev, (p, m), rounds, 2)


def jump_rank(p, d, q, rounds: int) -> tuple:
    """Weighted Wyllie pointer jumping: the final (p, d, q) after ``rounds``
    synchronous rounds (``(p, d, q)`` itself after none); on the card one
    launch of the kernel."""
    dev = _check_jump(rounds, p=p, d=d, q=q)
    if not _on_card(dev):
        return jump_rank_plain(p, d, q, rounds)
    return _jump_launch("pointer_jump_rank", dev, (p, d, q), rounds, 4)
