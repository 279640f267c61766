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
* ``jump_labels``: the Eulerian tour's label doubling, the reference's
  ``_labels`` (``tpu_euler/euler/tour.py:90-124``, its ``fori_loop`` at
  :115) whole, in one cooperative launch: the initial state, every round
  and the final select of label and on-cycle flag.
* ``ruling_labels``: the same labels where that doubling has converged
  (``log2_ceil(E) + 1`` rounds, what the tour runs), by a ruling set in
  O(E) work: a count launch (has-predecessor bits, rulers), one host read
  of the ruler count, and a labels launch (a walk a ruler, a doubling over
  the rulers' rows, a gather back). What the tour calls on the card.
* ``cut_tables``: the cut list's first-cut tables, the reference's
  ``_cut_tables`` (``tpu_euler/euler/ranking.py:510``): for each ruler gid
  the smallest offset of a cut edge it owns and that edge. One pass over
  the cut flags in which only a covered cut lane takes an atomic minimum,
  in place of two scatter minima that send every other lane to one spare
  slot.

Each wrapper launches its kernel for CUDA tensors and runs its plain PyTorch
version (``walk_round_plain``, ``jump_min_plain``, ``jump_rank_plain``: the
rounds ``jump_min_round_plain`` and ``jump_rank_round_plain`` through
``jump``; ``jump_labels_plain``; ``ruling_labels_plain``;
``cut_tables_plain``) for CPU tensors only; any other device raises. On a CUDA tensor it launches or raises; it
never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_euler_torch import trace
from tpu_euler_torch.kmer import keys

#: the stats words of the last ``ruling_labels`` call on the card (``label_stats`` reads them)
last_label_stats = None

#: ids a hash-sampled ruler of ``ruling_labels`` stands for, on average;
#: None: ``label_stride(E)``
LABEL_RULER_STRIDE: int | None = None
# csrc/ruling_walk.cuh: kLabelRulers, kLabelBad, kLabelSlots, kLabelUncovered,
# kLabelLongest, then kLabelStamps phase-end stamps
_LABEL_STAMP, _LABEL_STATS = 5, 15
_LABEL_PHASES = ("zero", "mark", "count", "host", "claim", "walk", "contract", "gather", "uncovered")

_LIVENESS_EVERY = 8  # the plain walk's hops between host checks for live walks
_TABLES = ("elem", "next_r", "end_e", "hops")

#: the first-cut offset ``cut_tables`` gives a gid that owns no cut (csrc/ruling_walk.cuh kCutNoOffset)
NO_CUT = 1 << 30
_CUT_EDGE_BITS = 40  # the kernel packs (offset << 40) | edge: edge ids below 2^40


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


def jump_labels_plain(succ, valid, rounds: int) -> tuple:
    """Plain PyTorch version of the label kernel, on any device: (label
    [E], on_cycle [E]) after ``rounds`` synchronous rounds from p = succ, m
    = own id, q = succ >= 0 ? succ : own id; a cycle's edges carry the
    smallest edge id on it, a path's edges E + their last edge's id,
    invalid edges 2E."""
    E = succ.shape[0]
    eid = torch.arange(E, device=succ.device)
    p = succ.clone()
    m = eid
    q = torch.where(succ >= 0, succ, eid)
    for _ in range(rounds):
        alive = p >= 0
        idx = torch.where(alive, p, eid)
        p, m, q = (
            torch.where(alive, p[idx], -1),
            torch.minimum(m, torch.where(alive, m[idx], E)),
            q[idx],
        )
    on_cycle = (p >= 0) & valid
    return torch.where(valid, torch.where(on_cycle, m, E + q), 2 * E), on_cycle


def cut_tables_plain(is_cut, owner_off, S: int) -> tuple:
    """Plain PyTorch version of the cut-table kernel, on any device: per
    ruler gid of ``S``, (the smallest hop offset of a cut edge it owns,
    ``NO_CUT`` where none; the smallest cut edge id at that offset, E where
    none), over the edges whose ``is_cut`` is set and whose owner word is
    not -1. Two scatter minima over every edge; a lane that is not such a
    cut writes to the spare slot S."""
    E = is_cut.shape[0]
    covered = owner_off >= 0
    gid = torch.clamp(owner_off >> 8, 0, S - 1)
    off = owner_off & 0xFF
    use = is_cut & covered
    m1 = torch.full((S + 1,), NO_CUT, dtype=torch.int64, device=is_cut.device)
    m1.scatter_reduce_(0, torch.where(use, gid, S), torch.where(use, off, NO_CUT), "amin")
    m1 = m1[:S]
    at_m1 = use & (off == m1[gid])
    cut_edge = torch.full((S + 1,), E, dtype=torch.int64, device=is_cut.device)
    eid = torch.arange(E, device=is_cut.device)
    cut_edge.scatter_reduce_(
        0, torch.where(at_m1, gid, S), torch.where(at_m1, eid, E), "amin"
    )
    return m1, cut_edge[:S]


def full_label_rounds(E: int) -> int:
    """The rounds at which the label doubling has converged for E elements,
    the tour's: log2_ceil(E) + 1."""
    return max(1, (E - 1).bit_length()) + 1


def _full_rounds(E: int, rounds: int | None) -> int:
    full = full_label_rounds(E)
    if rounds is None:
        return full
    if rounds < full:
        raise ValueError(f"the ruling labels are the doubling's at {full} rounds or more, not {rounds}")
    return rounds


def ruling_labels_plain(succ, valid, rounds: int | None = None) -> tuple:
    """Plain PyTorch version of the ruling label kernel, on any device:
    ``jump_labels_plain`` at ``rounds`` (``full_label_rounds(E)`` where
    None), which must be at least that."""
    return jump_labels_plain(succ, valid, _full_rounds(succ.shape[0], rounds))


def label_stride(E: int) -> int:
    """The ruler stride of ``ruling_labels`` over E elements:
    ``LABEL_RULER_STRIDE``, or where that is None the power of two at or
    above E / 2^20, from 8 to 64. About 2^20 sampled rulers keep the rows'
    two 8-byte buffers in L2; a larger stride lengthens the walks (on the
    H100 at 700 W, 8 and 16 ran faster than 32 and 64 on config 2's tour
    graph, E ~ 10 M, and 64 faster than 8 to 32 on config 5's, E ~ 212 M:
    PERF.md section 6)."""
    if LABEL_RULER_STRIDE is not None:
        return LABEL_RULER_STRIDE
    return min(64, max(8, 1 << (-(-E >> 20) - 1).bit_length()))


def label_sampled(ids: torch.Tensor, stride: int) -> torch.Tensor:
    """Whether ``ruling_labels``' hash samples each id as a ruler at 1 in
    ``stride``: ``keys._mix32(id) < 2^32 // stride``, as the kernel's
    ``label_sampled``."""
    return keys._mix32(ids) < (1 << 32) // stride


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
    "pointer_jump_labels": [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    "ruling_labels_count": [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_ulonglong, ctypes.c_void_p],
    "ruling_labels_walk": [ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_ulonglong, ctypes.c_void_p],
    "ruling_cut_tables": [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p],
}


def _lib(name: str):
    from tpu_euler_torch import _build

    lib = _build.load("ruling_walk", ["ruling_walk.cu"], headers=("ruling_walk.cuh",))
    fn = getattr(lib, name)
    fn.argtypes = _ARGS[name]
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Compile and load the kernels now (they are otherwise built at first
    use), and with them the emission's (``emit_kernel``), which runs after
    the walk on every device assembly."""
    from tpu_euler_torch.euler import emit_kernel

    _lib("ruling_walk_round")
    emit_kernel.build()


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
    _check_record(succ2, t)
    dev = frontier.device
    s_cap = frontier.shape[0]
    cont = torch.empty(s_cap, dtype=torch.int64, device=dev)
    if s_cap:
        _launch(
            "ruling_walk_round", dev, succ2.data_ptr(), frontier.data_ptr(), s_cap, owner_off.data_ptr(),
            *(tabs[n].data_ptr() for n in _TABLES), _ptr(tabs.get("mmin")), cont.data_ptr(), base, walk_cap,
        )
        trace.add("walk_launches")
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
    if rounds == 0:
        return state
    n = state[0].shape[0]
    outs = tuple(torch.empty_like(x) for x in state)
    if n:
        bufs = torch.empty((2, n, record_words), dtype=torch.int64, device=dev)
        _launch(name, dev, *(x.data_ptr() for x in (*state, *outs)), bufs[0].data_ptr(), bufs[1].data_ptr(),
                n, rounds)
        trace.add("jump_launches")
        trace.add("jump_rounds", rounds)
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


def _check_labels(succ, valid, rounds: int) -> torch.device:
    """succ 1-D int64, valid a contiguous bool tensor of its length on its
    device, rounds >= 0; and fewer than 2^31 elements on the card, where
    the label kernels' ids are 32-bit."""
    dev = _check_jump(rounds, succ=succ)
    if valid.dtype != torch.bool or valid.shape != succ.shape or not valid.is_contiguous() or valid.device != dev:
        raise ValueError(f"valid must be a contiguous bool tensor of succ's length on {dev}")
    if succ.shape[0] >= 1 << 31 and dev.type != "cpu":
        raise ValueError(f"the label kernels' ids are 32-bit: E={succ.shape[0]}")
    return dev


def jump_labels(succ, valid, rounds: int) -> tuple:
    """The tour's labels: (label [E] int64, on_cycle [E] bool) after
    ``rounds`` synchronous rounds of the label doubling from ``succ`` (-1
    for none) and ``valid`` [E] bool, as ``jump_labels_plain``; on the card
    one launch of the kernel (also at no round, which runs the initial
    state's select), and E < 2^31."""
    dev = _check_labels(succ, valid, rounds)
    if not _on_card(dev):
        return jump_labels_plain(succ, valid, rounds)
    E = succ.shape[0]
    label = torch.empty_like(succ)
    on_cycle = torch.empty_like(valid)
    if E:
        bufs = torch.empty((2, E if rounds else 0, 2), dtype=torch.int64, device=dev)  # (p, m << 32 | q) records
        _launch("pointer_jump_labels", dev, succ.data_ptr(), valid.data_ptr(), label.data_ptr(), on_cycle.data_ptr(),
                bufs[0].data_ptr(), bufs[1].data_ptr(), E, rounds)
        trace.add("label_launches")
        trace.add("label_rounds", rounds)
    return label, on_cycle


def ruling_labels(succ, valid, rounds: int | None = None) -> tuple:
    """The tour's labels, (label [E] int64, on_cycle [E] bool), as
    ``jump_labels_plain`` at ``rounds`` (``full_label_rounds(E)`` where
    None; fewer raises, since the doubling has not converged there). On the
    card: E < 2^31 and ``succ`` injective with values below E (the tour's
    successors are), else it raises; two launches (the count, the labels)
    with one host read between them, the ruler count; the stats words stay
    in ``last_label_stats``."""
    global last_label_stats
    E = succ.shape[0]
    dev = _check_labels(succ, valid, _full_rounds(E, rounds))
    if not _on_card(dev):
        return ruling_labels_plain(succ, valid, rounds)
    label = torch.empty_like(succ)
    on_cycle = torch.empty_like(valid)
    if not E:
        return label, on_cycle
    below = (1 << 32) // label_stride(E)
    stats = torch.empty(_LABEL_STATS, dtype=torch.int64, device=dev)
    bits = torch.empty((E + 31) // 32, dtype=torch.int32, device=dev)
    owner = torch.empty(E, dtype=torch.int32, device=dev)
    _launch("ruling_labels_count", dev, succ.data_ptr(), bits.data_ptr(), stats.data_ptr(), E, below)
    rulers, bad = stats[:2].tolist()  # the one host read
    if bad:
        raise ValueError("ruling_labels: succ repeats a successor or points past its end")
    rows = torch.empty((2, max(rulers, 1), 2), dtype=torch.int32, device=dev)
    _launch("ruling_labels_walk", dev, succ.data_ptr(), valid.data_ptr(), label.data_ptr(), on_cycle.data_ptr(),
            bits.data_ptr(), owner.data_ptr(), rows[0].data_ptr(), rows[1].data_ptr(), stats.data_ptr(), E, below)
    trace.add("ruling_label_calls")
    last_label_stats = stats
    return label, on_cycle


def _check_cut(is_cut, owner_off, S: int) -> torch.device:
    """is_cut a contiguous 1-D bool tensor, owner_off a 1-D int64 one of its
    length on its device, and at least one gid."""
    dev = _check_i64(owner_off=owner_off)
    if (is_cut.dtype != torch.bool or is_cut.shape != owner_off.shape or not is_cut.is_contiguous()
            or is_cut.device != dev):
        raise ValueError(f"is_cut must be a contiguous bool tensor of owner_off's length on {dev}")
    if S < 1:
        raise ValueError(f"the cut tables need a gid: S={S}")
    return dev


def cut_tables(is_cut, owner_off, S: int) -> tuple:
    """The cut list's first-cut tables, (m1 [S], cut_edge [S]), as
    ``cut_tables_plain``. On the card E < 2^40 (an edge id fits the packed
    key) and one cooperative launch: the table started, the pass over the
    cut flags (only a covered cut lane loads its owner word and takes an
    atomic) and the unpack; no host read."""
    dev = _check_cut(is_cut, owner_off, S)
    if not _on_card(dev):
        return cut_tables_plain(is_cut, owner_off, S)
    E = is_cut.shape[0]
    if E >= 1 << _CUT_EDGE_BITS:
        raise ValueError(f"the cut tables pack an edge id in {_CUT_EDGE_BITS} bits: E={E}")
    m1 = torch.empty(S, dtype=torch.int64, device=dev)
    cut_edge = torch.empty(S, dtype=torch.int64, device=dev)
    _launch("ruling_cut_tables", dev, is_cut.data_ptr(), owner_off.data_ptr(), m1.data_ptr(), cut_edge.data_ptr(), E, S)
    trace.add("cut_table_launches")
    trace.add("cut_table_rows", E)
    return m1, cut_edge


def label_stats(stats=None) -> dict:
    """The counts and phase times of a ``ruling_labels`` call from its
    stats words (``last_label_stats`` where None; a host read): rulers,
    elements no walk covered, the longest sublist, the rows' doubling
    rounds, the ms of each phase by the card's clock (``host`` is the read
    of the ruler count and the allocations between the launches) and their
    sum, from the count launch's start to the labels launch's end."""
    s = (last_label_stats if stats is None else stats).tolist()
    rulers, uncovered = s[0], s[3]
    stamps = s[_LABEL_STAMP:]
    return {
        "rulers": rulers, "uncovered": uncovered, "longest_sublist": s[4],
        "row_rounds": full_label_rounds(rulers) if rulers else 0,
        "uncovered_rounds": full_label_rounds(uncovered) if uncovered else 0,
        "phase_ms": {name: (stamps[k + 1] - stamps[k]) / 1e6 for k, name in enumerate(_LABEL_PHASES)},
        "stamped_ms": (stamps[-1] - stamps[0]) / 1e6,
    }
