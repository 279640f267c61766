"""The tour's labels by a ruling set: the kernel's own code
(``csrc/ruling_walk.cuh`` ``label_count`` and ``label_walk``, built by g++
through ``csrc/ruling_walk_host.cpp`` as one thread with the grid barrier a
no-op) against ``jump_labels_plain`` at ``log2_ceil(E) + 1`` rounds, bit for
bit in label and on_cycle: on the eight cases of ``test_torch_label_kernel.py``
and on cases made for the ruling set (a long cycle of ids the hash never
samples, many 2-cycles and self-loops, every element a lone path end, a path
of more than 1,000 hops in one sublist, invalid edges inside cycles), at two
ruler densities; ``eulerian_tour`` with that host build in the label call's
place against the reference's tour, field by field; the wrapper's dispatch
and refusals. Inputs are made with numpy from a seed.

JAX and the reference are imported inside fixtures, so the file's card test
runs where JAX is absent:

    python -m pytest --confcutdir=tests/torch_port tests/torch_port/test_torch_ruling_labels.py -m cuda
"""

import ctypes

import numpy as np
import pytest
import torch
from test_torch_label_kernel import label_inputs, same_labels, tour_graphs  # noqa: F401 (a fixture)

from tpu_euler_torch import _build, trace
from tpu_euler_torch.euler import ranking_kernel
from tpu_euler_torch.euler.tour import eulerian_tour

VP, LL, ULL = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_ulonglong
OLD_CASES = [("cycles", 300), ("paths", 300), ("mix", 257), ("invalid", 257),
             ("loop", 1), ("end", 1), ("pair_cycle", 2), ("pair_path", 2)]
NEW_CASES = [("ruler_free_cycle", 4096), ("short_cycles", 3001), ("lone_ends", 1000), ("long_path", 2048),
             ("invalid_in_cycles", 1500), ("all", 5000)]
STRIDES = pytest.mark.parametrize("stride", [4, 32])


def unsampled(E: int, stride: int | None = None) -> np.ndarray:
    """The ids below E that the kernel's hash does not sample as rulers (at
    1 in ``stride``, the wrapper's stride for E where None)."""
    ids = torch.arange(E)
    return ids[~ranking_kernel.label_sampled(ids, stride or ranking_kernel.label_stride(E))].numpy()


def ruling_inputs(kind: str, E: int, seed: int = 0):
    """(succ [E] int64, -1 for none; valid [E] bool), injective. The cases of
    ``label_inputs``, and: ``ruler_free_cycle``, one cycle through every id
    the default hash leaves unsampled, in increasing order, the sampled ids
    lone ends; ``short_cycles``, the ids shuffled into 2-cycles and
    self-loops; ``lone_ends``, no successor anywhere; ``long_path``, a path
    from id 0 through every unsampled id, then lone ends; ``invalid_in_cycles``,
    a random permutation with a third of the elements invalid; ``all``, a
    ruler-free cycle, a long path, short cycles and paths of random ids
    together, a fifth invalid."""
    if kind in dict(OLD_CASES):
        return label_inputs(kind, E, seed)
    rng = np.random.default_rng(seed)
    succ = np.full(E, -1, dtype=np.int64)
    valid = np.ones(E, dtype=bool)

    def cycle(ids):
        succ[ids] = np.roll(ids, -1)

    def path(ids):
        succ[ids[:-1]] = ids[1:]

    if kind == "ruler_free_cycle":
        cycle(unsampled(E))
    elif kind == "short_cycles":
        ids = rng.permutation(E)
        cut = np.sort(rng.choice(np.arange(1, E), size=E // 3, replace=False))
        for run in np.split(ids, cut):
            for j in range(0, run.size, 2):
                cycle(run[j : j + 2])
    elif kind == "long_path":
        free = unsampled(E)
        path(np.concatenate([[0], free[free != 0]]))
    elif kind == "invalid_in_cycles":
        cycle_ids = rng.permutation(E)
        for run in np.split(cycle_ids, np.sort(rng.choice(np.arange(1, E), size=20, replace=False))):
            cycle(run)
        valid = rng.random(E) >= 1 / 3
    elif kind == "all":
        free = rng.permutation(unsampled(E))
        cycle(np.sort(free[:1500]))
        path(free[1500:2700])
        rest = rng.permutation(np.setdiff1d(np.arange(E), free[:2700]))
        for j, run in enumerate(np.split(rest, np.sort(rng.choice(np.arange(1, rest.size), size=400, replace=False)))):
            (cycle if j % 2 else path)(run)
        valid = rng.random(E) >= 0.2
    else:
        assert kind == "lone_ends"
    taken = succ[succ >= 0]
    assert taken.size == np.unique(taken).size  # injective
    return succ, valid


@pytest.fixture(scope="module")
def host():
    lib = _build.load_cpp(
        "ruling_walk_host", _build.CSRC / "ruling_walk_host.cpp", headers=(_build.CSRC / "ruling_walk.cuh",)
    )
    lib.ruling_labels_count_host.argtypes = [VP] * 3 + [LL, ULL]
    lib.ruling_labels_walk_host.argtypes = [VP] * 9 + [LL, ULL]
    lib.ruling_labels_count_host.restype = lib.ruling_labels_walk_host.restype = ctypes.c_int
    return lib


def host_ruling_labels(lib, stride: int | None = None, stats: list | None = None):
    """The host build with ``ranking_kernel.ruling_labels``' contract (the
    count, the read of the ruler count, the labels), sampling 1 in
    ``stride`` ids; every output, buffer and stats word starts as garbage,
    so a word it fails to write shows. Each call's ``label_stats`` goes to
    ``stats``."""

    def ruling_labels(succ, valid, rounds=None):
        E = succ.shape[0]
        ranking_kernel._check_labels(succ, valid, ranking_kernel._full_rounds(E, rounds))
        label = torch.full_like(succ, -7)
        on_cycle = torch.empty_like(valid)
        on_cycle.view(torch.uint8).fill_(7)
        words = torch.full((ranking_kernel._LABEL_STATS,), -7, dtype=torch.int64)
        bits = torch.full(((E + 31) // 32,), -7, dtype=torch.int32)
        below = (1 << 32) // (stride or ranking_kernel.label_stride(E))
        assert lib.ruling_labels_count_host(succ.data_ptr(), bits.data_ptr(), words.data_ptr(), E, below) == 0
        rulers, bad = words[:2].tolist()
        if bad:
            raise ValueError("succ repeats a successor or points past its end")
        owner = torch.full((E,), -7, dtype=torch.int32)
        rows = torch.full((2, max(rulers, 1), 2), -7, dtype=torch.int32)
        assert lib.ruling_labels_walk_host(
            succ.data_ptr(), valid.data_ptr(), label.data_ptr(), on_cycle.data_ptr(), bits.data_ptr(),
            owner.data_ptr(), rows[0].data_ptr(), rows[1].data_ptr(), words.data_ptr(), E, below,
        ) == 0
        if stats is not None:
            stats.append(ranking_kernel.label_stats(words))
        return label, on_cycle

    return ruling_labels


def full_plain(succ, valid):
    return ranking_kernel.jump_labels_plain(succ, valid, ranking_kernel.full_label_rounds(succ.shape[0]))


def expected_rulers(succ: np.ndarray, stride: int | None) -> int:
    """Path heads (a successor, no predecessor) and the elements with a
    predecessor that the hash samples (at the wrapper's stride where None)."""
    has_pred = np.zeros(succ.size, dtype=bool)
    has_pred[succ[succ >= 0]] = True
    sampled = ranking_kernel.label_sampled(torch.arange(succ.size), stride or ranking_kernel.label_stride(succ.size))
    sampled = sampled.numpy()
    return int(np.where(has_pred, sampled, succ >= 0).sum())


@STRIDES
@pytest.mark.parametrize("kind,E", OLD_CASES + NEW_CASES)
def test_host_build_equals_full_doubling(host, kind, E, stride):
    """The kernel's code against ``jump_labels_plain`` at log2_ceil(E) + 1
    rounds, bit for bit; the inputs are left as they are; its counts are
    the input's (rulers, uncovered elements, the longest sublist)."""
    succ_np, valid_np = ruling_inputs(kind, E, seed=E + stride)
    succ, valid = torch.from_numpy(succ_np), torch.from_numpy(valid_np)
    kept = succ.clone(), valid.clone()
    stats = []
    got = host_ruling_labels(host, stride, stats)(succ, valid)
    assert same_labels(got, full_plain(succ, valid))
    assert torch.equal(succ, kept[0]) and torch.equal(valid, kept[1])
    st = stats[0]
    assert st["rulers"] == expected_rulers(succ_np, stride)
    assert st["row_rounds"] == (ranking_kernel.full_label_rounds(st["rulers"]) if st["rulers"] else 0)
    assert 1 <= st["longest_sublist"] <= E - st["uncovered"] or st["rulers"] == 0
    assert set(st["phase_ms"]) == set(ranking_kernel._LABEL_PHASES)


def test_ruler_free_cycle_is_resolved_in_place(host):
    """A cycle of 3,968 ids that the hash never samples: no walk covers it,
    so every one of its elements goes through the uncovered doubling, and
    the labels are still the cycle's minimum. The sampled ids are lone
    elements, which take no ruler."""
    E = 4096
    succ_np, valid_np = ruling_inputs("ruler_free_cycle", E)
    succ, valid = torch.from_numpy(succ_np), torch.from_numpy(valid_np)
    stats = []
    label, on_cycle = host_ruling_labels(host, stats=stats)(succ, valid)
    cyc = unsampled(E)
    assert stats[0]["uncovered"] == cyc.size > 3000 and stats[0]["rulers"] == 0  # the rest are lone elements
    assert stats[0]["uncovered_rounds"] == ranking_kernel.full_label_rounds(cyc.size)
    assert (label.numpy()[cyc] == cyc.min()).all() and on_cycle.numpy()[cyc].all()
    assert same_labels((label, on_cycle), full_plain(succ, valid))


def test_long_path_is_one_sublist(host):
    """A path from id 0 through every unsampled id: one ruler (its head)
    walks all of it, more than 1,000 hops, and every edge reads E + the
    path's last id."""
    E = 2048
    succ_np, _ = ruling_inputs("long_path", E)
    succ, valid = torch.from_numpy(succ_np), torch.ones(E, dtype=torch.bool)
    stats = []
    label, on_cycle = host_ruling_labels(host, stats=stats)(succ, valid)
    n_path = 1 + int((succ_np >= 0).sum())
    assert stats[0]["longest_sublist"] == n_path > 1000 and stats[0]["uncovered"] == 0
    last = unsampled(E)[-1]
    on_path = np.flatnonzero((succ_np >= 0) | np.isin(np.arange(E), succ_np))
    assert (label.numpy()[on_path] == E + last).all() and not on_cycle.any()
    assert same_labels((label, on_cycle), full_plain(succ, valid))


def test_label_stride_keeps_about_2_20_rulers(monkeypatch):
    """The wrapper's stride: the power of two at or above E / 2^20, from 8
    to 64, unless ``LABEL_RULER_STRIDE`` sets it."""
    got = {E: ranking_kernel.label_stride(E) for E in (1, 4096, 8 << 20, (8 << 20) + 1, 9_961_472, 212_336_640, 1 << 30)}
    assert got == {1: 8, 4096: 8, 8 << 20: 8, (8 << 20) + 1: 16, 9_961_472: 16, 212_336_640: 64, 1 << 30: 64}
    monkeypatch.setattr(ranking_kernel, "LABEL_RULER_STRIDE", 4)
    assert ranking_kernel.label_stride(9_961_472) == 4


def test_host_count_flags_bad_successors(host):
    """The count launch flags a repeated successor (two predecessors) or
    one past the end, which the walk could not stop on; the wrapper raises
    before the labels launch."""
    for bad in ([1, 1, -1], [3, -1, -1]):
        succ = torch.tensor(bad, dtype=torch.int64)
        with pytest.raises(ValueError, match="repeats a successor"):
            host_ruling_labels(host)(succ, torch.ones(3, dtype=torch.bool))


@pytest.mark.parametrize("name", ["linear_k21", "circular_k31", "path_cover", "tangent_circuits", "shared_hubs"])
def test_tour_through_host_build_equals_reference(host, tour_graphs, monkeypatch, name):  # noqa: F811
    """``eulerian_tour`` with the host build of the ruling label kernels in
    ``ruling_labels``' place (every merge round's labels and the cut's)
    against the reference's tour, field by field."""
    from tpu_euler.euler import tour as jax_tour
    from tpu_euler_torch import convert

    ref_g, g = tour_graphs[name]
    stats = []
    monkeypatch.setattr(ranking_kernel, "ruling_labels", host_ruling_labels(host, stats=stats))
    got, ref = eulerian_tour(g), jax_tour.eulerian_tour(ref_g)
    r, t = convert.records_to_numpy(ref), convert.records_to_numpy(got)
    for field in ("succ", "chain", "pos", "length", "in_tour"):
        np.testing.assert_array_equal(t[field], r[field], err_msg=field)
    assert got.n_chains == int(ref.n_chains) and got.merge_rounds == int(ref.merge_rounds)
    assert len(stats) == got.merge_rounds + 1  # a merge round's labels, and the cut's


def test_cpu_tensors_never_load_the_cuda_library(monkeypatch):
    """``ruling_labels`` on CPU tensors runs ``jump_labels_plain`` at the
    given rounds (full by default): ``_build.load`` raising, no launch
    counted, no stats kept."""

    def refuse(*a, **k):
        raise AssertionError("the CUDA library was loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load", refuse)
    before = (trace.totals(), ranking_kernel.last_label_stats)
    succ, valid = (torch.from_numpy(x) for x in ruling_inputs("all", 5000))
    full = ranking_kernel.full_label_rounds(5000)
    for rounds in (None, full, full + 3):
        assert same_labels(ranking_kernel.ruling_labels(succ, valid, rounds), full_plain(succ, valid))
    assert same_labels(ranking_kernel.ruling_labels_plain(succ, valid), full_plain(succ, valid))
    assert (trace.since(before[0])["ruling_label_calls"], ranking_kernel.last_label_stats) == (0, before[1])


def test_wrapper_refuses_rounds_below_full():
    """Below log2_ceil(E) + 1 rounds the doubling has not converged, which
    the ruling set does not compute: the wrapper and its plain version
    raise, on the CPU and on any other device."""
    succ, valid = (torch.from_numpy(x) for x in ruling_inputs("mix", 257))
    full = ranking_kernel.full_label_rounds(257)
    assert full == 10
    for fn in (ranking_kernel.ruling_labels, ranking_kernel.ruling_labels_plain):
        for rounds in (0, 1, full - 1):
            with pytest.raises(ValueError, match="rounds or more"):
                fn(succ, valid, rounds)
    meta = torch.empty(257, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="rounds or more"):
        ranking_kernel.ruling_labels(meta, torch.empty(257, dtype=torch.bool, device="meta"), full - 1)


def test_wrapper_refuses_2_31_elements_and_other_devices():
    """E >= 2^31 raises off the CPU (the ids are 32-bit), before any
    allocation; a device other than the CPU and CUDA raises."""
    big = torch.empty(1 << 31, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="32-bit"):
        ranking_kernel.ruling_labels(big, torch.empty(1 << 31, dtype=torch.bool, device="meta"))
    meta = torch.empty(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ranking_kernel.ruling_labels(meta, torch.empty(4, dtype=torch.bool, device="meta"))


def test_wrapper_refuses_bad_inputs():
    x = torch.zeros(4, dtype=torch.int64)
    ok = torch.ones(4, dtype=torch.bool)
    with pytest.raises(TypeError):
        ranking_kernel.ruling_labels(x.int(), ok)
    for bad in (ok.long(), ok[:3], torch.ones(8, dtype=torch.bool)[::2]):
        with pytest.raises(ValueError, match="valid"):
            ranking_kernel.ruling_labels(x, bad)


def test_plain_route_and_held_rounds_take_the_ruling_labels(monkeypatch):
    """``microbench.plain_route`` puts ``ruling_labels_plain`` in the
    wrapper's place and gives the wrapper back; ``held_rounds`` holds each
    call against ``jump_labels_plain`` and raises on a wrapper that differs."""
    from tpu_euler_torch import microbench

    succ, valid = (torch.from_numpy(x) for x in ruling_inputs("all", 5000))
    wrapper = ranking_kernel.ruling_labels
    with microbench.plain_route():
        assert ranking_kernel.ruling_labels is ranking_kernel.ruling_labels_plain
    assert ranking_kernel.ruling_labels is wrapper
    with microbench.held_rounds() as held:
        ranking_kernel.ruling_labels(succ, valid, ranking_kernel.full_label_rounds(5000))
    assert held["labels"] == 1 and ranking_kernel.ruling_labels is wrapper

    def off_by_one(succ, valid, rounds=None):
        label, on_cycle = wrapper(succ, valid, rounds)
        return label + 1, on_cycle

    monkeypatch.setattr(ranking_kernel, "ruling_labels", off_by_one)
    with pytest.raises(microbench.MismatchError, match="ruling_labels"):
        with microbench.held_rounds():
            ranking_kernel.ruling_labels(succ, valid, ranking_kernel.full_label_rounds(5000))
    assert ranking_kernel.ruling_labels is off_by_one


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,E", OLD_CASES + NEW_CASES)
def test_ruling_labels_match_plain_on_card(card, kind, E):
    """The ruling label kernels against ``jump_labels_plain`` at full rounds
    on the card, bit for bit, at the default sample and at 1 in 4, one
    counted call each; the stats are the input's."""
    succ_np, valid_np = ruling_inputs(kind, E, seed=E + 2)
    succ, valid = torch.from_numpy(succ_np).to(card), torch.from_numpy(valid_np).to(card)
    want = full_plain(succ, valid)
    before = trace.totals()
    saved = ranking_kernel.LABEL_RULER_STRIDE
    try:
        for stride in (saved, 4):
            ranking_kernel.LABEL_RULER_STRIDE = stride
            assert same_labels(ranking_kernel.ruling_labels(succ, valid), want), stride
            st = ranking_kernel.label_stats()
            assert st["rulers"] == expected_rulers(succ_np, stride)
            assert all(ms >= 0 for ms in st["phase_ms"].values())
    finally:
        ranking_kernel.LABEL_RULER_STRIDE = saved
    assert trace.since(before)["ruling_label_calls"] == 2


@pytest.mark.cuda
def test_ruling_labels_refuse_bad_successors_on_card(card):
    for bad in ([1, 1, -1], [3, -1, -1]):
        succ = torch.tensor(bad, dtype=torch.int64, device=card)
        with pytest.raises(ValueError, match="repeats a successor"):
            ranking_kernel.ruling_labels(succ, torch.ones(3, dtype=torch.bool, device=card))
