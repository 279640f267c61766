"""The tour's label doubling: ``ranking_kernel.jump_labels_plain`` against the
reference's ``tour._labels`` bit for bit; the kernel's own code
(``csrc/ruling_walk.cuh`` ``LabelRec``, built by g++
through ``csrc/ruling_walk_host.cpp``: the fused initial state, the rounds
with the grid barrier a no-op, the fused select) against the plain version;
``eulerian_tour`` with that host build in the wrapper's place against the
reference's tour, field by field (in the place of the tour's label call,
``ruling_labels``); the wrapper's dispatch and checks. Inputs
are made with numpy from a seed: pure cycles, pure paths, a mix, invalid
edges, E = 1 and 2, at no round, one, and log2_ceil(E) + 1.

JAX and the reference are imported inside fixtures, not at the top, so the
file's card test runs where JAX is absent:

    python -m pytest --confcutdir=tests/torch_port tests/torch_port/test_torch_label_kernel.py -m cuda
"""

import ctypes

import numpy as np
import pytest
import torch

from tpu_euler_torch import _build, trace
from tpu_euler_torch.euler import ranking_kernel
from tpu_euler_torch.euler.tour import eulerian_tour
from tpu_euler_torch.euler.unitigs import _log2_ceil

VP, LL, INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
ROUNDS = pytest.mark.parametrize("rounds", ["none", "one", "full"])
CASES = pytest.mark.parametrize(
    "kind,E",
    [("cycles", 300), ("paths", 300), ("mix", 257), ("invalid", 257),
     ("loop", 1), ("end", 1), ("pair_cycle", 2), ("pair_path", 2)],
)


def label_inputs(kind: str, E: int, seed: int = 0):
    """(succ [E] int64 with -1 for none, valid [E] bool) as numpy arrays.
    ``cycles``: a random permutation (every element on a cycle, self-loops
    included); ``paths``: the ids shuffled and cut into runs, each a path;
    ``mix``: half the ids in cycles, half in paths; ``invalid``: the mix
    with a quarter of the elements invalid; E = 1: a self-loop (``loop``) or
    a lone end (``end``); E = 2: one cycle or one path."""
    fixed = {"loop": [0], "end": [-1], "pair_cycle": [1, 0], "pair_path": [1, -1]}
    rng = np.random.default_rng(seed)
    valid = np.ones(E, dtype=bool)
    if kind in fixed:
        return np.array(fixed[kind], dtype=np.int64), valid
    succ = np.full(E, -1, dtype=np.int64)
    ids = rng.permutation(E)
    n_cyc = {"cycles": E, "paths": 0}.get(kind, E // 2)
    cyc, path = ids[:n_cyc], ids[n_cyc:]
    for part, closed in ((cyc, True), (path, False)):
        cuts = np.sort(rng.choice(np.arange(1, max(part.size, 2)), size=min(8, max(part.size - 1, 0)), replace=False))
        for run in np.split(part, cuts):
            if run.size:
                succ[run[:-1]] = run[1:]
                succ[run[-1]] = run[0] if closed else -1
    if kind == "invalid":
        valid = rng.random(E) >= 0.25
    return succ, valid


def n_rounds(name: str, E: int) -> int:
    return {"none": 0, "one": 1, "full": _log2_ceil(E) + 1}[name]


@pytest.fixture(scope="module")
def jax_tour():
    """The reference's tour module (JAX on the CPU)."""
    from tpu_euler.euler import tour

    return tour


@pytest.fixture(scope="module")
def host():
    lib = _build.load_cpp(
        "ruling_walk_host", _build.CSRC / "ruling_walk_host.cpp", headers=(_build.CSRC / "ruling_walk.cuh",)
    )
    lib.pointer_jump_labels_host.argtypes = [VP] * 6 + [LL, INT]
    lib.pointer_jump_labels_host.restype = ctypes.c_int
    return lib


def host_labels(lib, calls: list | None = None):
    """The host build with ``ranking_kernel.jump_labels``' contract; the
    outputs and buffers start as garbage, so a word it fails to write
    shows."""

    def jump_labels(succ, valid, rounds):
        assert succ.dtype == torch.int64 and valid.dtype == torch.bool and succ.is_contiguous() and valid.is_contiguous()
        E = succ.shape[0]
        label = torch.full_like(succ, -7)
        on_cycle = torch.empty_like(valid)
        on_cycle.view(torch.uint8).fill_(7)
        bufs = torch.full((2, E, 2), -7, dtype=torch.int64)
        assert lib.pointer_jump_labels_host(
            succ.data_ptr(), valid.data_ptr(), label.data_ptr(), on_cycle.data_ptr(), bufs[0].data_ptr(),
            bufs[1].data_ptr(), E, rounds,
        ) == 0
        if calls is not None:
            calls.append(rounds)
        return label, on_cycle

    return jump_labels


def same_labels(got, want) -> bool:
    """Labels equal and the on-cycle bytes equal byte for byte (0 or 1)."""
    return torch.equal(got[0], want[0]) and torch.equal(got[1].view(torch.uint8), want[1].view(torch.uint8))


@CASES
@ROUNDS
def test_plain_labels_equal_reference(jax_tour, kind, E, rounds):
    """``jump_labels_plain`` against the reference's ``_labels`` on the
    same successors (int32 with -1 for none there; the reference maps -1 to
    its uint32 sentinel itself): label and on_cycle bit for bit."""
    import jax.numpy as jnp

    succ, valid = label_inputs(kind, E, seed=E)
    r = n_rounds(rounds, E)
    ref_label, ref_on = jax_tour._labels(jnp.asarray(succ.astype(np.int32)), jnp.asarray(valid), r)
    label, on_cycle = ranking_kernel.jump_labels_plain(torch.from_numpy(succ), torch.from_numpy(valid), r)
    np.testing.assert_array_equal(label.numpy(), np.asarray(ref_label).astype(np.int64))
    np.testing.assert_array_equal(on_cycle.numpy(), np.asarray(ref_on))
    if rounds == "full":  # the fixed point: every element of a valid cycle is on it
        lone = valid & (succ < 0)
        assert not on_cycle.numpy()[lone].any() and on_cycle.numpy()[valid & (kind == "cycles")].all()


@CASES
@ROUNDS
def test_host_build_equals_plain(host, kind, E, rounds):
    """The kernel's code (pack with the initial state, rounds, fused select)
    against the plain version; the inputs are left as they are."""
    succ, valid = (torch.from_numpy(x) for x in label_inputs(kind, E, seed=E + 1))
    kept = succ.clone(), valid.clone()
    r = n_rounds(rounds, E)
    got = host_labels(host)(succ, valid, r)
    assert same_labels(got, ranking_kernel.jump_labels_plain(succ, valid, r))
    assert torch.equal(succ, kept[0]) and torch.equal(valid, kept[1])


def test_host_build_long_path_and_cycle(host):
    """A path of E/2 edges and a cycle of E/2: the path's edges read E + its
    last edge (the packed word's low half), the cycle's its smallest id
    (the high half)."""
    E = 1 << 12
    succ = torch.arange(1, E + 1)
    succ[E // 2 - 1] = -1  # a path 0 .. E/2 - 1
    succ[-1] = E // 2  # a cycle E/2 .. E - 1
    valid = torch.ones(E, dtype=torch.bool)
    got = host_labels(host)(succ, valid, _log2_ceil(E) + 1)
    assert same_labels(got, ranking_kernel.jump_labels_plain(succ, valid, _log2_ceil(E) + 1))
    assert got[0][: E // 2].tolist() == [E + E // 2 - 1] * (E // 2) and got[0][E // 2 :].tolist() == [E // 2] * (E // 2)


@pytest.fixture(scope="module")
def tour_graphs():
    """(reference graph, port graph) of the graphs of test_torch_tour.py:
    a linear and a circular genome, one without Eulerian balance, many
    circuits through one hub, and circuits through shared hubs that the
    merge joins (two merge rounds, so the second label call sees spliced
    successors)."""
    from test_torch_tour import _balanced_hubs, graphs_from_reads

    from tpu_euler.reference_impl.simulate import random_genome, simulate_reads

    hub = random_genome(25, seed=41)
    tangent = "".join(hub + random_genome(40, seed=141 + i) for i in range(64))
    linear = random_genome(600, seed=31)
    return {
        "linear_k21": graphs_from_reads(simulate_reads(random_genome(800, seed=5), 100, 15, seed=25), 21),
        "circular_k31": graphs_from_reads(
            simulate_reads(random_genome(1500, seed=7), 100, 15, seed=27, circular=True), 31),
        "path_cover": graphs_from_reads(
            [linear[i : i + 60] for i in range(0, 541, 5)] + [linear[-60:]], 21, read_len=60),
        "tangent_circuits": graphs_from_reads(
            [(tangent * 2)[i : i + 80] for i in range(0, len(tangent), 7)], 21, read_len=80),
        "shared_hubs": graphs_from_reads(_balanced_hubs(6), 21, read_len=60),
    }


@pytest.mark.parametrize("name", ["linear_k21", "circular_k31", "path_cover", "tangent_circuits", "shared_hubs"])
def test_tour_through_host_build_equals_reference(jax_tour, host, tour_graphs, monkeypatch, name):
    """``eulerian_tour`` with the host build of the doubling label kernel in
    the place of the tour's label call, ``ruling_labels`` (every merge
    round's labels and the cut's, at the tour's rounds), against the
    reference's tour, field by field."""
    from tpu_euler_torch import convert

    ref_g, g = tour_graphs[name]
    calls = []
    monkeypatch.setattr(ranking_kernel, "ruling_labels", host_labels(host, calls))
    got, ref = eulerian_tour(g), jax_tour.eulerian_tour(ref_g)
    r, t = convert.records_to_numpy(ref), convert.records_to_numpy(got)
    for field in ("succ", "chain", "pos", "length", "in_tour"):
        np.testing.assert_array_equal(t[field], r[field], err_msg=field)
    assert got.n_chains == int(ref.n_chains) and got.merge_rounds == int(ref.merge_rounds)
    assert calls == [_log2_ceil(g.tail.shape[0]) + 1] * (got.merge_rounds + 1)  # a merge round's labels, and the cut's


def test_cpu_tensors_never_load_the_cuda_library(monkeypatch):
    """``jump_labels`` on CPU tensors, and a tour on the CPU, run the plain
    version: ``_build.load`` raising, no launch or round counted."""
    from tpu_euler_torch.config import AssemblyConfig
    from tpu_euler_torch.graph.build import build_graph
    from tpu_euler_torch.io.encode import encode_reads
    from tpu_euler_torch.pipeline.assemble import count_spectrum
    from tpu_euler_torch.simulate import random_genome, simulate_reads

    def refuse(*a, **k):
        raise AssertionError("the CUDA library was loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load", refuse)
    before = trace.totals()
    succ, valid = (torch.from_numpy(x) for x in label_inputs("invalid", 257))
    for r in (0, 1, 10):
        assert same_labels(ranking_kernel.jump_labels(succ, valid, r), ranking_kernel.jump_labels_plain(succ, valid, r))
    calls = []
    plain = ranking_kernel.jump_labels_plain
    monkeypatch.setattr(ranking_kernel, "jump_labels_plain", lambda *a: calls.append(a[2]) or plain(*a))
    reads = simulate_reads(random_genome(600, seed=3), 100, 10, seed=4, circular=True)
    cfg = AssemblyConfig(k=21, read_batch=64, read_len=100, spectrum_capacity=1 << 12)
    spec, _ = count_spectrum(encode_reads(reads, 100), cfg, "cpu")
    tour = eulerian_tour(build_graph(spec, 21))
    assert tour.n_chains == 2 and len(calls) == tour.merge_rounds + 1  # one circuit a strand
    grew = trace.since(before)
    assert (grew["label_launches"], grew["label_rounds"]) == (0, 0)


def test_plain_route_and_held_rounds_take_the_labels(monkeypatch):
    """``microbench.plain_route`` puts ``jump_labels_plain`` in the
    wrapper's place and gives the wrapper back; ``held_rounds`` holds each
    of a tour's label doublings and raises on a wrapper that differs."""
    from tpu_euler_torch import microbench

    succ, valid = (torch.from_numpy(x) for x in label_inputs("mix", 257))
    wrapper = ranking_kernel.jump_labels
    with microbench.plain_route():
        assert ranking_kernel.jump_labels is ranking_kernel.jump_labels_plain
    assert ranking_kernel.jump_labels is wrapper
    with microbench.held_rounds() as held:
        ranking_kernel.jump_labels(succ, valid, 3)
        ranking_kernel.jump_labels(succ, valid, 0)
    assert held["labels"] == 2 and ranking_kernel.jump_labels is wrapper

    def off_by_one(succ, valid, rounds):
        label, on_cycle = wrapper(succ, valid, rounds)
        return label + 1, on_cycle

    monkeypatch.setattr(ranking_kernel, "jump_labels", off_by_one)
    with pytest.raises(microbench.MismatchError, match="jump_labels"):
        with microbench.held_rounds():
            ranking_kernel.jump_labels(succ, valid, 3)
    assert ranking_kernel.jump_labels is off_by_one


def test_other_devices_raise():
    meta = torch.empty(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ranking_kernel.jump_labels(meta, torch.empty(4, dtype=torch.bool, device="meta"), 3)


def test_wrapper_refuses_bad_inputs():
    x = torch.zeros(4, dtype=torch.int64)
    ok = torch.ones(4, dtype=torch.bool)
    with pytest.raises(TypeError):
        ranking_kernel.jump_labels(x.int(), ok, 2)
    with pytest.raises(ValueError, match="rounds"):
        ranking_kernel.jump_labels(x, ok, -1)
    for bad in (ok.long(), ok[:3], torch.ones(8, dtype=torch.bool)[::2]):
        with pytest.raises(ValueError, match="valid"):
            ranking_kernel.jump_labels(x, bad, 2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@CASES
def test_label_kernel_matches_plain_on_card(card, kind, E):
    """The label kernel against its plain version on the card, bit for bit,
    at every round count from 0 to log2_ceil(E) + 1, one launch each."""
    succ, valid = (torch.from_numpy(x).to(card) for x in label_inputs(kind, E, seed=E + 2))
    before = trace.totals()
    top = _log2_ceil(E) + 2
    for r in range(top):
        assert same_labels(ranking_kernel.jump_labels(succ, valid, r), ranking_kernel.jump_labels_plain(succ, valid, r)), r
    torch.cuda.synchronize()
    assert trace.since(before)["label_launches"] == top
