"""The walk and pointer-jump kernels' logic on the CPU: ``csrc/ruling_walk.cuh``
built by g++ into a host library (``csrc/ruling_walk_host.cpp``: the walk's
per-slot function over every slot, with the minimum on the (succ2, t) record;
the doubling's pack, rounds and unpack with the grid barrier a no-op; the cut
tables' fold and unpack), held bit for bit against the plain versions round
by round and, in place of them, against the reference's ranking; the walk's record; the wrappers' dispatch
and checks; ``_build.load_cpp`` hashing the headers it is given."""

import ctypes
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_euler.euler import ranking as jax_ranking
from tpu_euler.euler import unitigs as jax_unitigs
from tpu_euler_torch import _build, convert, trace
from tpu_euler_torch.euler import ranking, ranking_kernel, unitigs
from tpu_euler_torch.simulate import FUNCTIONAL_GRAPHS, functional_graph_inputs

VP, LL, INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
HOST_ARGS = {
    "ruling_walk_round_host": [VP] * 2 + [LL] + [VP] * 7 + [LL, INT],
    "pointer_jump_min_host": [VP] * 6 + [LL, INT],
    "pointer_jump_rank_host": [VP] * 8 + [LL, INT],
    "ruling_cut_tables_host": [VP] * 4 + [LL] * 2,
}
CASES = pytest.mark.parametrize("seed,E,n_paths,n_cycles,max_len,tbits", FUNCTIONAL_GRAPHS)


@pytest.fixture(scope="module")
def host():
    lib = _build.load_cpp(
        "ruling_walk_host", _build.CSRC / "ruling_walk_host.cpp", headers=(_build.CSRC / "ruling_walk.cuh",)
    )
    for name, args in HOST_ARGS.items():
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = None if name == "ruling_walk_round_host" else ctypes.c_int
    return lib


def _ptr(x):
    return None if x is None else x.data_ptr()


def host_walk_round(lib):
    """The host build with ``ranking_kernel.walk_round``'s contract."""

    def walk_round(succ2, t, frontier, base, owner_off, walk_cap, tabs):
        ranking_kernel._check_walk(succ2, t, frontier, base, owner_off, walk_cap, tabs)
        ranking_kernel._check_record(succ2, t)
        cont = torch.empty_like(frontier)
        lib.ruling_walk_round_host(
            succ2.data_ptr(), frontier.data_ptr(), frontier.shape[0], owner_off.data_ptr(),
            *(tabs[n].data_ptr() for n in ranking_kernel._TABLES), _ptr(tabs.get("mmin")), cont.data_ptr(),
            base, walk_cap,
        )
        capped = cont[cont >= 0]
        return capped, capped.numel()

    return walk_round


def host_jump(lib, kind: str):
    """The host build with ``ranking_kernel.jump_min`` / ``jump_rank``'s
    contract."""
    fn, words = (lib.pointer_jump_min_host, 2) if kind == "min" else (lib.pointer_jump_rank_host, 4)

    def jump(*state_and_rounds):
        *state, rounds = state_and_rounds
        if rounds == 0:
            return tuple(state)
        n = state[0].shape[0]
        outs = tuple(torch.full_like(x, -7) for x in state)
        bufs = torch.full((2, n, words), -7, dtype=torch.int64)
        assert fn(*(x.data_ptr() for x in (*state, *outs)), bufs[0].data_ptr(), bufs[1].data_ptr(), n, rounds) == 0
        return outs

    return jump


def host_cut_tables(lib):
    """The host build with ``ranking_kernel.cut_tables``' contract."""

    def cut_tables(is_cut, owner_off, S):
        ranking_kernel._check_cut(is_cut, owner_off, S)
        m1, cut_edge = torch.full((S,), -7, dtype=torch.int64), torch.full((S,), -7, dtype=torch.int64)
        assert lib.ruling_cut_tables_host(is_cut.data_ptr(), owner_off.data_ptr(), m1.data_ptr(), cut_edge.data_ptr(),
                                          is_cut.shape[0], S) == 0
        return m1, cut_edge

    return cut_tables


def _inputs(case):
    succ, valid, t = functional_graph_inputs(*case)
    return torch.from_numpy(succ), torch.from_numpy(valid), convert.tkeys_from_limbs(t, "cpu"), (succ, valid, t)


def _clone(tabs):
    return {k: v.clone() for k, v in tabs.items()}


@CASES
@pytest.mark.parametrize("track_min", [True, False], ids=["track_min", "no_min"])
def test_walk_rounds_host_build_equal_plain(host, monkeypatch, track_min, seed, E, n_paths, n_cycles, max_len, tbits):
    """Every round of a walk, from the same state, through the host build
    (with the minimum, succ2 and t in the walk's record) and the plain
    version: owner words, succ2 after the patch, the tables, the
    continuations and their count."""
    succ, valid, t, _ = _inputs((seed, E, n_paths, n_cycles, max_len, tbits))
    host_round = host_walk_round(host)
    rounds = []

    def held(succ2, t, frontier, base, owner_off, walk_cap, tabs):
        assert ranking_kernel.interleaved(succ2, t) == track_min
        s2, oo, tb = succ2.clone(), owner_off.clone(), _clone(tabs)
        got = host_round(succ2, t, frontier, base, owner_off, walk_cap, tabs)
        t_plain = None if t is None else t.contiguous()  # the record's t, as an array beside the copy of succ2
        want = ranking_kernel.walk_round_plain(s2, t_plain, frontier, base, oo, walk_cap, tb)
        n_el = succ2.shape[0] - 1
        assert torch.equal(owner_off[:n_el], oo[:n_el]) and torch.equal(succ2, s2)
        assert tabs.keys() == tb.keys() and all(torch.equal(tabs[k], tb[k]) for k in tabs)
        assert got[1] == want[1] and torch.equal(got[0], want[0])
        rounds.append(got[1])
        return got

    monkeypatch.setattr(ranking_kernel, "walk_round", held)
    owner_off, tabs = ranking._run_walk(succ, valid, t if track_min else None, track_min, with_self=track_min)
    assert owner_off is not None and ("mmin" in tabs) == track_min
    assert rounds[-1] == 0 and len(rounds) >= 1
    if max_len > ranking.WALK_CAP:
        assert len(rounds) > 1  # continuations were walked


@CASES
@pytest.mark.parametrize("rounds", ["none", "one", "full"])
def test_jump_rounds_host_build_equal_plain(host, rounds, seed, E, n_paths, n_cycles, max_len, tbits):
    """Both doublings through the host build (pack, rounds, unpack) against
    as many plain rounds, on the graph's successors (paths, cycles,
    self-loops): no round, one, and log2_ceil(E) + 1 (the fixed point)."""
    succ, _, t, _ = _inputs((seed, E, n_paths, n_cycles, max_len, tbits))
    d0 = torch.from_numpy(np.random.default_rng(seed).integers(0, 5, E))
    q0 = torch.where(succ >= 0, succ, torch.arange(E))
    n_rounds = {"none": 0, "one": 1, "full": ranking._log2_ceil(E) + 1}[rounds]
    for kind, state, plain in (("min", (succ, t), ranking_kernel.jump_min_plain),
                               ("rank", (succ, d0, q0), ranking_kernel.jump_rank_plain)):
        kept = tuple(x.clone() for x in state)
        got = host_jump(host, kind)(*state, n_rounds)
        want = plain(*state, n_rounds)
        assert len(got) == len(state) and all(torch.equal(x, y) for x, y in zip(got, want)), kind
        assert all(torch.equal(x, y) for x, y in zip(state, kept)), kind  # the inputs are left as they are


def test_jump_records_pack_and_unpack(host):
    """One round over elements that all end (p < 0) is the records' round
    trip: the state comes back as it went in, p as -1, each word in its
    place, in both record layouts."""
    rng = np.random.default_rng(5)
    p = torch.from_numpy(-1 - rng.integers(0, 3, 37))
    words = [torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, 37)) for _ in range(2)]
    m_out = host_jump(host, "min")(p, words[0], 1)
    assert m_out[0].tolist() == [-1] * 37 and torch.equal(m_out[1], words[0])
    r_out = host_jump(host, "rank")(p, *words, 1)
    assert r_out[0].tolist() == [-1] * 37 and torch.equal(r_out[1], words[0]) and torch.equal(r_out[2], words[1])


@CASES
def test_walk_record_holds_succ2_and_t(seed, E, n_paths, n_cycles, max_len, tbits):
    """The cycle walk's record: word 0 is succ2 (with its spare slot), word
    1 is t, and the two views are ``interleaved``; the rank walk keeps
    succ2 as one array. Both start from the same rulers, owners all -1."""
    succ, valid, t, _ = _inputs((seed, E, n_paths, n_cycles, max_len, tbits))
    is_ruler = ranking._pick_rulers(succ, valid, True)
    want = torch.cat([ranking._build_succ2(succ, is_ruler), torch.zeros(1, dtype=torch.int64)])
    succ2, t_walk, owner_off, frontier = ranking._walk_start(succ, valid, t, True)
    assert torch.equal(succ2, want) and torch.equal(t_walk, t) and ranking_kernel.interleaved(succ2, t_walk)
    plain, none, owner2, frontier2 = ranking._walk_start(succ, valid, None, True)
    assert none is None and plain.is_contiguous() and torch.equal(plain, want)
    assert torch.equal(frontier, frontier2) and torch.equal(frontier, ranking._compact(is_ruler, frontier.shape[0]))
    assert torch.equal(owner_off, torch.full((E + 1,), -1)) and torch.equal(owner2, owner_off)


def _layout(name):
    """(succ2, t) over E = 4 elements in one of several layouts."""
    rec = torch.zeros((5, 2), dtype=torch.int64)
    if name == "record":
        return rec[:, 0], rec[:4, 1]
    if name == "arrays":
        return torch.zeros(5, dtype=torch.int64), torch.zeros(4, dtype=torch.int64)
    if name == "words_swapped":
        return rec[:, 1], rec[1:, 0]
    if name == "two_records":
        return rec[:, 0], torch.zeros((4, 2), dtype=torch.int64)[:, 1]
    flat = torch.zeros(12, dtype=torch.int64)[1:11].view(5, 2)  # one word past 16-byte alignment
    return flat[:, 0], flat[:4, 1]


@pytest.mark.parametrize("layout", ["record", "arrays", "words_swapped", "two_records", "misaligned"])
def test_walk_launch_takes_the_minimum_only_from_the_record(monkeypatch, layout):
    """The kernel reads succ2 and t as one record: ``walk_launch`` refuses
    any other layout before it loads the library; the record passes."""

    def refuse(*a, **k):
        raise AssertionError("the CUDA library was loaded")

    monkeypatch.setattr(_build, "load", refuse)
    succ2, t = _layout(layout)
    assert ranking_kernel.interleaved(succ2, t) == (layout == "record")
    if layout == "record":
        ranking_kernel._check_record(succ2, t)
        ranking_kernel._check_record(torch.zeros(5, dtype=torch.int64), None)  # no minimum: any succ2
        return
    tabs = {n: torch.zeros(8, dtype=torch.int64) for n in (*ranking_kernel._TABLES, "mmin")}
    with pytest.raises(ValueError, match="one \\[E \\+ 1, 2\\] int64 record"):
        ranking_kernel.walk_launch(succ2, t, torch.full((8,), -1), 0, torch.full((5,), -1), 128, tabs)


@pytest.fixture
def host_route(host, monkeypatch):
    """The host build in place of every kernel wrapper."""
    monkeypatch.setattr(ranking_kernel, "walk_round", host_walk_round(host))
    monkeypatch.setattr(ranking_kernel, "jump_min", host_jump(host, "min"))
    monkeypatch.setattr(ranking_kernel, "jump_rank", host_jump(host, "rank"))
    monkeypatch.setattr(ranking_kernel, "cut_tables", host_cut_tables(host))


@CASES
def test_host_build_tables_equal_reference(host_route, seed, E, n_paths, n_cycles, max_len, tbits):
    """With the host build in place of the kernels, the cycle walk (the
    minimum tracked), the cut list's rank from its tables, and the rank walk
    (no minimum) equal the reference's, as test_torch_chains holds the plain
    versions."""
    ps, pv, pt, (succ, valid, t) = _inputs((seed, E, n_paths, n_cycles, max_len, tbits))
    js, jv, jt = jnp.asarray(succ.astype(np.int32)), jnp.asarray(valid), jnp.asarray(t)
    ref = jax_ranking.cycle_min_ruling_tables(js, jv, jt)
    got = ranking.cycle_min_ruling_tables(ps, pv, pt)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    assert torch.equal(got[1], convert.tkeys_from_limbs(ref[1], "cpu"))
    ref_cut, ref_is_cut = jax_unitigs._apply_cut(js, jt, ref[0], ref[1])
    cut, is_cut = unitigs._apply_cut(ps, pt, got[0], got[1])
    np.testing.assert_array_equal(cut.numpy(), np.asarray(ref_cut))
    pairs = (
        (ranking.rank_chains_with_cut(cut, pv, is_cut, *got[2:]), jax_ranking.rank_chains_with_cut(ref_cut, jv, ref_is_cut, *ref[2:])),
        (ranking.rank_chains_ruling(cut, pv), jax_ranking.rank_chains_ruling(ref_cut, jv)),
    )
    for a, b in pairs:
        assert a is not None and b is not None
        np.testing.assert_array_equal(a[0].numpy()[valid], np.asarray(b[0])[valid])
        np.testing.assert_array_equal(a[1].numpy()[valid], np.asarray(b[1])[valid])


@CASES
def test_host_build_doublings_equal_reference(host_route, seed, E, n_paths, n_cycles, max_len, tbits):
    """With the host build's jump rounds: ``cut_cycles_from_t`` and
    ``wyllie_rank`` against the reference's, and ``_contracted_rank`` and
    ``_contracted_cycle_min`` against the reference's on the graph taken as
    a contracted list (its cycles included)."""
    ps, pv, pt, (succ, valid, t) = _inputs((seed, E, n_paths, n_cycles, max_len, tbits))
    js, jv, jt = jnp.asarray(succ.astype(np.int32)), jnp.asarray(valid), jnp.asarray(t)
    cut, on_cycle = unitigs.cut_cycles_from_t(pt, pv, ps)
    ref_cut, ref_on_cycle = jax_unitigs.cut_cycles_from_t(jt, jv, js, 31)
    np.testing.assert_array_equal(cut.numpy(), np.asarray(ref_cut))
    np.testing.assert_array_equal(on_cycle.numpy(), np.asarray(ref_on_cycle))
    rounds = unitigs._log2_ceil(E) + 1
    d, q = unitigs.wyllie_rank(cut, rounds)
    ref_d, ref_q = jax_unitigs.wyllie_rank(ref_cut, rounds)
    np.testing.assert_array_equal(d.numpy(), np.asarray(ref_d))
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))

    hops = torch.from_numpy(np.random.default_rng(seed + 10).integers(0, 128, E))
    end_e = torch.from_numpy(np.random.default_rng(seed + 11).integers(-1, E, E))
    D, chain_end, has_cycle = ranking._contracted_rank(ps, hops, end_e)
    ref = jax_ranking._contracted_rank(js, jnp.asarray(hops.numpy().astype(np.int32)), jnp.asarray(end_e.numpy().astype(np.int32)))
    np.testing.assert_array_equal(D.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(chain_end.numpy(), np.asarray(ref[1]))
    assert bool(has_cycle) == bool(ref[2])
    on, cmin = ranking._contracted_cycle_min(ps, pt)
    ref_on, ref_min = jax_ranking._contracted_cycle_min(js, jt)
    np.testing.assert_array_equal(on.numpy(), np.asarray(ref_on))
    assert torch.equal(cmin, convert.tkeys_from_limbs(ref_min, "cpu"))


def test_jump_keeps_its_inputs_and_ping_pongs():
    p = torch.tensor([1, 2, -1, 3])
    m = torch.tensor([5, 3, 9, 1])
    state = (p.clone(), m.clone())
    out = ranking_kernel.jump_min(*state, 3)
    assert torch.equal(state[0], p) and torch.equal(state[1], m)
    assert out[0].tolist() == [-1, -1, -1, 3] and out[1].tolist() == [3, 3, 9, 1]
    assert ranking_kernel.jump_min(p, m, 0) == (p, m)


def test_cpu_tensors_never_load_the_cuda_library(monkeypatch):
    """The plain versions serve CPU tensors: a chain computation on the
    CPU and both doublings called directly, with ``_build.load`` raising,
    and no launch or round counted."""

    def refuse(*a, **k):
        raise AssertionError("the CUDA library was loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load", refuse)
    before = trace.totals()
    ps, pv, pt, _ = _inputs(FUNCTIONAL_GRAPHS[1])
    chains = unitigs.chains_from_t(pt, pv, ps, min_edges=0)
    assert chains.chain.shape == ps.shape
    unitigs.wyllie_rank(ps, 4)
    got = ranking_kernel.jump_min(ps, pt, 3)
    assert all(torch.equal(x, y) for x, y in zip(got, ranking_kernel.jump_min_plain(ps, pt, 3)))
    got = ranking_kernel.jump_rank(ps, ps.clamp(min=0), ps.clamp(min=0), 3)
    assert all(torch.equal(x, y) for x, y in zip(got, ranking_kernel.jump_rank_plain(ps, ps.clamp(min=0), ps.clamp(min=0), 3)))
    grew = trace.since(before)
    assert (grew["walk_launches"], grew["jump_launches"], grew["jump_rounds"]) == (0, 0, 0)


def test_other_devices_raise():
    meta = lambda n: torch.empty(n, dtype=torch.int64, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ranking_kernel.jump_min(meta(4), meta(4), 3)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ranking_kernel.jump_rank(meta(4), meta(4), meta(4), 3)
    tabs = {n: meta(8) for n in ranking_kernel._TABLES}
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ranking_kernel.walk_round(meta(5), None, meta(8), 0, meta(5), 128, tabs)
    rec = torch.empty((5, 2), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ranking_kernel.walk_round(rec[:, 0], rec[:4, 1], meta(8), 0, meta(5), 128, {**tabs, "mmin": meta(8)})


def test_wrappers_refuse_bad_inputs():
    x = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(TypeError):
        ranking_kernel.jump_min(x.int(), x, 2)
    with pytest.raises(ValueError, match="one length"):
        ranking_kernel.jump_min(x, torch.zeros(3, dtype=torch.int64), 2)
    with pytest.raises(ValueError, match="one length"):
        ranking_kernel.jump_rank(x, x, torch.zeros(3, dtype=torch.int64), 2)
    with pytest.raises(ValueError, match="rounds"):
        ranking_kernel.jump_rank(x, x, x, -1)
    with pytest.raises(ValueError, match="contiguous"):
        ranking_kernel.jump_min(torch.zeros(8, dtype=torch.int64)[::2], x, 1)
    tabs = {n: torch.zeros(8, dtype=torch.int64) for n in ranking_kernel._TABLES}
    succ2, owner = torch.full((5,), -1), torch.full((5,), -1)
    with pytest.raises(ValueError, match="8 bits"):
        ranking_kernel.walk_round(succ2, None, torch.full((8,), -1), 0, owner, 256, tabs)
    with pytest.raises(ValueError, match="rows"):
        ranking_kernel.walk_round(succ2, None, torch.full((8,), -1), 4, owner, 128, tabs)
    with pytest.raises(ValueError, match="mmin"):
        ranking_kernel.walk_round(succ2, torch.zeros(4, dtype=torch.int64), torch.full((8,), -1), 0, owner, 128, tabs)
    # strided succ2 and t only as the two words of one record
    rec = torch.zeros((5, 2), dtype=torch.int64)
    tabs["mmin"] = torch.zeros(8, dtype=torch.int64)
    assert ranking_kernel.interleaved(rec[:, 0], rec[:4, 1])
    assert not ranking_kernel.interleaved(rec[:, 1], rec[1:, 0]) and not ranking_kernel.interleaved(rec[:, 0], None)
    with pytest.raises(ValueError, match="contiguous"):
        ranking_kernel.walk_round(rec[:, 1], rec[1:, 0], torch.full((8,), -1), 0, owner, 128, tabs)
    with pytest.raises(ValueError, match="contiguous"):
        ranking_kernel.walk_round(rec[:, 0], torch.zeros(4, dtype=torch.int64), torch.full((8,), -1), 0, owner, 128, tabs)


def test_load_cpp_hashes_its_headers(tmp_path, monkeypatch):
    """An edited header gives the library another name (so it is rebuilt);
    the unchanged pair is reused."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    src, hdr = tmp_path / "ruling_walk_host.cpp", tmp_path / "ruling_walk.cuh"
    shutil.copy(_build.CSRC / "ruling_walk_host.cpp", src)
    shutil.copy(_build.CSRC / "ruling_walk.cuh", hdr)
    original = hdr.read_text()
    paths = []
    try:
        for text in (original, original + "\n// edited\n", original):
            hdr.write_text(text)
            _build._loaded.pop("walk_header_test", None)
            _build.load_cpp("walk_header_test", src, headers=(hdr,))
            paths.append((_build.build_info["walk_header_test"]["path"], _build.build_info["walk_header_test"]["seconds"]))
    finally:
        _build._loaded.pop("walk_header_test", None)
    assert paths[0][0] != paths[1][0] and paths[2][0] == paths[0][0]
    assert paths[2][1] == 0.0  # reused, not rebuilt
