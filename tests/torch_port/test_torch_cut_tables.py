"""The cut list's first-cut tables (``ranking_kernel.cut_tables``) on the CPU:
the plain version against a per-gid loop in Python, the kernel's logic
(``csrc/ruling_walk.cuh`` ``cut_lane`` / ``cut_unpack``, built by g++ through
``csrc/ruling_walk_host.cpp``) bit for bit against the plain version, and the
wrapper's dispatch, counters and checks."""

import numpy as np
import pytest
import torch

from tpu_euler_torch import _build, trace
from tpu_euler_torch.euler import ranking, ranking_kernel
from test_torch_walk_kernel import host, host_cut_tables  # noqa: F401  (host: the g++ build, a fixture)

NO_CUT = ranking_kernel.NO_CUT


def _owner_words(rng, E: int, S: int) -> np.ndarray:
    """gid << 8 | offset for every lane, a few lanes uncovered (-1)."""
    w = (rng.integers(0, S, E) << 8) | rng.integers(0, ranking.WALK_CAP, E)
    w[rng.random(E) < 0.1] = -1
    return w


def _case(name: str):
    """(is_cut [E] bool, owner_off [E] int64, S) of one named case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    E, S = 64, 8
    owner = _owner_words(rng, E, S)
    cut = np.zeros(E, dtype=bool)
    if name == "no_cut":
        pass
    elif name == "every_lane_dead":  # every flag set, no lane covered
        cut[:] = True
        owner[:] = -1
    elif name == "several_cuts_one_gid":  # offsets 9, 2, 5 on gid 3, and two edges at offset 2
        for e, off in ((4, 9), (20, 2), (33, 5), (50, 2)):
            owner[e], cut[e] = (3 << 8) | off, True
        owner[7], cut[7] = (5 << 8) | 7, True
    elif name == "cut_in_last_gid":
        owner[40], cut[40] = ((S - 1) << 8) | 3, True
        owner[12], cut[12] = ((S - 1) << 8) | 11, True
    elif name == "uncovered_beside_cut":  # a set flag whose owner word is -1 next to a covered cut
        owner[10], cut[10] = (2 << 8) | 4, True
        owner[11], cut[11] = -1, True
        owner[9], cut[9] = -1, True
    elif name == "E_not_a_multiple_of_16":
        E, S = 16 * 5 + 7, 16
        owner = _owner_words(rng, E, S)
        cut = rng.random(E) < 0.2
        cut[-1], owner[-1] = True, (9 << 8) | 0
    else:
        raise KeyError(name)
    return torch.from_numpy(cut), torch.from_numpy(owner.astype(np.int64)), S


CASES = ["no_cut", "every_lane_dead", "several_cuts_one_gid", "cut_in_last_gid", "uncovered_beside_cut",
         "E_not_a_multiple_of_16"]


def per_gid_loop(is_cut, owner_off, S: int):
    """The tables by a loop over the lanes: per gid the smallest offset of
    a covered cut lane and, at it, the smallest edge id."""
    E = is_cut.shape[0]
    m1, cut_edge = [NO_CUT] * S, [E] * S
    for e, (c, w) in enumerate(zip(is_cut.tolist(), owner_off.tolist())):
        if not c or w < 0:
            continue
        g, off = min(w >> 8, S - 1), w & 0xFF
        if (off, e) < (m1[g], cut_edge[g]):
            m1[g], cut_edge[g] = off, e
    return m1, cut_edge


@pytest.mark.parametrize("name", CASES)
def test_cut_tables_plain_equals_per_gid_loop(name):
    is_cut, owner_off, S = _case(name)
    m1, cut_edge = ranking_kernel.cut_tables_plain(is_cut, owner_off, S)
    want = per_gid_loop(is_cut, owner_off, S)
    assert (m1.tolist(), cut_edge.tolist()) == want
    if name == "several_cuts_one_gid":
        assert (want[0][3], want[1][3]) == (2, 20)  # the smallest offset, then the smallest edge at it
    if name in ("no_cut", "every_lane_dead"):
        assert want == ([NO_CUT] * S, [is_cut.shape[0]] * S)


@pytest.mark.parametrize("name", CASES + ["random_2_17_plus_5"])
def test_cut_tables_host_build_equals_plain(host, name):
    """The kernel's fold and unpack, one thread on the host, bit for bit
    against the plain version (and a larger random case: 2^17 + 5 lanes,
    a cut in one lane of 500)."""
    if name.startswith("random"):
        rng = np.random.default_rng(17)
        E, S = (1 << 17) + 5, 4096
        is_cut = torch.from_numpy(rng.random(E) < 0.002)
        owner_off = torch.from_numpy(_owner_words(rng, E, S))
    else:
        is_cut, owner_off, S = _case(name)
    got = host_cut_tables(host)(is_cut, owner_off, S)
    want = ranking_kernel.cut_tables_plain(is_cut, owner_off, S)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_cpu_cut_tables_run_the_plain_version_and_count_nothing(monkeypatch):
    """On CPU tensors the wrapper is the plain version, loads no CUDA
    library and counts no launch; ``ranking._cut_tables`` goes through it."""

    def refuse(*a, **k):
        raise AssertionError("the CUDA library was loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load", refuse)
    is_cut, owner_off, S = _case("several_cuts_one_gid")
    before = trace.totals()
    got = ranking_kernel.cut_tables(is_cut, owner_off, S)
    via = ranking._cut_tables(is_cut, owner_off, torch.zeros(S, dtype=torch.int64))
    want = ranking_kernel.cut_tables_plain(is_cut, owner_off, S)
    assert all(torch.equal(a, b) and torch.equal(b, c) for a, b, c in zip(got, via, want))
    grew = trace.since(before)
    assert (grew["cut_table_launches"], grew["cut_table_rows"]) == (0, 0)


def test_cut_tables_refuse_bad_inputs():
    is_cut, owner_off, S = _case("no_cut")
    with pytest.raises(TypeError):
        ranking_kernel.cut_tables(is_cut, owner_off.int(), S)
    with pytest.raises(ValueError, match="bool"):
        ranking_kernel.cut_tables(is_cut.to(torch.uint8), owner_off, S)
    with pytest.raises(ValueError, match="length"):
        ranking_kernel.cut_tables(is_cut[1:], owner_off, S)
    with pytest.raises(ValueError, match="contiguous"):
        ranking_kernel.cut_tables(torch.zeros(2 * is_cut.shape[0], dtype=torch.bool)[::2], owner_off, S)
    with pytest.raises(ValueError, match="gid"):
        ranking_kernel.cut_tables(is_cut, owner_off, 0)
    meta = torch.empty(8, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ranking_kernel.cut_tables(torch.empty(8, dtype=torch.bool, device="meta"), meta, 4)
