"""The op-cost table (``tpu_euler_torch/microbench.py``) on the CPU: every
section with ``--quick`` returns its rows and passes its equality checks;
the walk sweep gives the same arrays at the reference's seven (stride, cap)
pairs, equal to the reference's ``rank_chains_ruling`` at the default pair,
each row naming its route;
the walk's module constants come back after a pair that raises."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_euler.euler import ranking as jax_ranking
from tpu_euler_torch import microbench
from tpu_euler_torch.euler import ranking, ranking_kernel

ROWS = {"ops": 14, "sortceiling": 3, "sortshape": 2, "topk": 3, "drain": 12, "walkstride": 1}
TIMES = {"ms", "ms_min", "ms_max", "reps", "bytes", "hbm_share", "device"}


@pytest.fixture(scope="module")
def quick():
    return microbench.run(quick=True, device="cpu", emit=lambda _: None)


@pytest.fixture(scope="module")
def walk():
    b = microbench.Bench("cpu", quick=True)
    inputs = microbench.walk_inputs(b, microbench.QUICK_WALK_BP)
    rows, first = microbench.walk_sweep(b, inputs, microbench.PAIRS)
    return b, inputs, rows, first


@pytest.mark.parametrize("section", sorted(ROWS))
def test_quick_section_returns_its_rows(quick, section):
    rows = [r for r in quick["rows"] if r["section"] == section]
    assert len(rows) == ROWS[section] == quick["summary"]["sections"][section]["rows"]
    for r in rows:
        assert r["device"] == "cpu"
        if section == "walkstride":
            assert r["total_spread_s"][0] <= r["total_s"] <= r["total_spread_s"][1] and r["launches"] is None
            continue
        assert TIMES <= set(r) and r["reps"] == 5
        assert r["ms_min"] <= r["ms"] <= r["ms_max"] and r["bytes"] > 0
        assert r["hbm_share"] is None  # no device rate from a CPU run


def test_quick_run_passes_every_check(quick):
    s = quick["summary"]
    assert s["quick"] and s["device"] == s["card"] == "cpu"
    assert s["checks_passed"] == 23
    names = {(r["section"], r["name"]) for r in quick["rows"]}
    assert {("drain", "oneshot_count"), ("ops", "scatter_amin_one_address"), ("topk", "topk"),
            ("sortceiling", "keys_sort_2word_config5_group"), ("walkstride", "stride_64_cap_128")} <= names


def test_drain_parts_add_up(quick):
    for shape in ("config 2 one-shot buffer, k = 31", "config 5 arena group, k = 41"):
        rows = [r for r in quick["rows"] if r["section"] == "drain" and r["shape"] == shape]
        whole = rows[-1]
        assert whole["name"] == "oneshot_count"
        assert whole["parts_sum_ms"] == pytest.approx(sum(r["ms"] for r in rows[:-1]))
        assert whole["valid"] < whole["rows"] and whole["distinct_found"] <= whole["capacity"]


def test_walk_sweep_same_arrays_at_every_pair(walk):
    _, inputs, rows, first = walk
    assert [(r["stride"], r["walk_cap"]) for r in rows] == list(microbench.PAIRS)
    assert all(r["equal_to_first"] for r in rows) and rows[0]["edges"] == 2 * microbench.QUICK_WALK_BP
    succ, d, end = first
    assert succ.shape == d.shape == end.shape == inputs[0].shape


def test_walk_at_the_default_pair_equals_the_reference(walk):
    _, (_, valid, _), _, (succ_cut, d, end) = walk
    ref = jax_ranking.rank_chains_ruling(jnp.asarray(succ_cut.numpy().astype(np.int32)), jnp.asarray(valid.numpy()))
    assert ref is not None
    v = valid.numpy()
    np.testing.assert_array_equal(d.numpy()[v], np.asarray(ref[0])[v])
    np.testing.assert_array_equal(end.numpy()[v], np.asarray(ref[1])[v])
    assert microbench.PAIRS[0] == (ranking.RULER_STRIDE, ranking.WALK_CAP) == (64, 128)


def test_walk_rows_name_their_route(walk):
    """On the CPU every row is the plain route's; ``plain_route`` puts the
    plain versions in the kernel wrappers' place and gives them back."""
    _, _, rows, _ = walk
    assert {r["route"] for r in rows} == {"plain"}
    wrappers = (ranking_kernel.walk_round, ranking_kernel.jump_min, ranking_kernel.jump_rank)
    with pytest.raises(RuntimeError, match="inside"):
        with microbench.plain_route():
            assert ranking_kernel.walk_round is ranking_kernel.walk_round_plain
            assert ranking_kernel.jump_min is ranking_kernel.jump_min_plain
            assert ranking_kernel.jump_rank is ranking_kernel.jump_rank_plain
            raise RuntimeError("inside")
    assert (ranking_kernel.walk_round, ranking_kernel.jump_min, ranking_kernel.jump_rank) == wrappers


def test_held_rounds_hold_every_round_and_raise_on_a_difference(walk, monkeypatch):
    """``held_rounds`` runs each walk round and each jump twice from the
    same state and compares them; a wrapper that differs raises."""
    _, inputs, _, first = walk
    b = microbench.Bench("cpu", quick=True)
    with microbench.held_rounds() as held:
        got = microbench.walk_once(b, *inputs)[2]
    assert held["walk_rounds"] >= 1 and held["jumps"] >= 2
    assert all(torch.equal(x, y) for x, y in zip(got, first))
    plain = ranking_kernel.jump_rank

    def off_by_one(p, d, q, rounds):
        p, d, q = plain(p, d, q, rounds)
        return p, d + 1, q

    monkeypatch.setattr(ranking_kernel, "jump_rank", off_by_one)
    with pytest.raises(microbench.MismatchError, match="jump_rank"):
        with microbench.held_rounds():
            microbench.walk_once(b, *inputs)
    assert ranking_kernel.jump_rank is off_by_one


def test_constants_come_back_after_a_pair_that_raises(walk, monkeypatch):
    b, inputs, _, _ = walk

    def broken(*a):
        assert (ranking.RULER_STRIDE, ranking.WALK_CAP) == (16, 32)
        raise RuntimeError("walk failed")

    monkeypatch.setattr(ranking, "cycle_min_ruling_tables", broken)
    with pytest.raises(RuntimeError, match="walk failed"):
        microbench.walk_sweep(b, inputs, ((16, 32),))
    assert (ranking.RULER_STRIDE, ranking.WALK_CAP) == (64, 128)


@pytest.mark.parametrize("stride,cap", [(64, 256), (64, 0), (0, 128)])
def test_walk_constants_refused_outside_the_owner_word(stride, cap):
    with pytest.raises(ValueError):
        with microbench.walk_constants(stride, cap):
            pass
    assert (ranking.RULER_STRIDE, ranking.WALK_CAP) == (64, 128)


def test_a_candidate_that_differs_raises(monkeypatch):
    monkeypatch.setattr(microbench, "_starts_by_topk", lambda is_new, cap: torch.zeros(cap, dtype=torch.int64))
    with pytest.raises(microbench.MismatchError, match="topk"):
        microbench.run(["topk"], quick=True, device="cpu", emit=lambda _: None)


def test_no_card_fails_without_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        microbench.main(["--quick"])


def test_main_writes_rows_and_summary(tmp_path, capsys):
    out = tmp_path / "mb.json"
    assert microbench.main(["--quick", "--device", "cpu", "--section", "topk", "--section", "sortshape",
                            "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert [r["section"] for r in rec["rows"]] == ["topk"] * 3 + ["sortshape"] * 2
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 6 and json.loads(lines[-1])["summary"] == "microbench"
