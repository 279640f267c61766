"""The tour at bench scale (``tpu_euler_torch/bench_tour.py``) on the CPU at
20 kbp: its record against the reference's ``eulerian_tour`` on the same
reads through the reference's graph step (scripts/bench_tour.py's steps and
gate), the phase split, the gate against broken tours, and the exit codes."""

import json

import jax
import numpy as np
import pytest
import torch

from tpu_euler.config import AssemblyConfig as JaxConfig
from tpu_euler.euler.tour import eulerian_tour as jax_eulerian_tour
from tpu_euler.pipeline.assemble import count_spectrum as jax_count_spectrum
from tpu_euler.pipeline.assemble import make_graph_step
from tpu_euler.pipeline.assemble import right_size_spectrum as jax_right_size
from tpu_euler_torch import bench_tour
from tpu_euler_torch.euler.tour import eulerian_tour

BP = 20_000


@pytest.fixture(scope="module")
def records():
    return bench_tour.run(BP, "cpu", emit=lambda _: None)


@pytest.fixture(scope="module")
def small_tour():
    codes, cfg = bench_tour.tour_inputs(3_000)
    g = bench_tour.tour_graph(codes, cfg, "cpu")
    return g, eulerian_tour(g)


def reference_record(bp: int) -> dict:
    """scripts/bench_tour.py's record fields, from the reference package on
    the port's inputs (which equal the reference's: test_torch_oracle.py)."""
    codes, cfg = bench_tour.tour_inputs(bp)
    jcfg = JaxConfig(k=cfg.k, read_batch=cfg.read_batch, read_len=cfg.read_len,
                     spectrum_capacity=cfg.spectrum_capacity)
    acc, _ = jax_count_spectrum(codes, jcfg, {})
    g, _ = make_graph_step(jcfg.k, jcfg.min_count)(jax_right_size(acc))
    tour = jax_eulerian_tour(g)
    valid, in_tour = np.asarray(g.edge_valid), np.asarray(tour.in_tour)
    chain, pos = np.asarray(tour.chain), np.asarray(tour.pos)
    every_edge_once = bool((valid == in_tour).all())
    if every_edge_once:  # scripts/bench_tour.py:66-80
        order = np.lexsort((pos[valid], chain[valid]))
        pc, cc = pos[valid][order], chain[valid][order]
        starts = np.r_[True, cc[1:] != cc[:-1]]
        expect = np.arange(pc.size) - np.maximum.accumulate(np.where(starts, np.arange(pc.size), 0))
        every_edge_once = bool((pc == expect).all())
    return {
        "edges": int(valid.sum()),
        "edge_capacity": int(valid.size),
        "chains": int(jax.device_get(tour.n_chains)),
        "merge_rounds": int(jax.device_get(tour.merge_rounds)),
        "every_edge_once": every_edge_once,
    }


def test_record_equals_the_reference_run(records):
    want = reference_record(BP)
    timed = records[-1]
    assert {key: timed[key] for key in want} == want
    assert want["every_edge_once"] and want["chains"] == 2 and want["edges"] == 2 * BP


def test_record_fields_and_split(records):
    assert [r["run"] for r in records] == ["warm", "timed"]
    timed = records[-1]
    assert timed["genome_bp"] == BP and timed["device"] == timed["card"] == "cpu"
    assert timed["reads"] == BP * 50 // 100 and timed["read_batch"] == 1 << 14
    assert bench_tour.passed(timed) and timed["split_equals_tour"]
    assert len(timed["merge_s"]) == timed["merge_rounds"]
    assert timed["pair_s"] > 0 and timed["cut_rank_s"] > 0 and timed["tour_wall_s"] > 0
    assert "profile" not in timed and "tour_peak_gib" not in timed  # no device numbers from a CPU run
    for r in records:
        assert r["every_edge_once"] and r["walks_follow_edges"]


def test_full_size_config_is_the_reference_scripts():
    """At 4.6 Mbp the batch is the reference's 2^18 (only the size is
    read, no reads simulated)."""
    assert bench_tour.GENOME_BP == 4_600_000
    assert (bench_tour.GENOME_SEED, bench_tour.READ_SEED) == (2024, 2025)
    assert min(bench_tour.READ_BATCH, 1 << (2_300_000 - 1).bit_length()) == 1 << 18


def swap_successors(tour):
    succ = tour.succ.clone()
    linked = torch.nonzero(succ >= 0).squeeze(1)
    a, b = int(linked[0]), int(linked[linked.numel() // 2])
    succ[a], succ[b] = tour.succ[b], tour.succ[a]
    return tour._replace(succ=succ)


def drop_edge(tour):
    in_tour = tour.in_tour.clone()
    in_tour[int(torch.nonzero(in_tour)[0])] = False
    return tour._replace(in_tour=in_tour)


def swap_positions(tour):
    pos = tour.pos.clone()
    e = torch.nonzero(tour.in_tour).squeeze(1)
    pos[e[0]], pos[e[1]] = tour.pos[e[1]], tour.pos[e[0]]
    pos[e[0]] += 1  # now no chain's positions run 0..len-1
    return tour._replace(pos=pos)


def test_gate_passes_the_tour(small_tour):
    g, tour = small_tour
    assert bench_tour.tour_gate(g, tour) == {"every_edge_once": True, "walks_follow_edges": True}


@pytest.mark.parametrize(
    "broken,fails",
    [(swap_successors, "walks_follow_edges"), (drop_edge, "every_edge_once"), (swap_positions, "every_edge_once")],
)
def test_gate_fails_a_broken_tour(small_tour, broken, fails):
    g, tour = small_tour
    gate = bench_tour.tour_gate(g, broken(tour))
    assert gate[fails] is False and gate["walks_follow_edges"] is False


def test_split_equals_the_tour(small_tour):
    g, tour = small_tour
    got, split = bench_tour.split_tour(g, "cpu")
    assert bench_tour.same_tour(got, tour)
    assert set(split) == {"pair_s", "merge_s", "cut_rank_s"} and len(split["merge_s"]) == tour.merge_rounds


def test_no_card_fails_without_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench_tour.main(["--bp", "2000"])


def test_main_writes_the_timed_record_and_exits_on_the_gate(tmp_path, monkeypatch, capsys):
    out = tmp_path / "tour.json"
    assert bench_tour.main(["--bp", "2000", "--device", "cpu", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["run"] == "timed" and rec["edges"] == 4000 and rec["every_edge_once"]
    assert len(capsys.readouterr().out.strip().splitlines()) == 2
    monkeypatch.setattr(bench_tour, "tour_gate", lambda g, t: {"every_edge_once": True, "walks_follow_edges": False})
    assert bench_tour.main(["--bp", "2000", "--device", "cpu"]) == 1
