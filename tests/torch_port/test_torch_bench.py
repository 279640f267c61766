"""The bench entry (``bench_torch.py``, ``tpu_euler_torch/bench.py``) on the
CPU at cut genomes: its JSON line's read, window and k-mer counts and its
contig set against the reference's ``assemble_codes`` on the same codes, a
failed gate, the card checks, gloo ranks, the seeds and the metric names."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tpu_euler.config import AssemblyConfig as RefConfig
from tpu_euler.pipeline.assemble import assemble_codes as ref_assemble_codes
from tpu_euler_torch import bench, simulate
from tpu_euler_torch.pipeline import assemble as pipeline

ROOT = Path(__file__).resolve().parents[2]
# the smallest cuts that keep each configuration's shape: the repeat genome
# needs room for its 3 kbp element and its tandem array
CUTS = {"2": 20_000, "3": 20_000, "repeat": 30_000}


def run_bench(argv, capsys) -> tuple[int, dict]:
    rc = bench.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines  # one JSON line on stdout; progress goes to stderr
    return rc, json.loads(lines[0])


@pytest.fixture(scope="module")
def reference():
    """Each cut configuration through the reference package."""
    out = {}
    for config, bp in CUTS.items():
        genome, codes, cfg, _ = bench.make_inputs(config, None, bp)
        out[config] = ref_assemble_codes(codes, RefConfig(**dataclasses.asdict(cfg)))
    return out


@pytest.mark.parametrize("config", list(CUTS))
def test_counts_and_contigs_equal_the_reference(config, reference, capsys):
    bp = CUTS[config]
    rc, rec = run_bench(["--config", config, "--genome-bp", str(bp), "--reps", "1", "--device", "cpu"], capsys)
    assert rc == 0
    d, ref = rec["detail"], reference[config]
    assert (d["reads"], d["kmers_counted"], d["distinct_kmers"]) == (
        ref.n_reads, ref.n_kmers_counted, ref.n_distinct_kmers
    )
    assert (d["contigs"], d["contigs_sha256"]) == (len(ref.contigs), bench.contig_digest(ref.contigs))
    assert d["contig_bases"] == sum(len(c) for c in ref.contigs)
    assert rec["value"] == d["runs"][0]["wall_s"] > 0
    assert d["reduced"]["genome_bp"] == bp and d["genome_bp"] == bp
    assert rec["metric"] == bench.metric_name(config, bp, 1, False, "cpu")


def test_the_line_holds_the_references_fields_and_no_device_numbers(tmp_path, capsys):
    out = tmp_path / "bench.json"
    rc, rec = run_bench(["--genome-bp", "20000", "--reps", "2", "--device", "cpu", "--out", str(out)], capsys)
    assert rc == 0 and json.loads(out.read_text()) == rec
    assert rec["metric"] == "wall_clock_20kbp_50x_k31_1xcpu" and rec["unit"] == "s"
    assert "vs_baseline" not in rec  # the 60 s target is a v5e-16's
    d = rec["detail"]
    assert d["best_of"] == 2 and len(d["runs"]) == 2 and rec["value"] == min(r["wall_s"] for r in d["runs"])
    assert d["wall_mean_s"] >= rec["value"] and d["wall_median_s"] >= rec["value"] and d["wall_sd_s"] >= 0
    for run in d["runs"]:
        assert set(run["stages_s"]) >= {"encode", "count", "graph", "extract"}
        assert run["new_build_files"] == 0 and "copy_probe" not in run
        assert run["wall_then_sync_s"] >= run["wall_s"]
    assert d["transport"] == "packed" and d["reads"] == 10_000 and d["kmers_counted"] == 700_000
    assert d["reads_per_s"] == d["reads"] / rec["value"]
    # a CPU run names no card and writes no device number
    assert d["device"] == "cpu" and "card" not in d
    assert d["peak_device_gib"] is None and d["device_idle_share"] is None and "kmers_per_s_per_gpu" not in d
    assert d["extract_launches"] == 0  # the plain version runs on CPU tensors


def test_a_corrupted_contig_fails_the_gate(monkeypatch, capsys):
    real = pipeline.assemble_codes

    def corrupted(codes, cfg, device):
        res = real(codes, cfg, device)
        (c,) = res.contigs
        c = bytearray(c)
        c[100] = ord("A") if c[100] != ord("A") else ord("C")
        return dataclasses.replace(res, contigs={bytes(c)})

    monkeypatch.setattr(pipeline, "assemble_codes", corrupted)
    rc, rec = run_bench(["--genome-bp", "5000", "--reps", "1", "--device", "cpu"], capsys)
    assert rc == 1 and rec["value"] is None and "detail" not in rec
    assert "the contig does not spell the genome" in rec["error"]
    assert rec["metric"] == "wall_clock_5kbp_50x_k31_1xcpu"


def test_a_run_that_differs_from_the_warm_up_fails(monkeypatch, capsys):
    real, calls = pipeline.assemble_codes, []

    def drifting(codes, cfg, device):
        calls.append(1)
        res = real(codes, cfg, device)
        return dataclasses.replace(res, n_distinct_kmers=res.n_distinct_kmers + (len(calls) > 1))

    monkeypatch.setattr(pipeline, "assemble_codes", drifting)
    rc, rec = run_bench(["--genome-bp", "5000", "--reps", "1", "--device", "cpu"], capsys)
    assert rc == 1 and rec["value"] is None and "timed run 1" in rec["error"]


def never_simulate(*a, **kw):
    raise AssertionError("simulated before the device check")


def test_no_card_exits_before_simulating(monkeypatch):
    monkeypatch.setattr(bench.torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "make_inputs", never_simulate)
    with pytest.raises(SystemExit, match="no CUDA device") as e:
        bench.main(["--genome-bp", "2000"])
    assert e.value.code != 0


def test_more_ranks_than_gpus_exit_before_simulating(monkeypatch):
    monkeypatch.setattr(bench.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench.torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(bench, "make_inputs", never_simulate)
    with pytest.raises(SystemExit, match="--mesh 4 needs 4 GPUs, 1 visible"):
        bench.main(["--config", "5", "--mesh", "4"])


def test_the_root_script_without_a_card_prints_no_result():
    """``python3 bench_torch.py`` where no card is visible: non-zero, and
    nothing on stdout."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "bench_torch.py", "--genome-bp", "2000"], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env=env,
    )
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr


@pytest.mark.parametrize(
    "argv",
    [["--shard-traversal"], ["--reps", "0"], ["--genome-bp", "4600000"], ["--config", "6"], ["--mesh", "-1"]],
)
def test_bad_arguments_exit_2(argv):
    with pytest.raises(SystemExit) as e:
        bench.main(argv + ["--device", "cpu"])
    assert e.value.code == 2


def test_gloo_ranks_give_rank_0s_assembly(reference, capsys):
    rc, rec = run_bench(["--mesh", "2", "--genome-bp", "20000", "--reps", "1", "--device", "cpu"], capsys)
    assert rc == 0, rec
    d, ref = rec["detail"], reference["2"]
    assert rec["metric"] == "wall_clock_20kbp_50x_k31_2xcpu" and d["transport"] == "int8"
    assert (d["reads"], d["kmers_counted"], d["distinct_kmers"], d["contigs_sha256"]) == (
        ref.n_reads, ref.n_kmers_counted, ref.n_distinct_kmers, bench.contig_digest(ref.contigs)
    )
    assert [r["rank"] for r in d["ranks"]] == [0, 1]
    (run,) = d["runs"]
    assert run["wall_s"] == max(run["rank_walls_s"]) == rec["value"]
    assert d["ranks_start_to_join_s"] > max(r["startup_s"] for r in d["ranks"]) > 0
    assert d["reduced"]["read_batch"] == 8192  # a rank's share of 10,000 reads


def test_default_seeds_give_config2_inputs():
    genome, codes, cfg, reduced = bench.make_inputs("2", None, 20_000)
    want_genome, want_codes, want_cfg = simulate.config2_inputs(genome_bp=20_000)
    assert genome == want_genome == simulate.random_genome(20_000, seed=2024)
    assert (codes == want_codes).all()
    assert (codes == simulate.simulate_read_codes(genome, 100, 50, seed=2025, circular=True)).all()
    assert cfg == dataclasses.replace(want_cfg, read_batch=16_384, spectrum_capacity=1 << 20)
    assert reduced == {"genome_bp": 20_000, "read_batch": 16_384, "spectrum_capacity": 1 << 20}


@pytest.mark.parametrize("config", ["2", "3", "4", "5", "repeat"])
def test_seed_changes_the_genome_and_seeds_the_reads_one_above(config):
    genome, codes, _, _ = bench.make_inputs(config, 7, 6_000)
    default, _, _, _ = bench.make_inputs(config, None, 6_000)
    assert genome != default
    if config != "repeat":  # the repeat genome is built from its seed and seed + 1
        assert genome == simulate.random_genome(6_000, seed=7)
    if config in ("2", "3", "5"):
        err = {"3": simulate.CONFIG3_ERROR_RATE}.get(config, 0.0)
        want = simulate.simulate_read_codes(genome, 100, 50 if config == "2" else 40, seed=8, error_rate=err, circular=True)
        assert (codes == want).all()


@pytest.mark.parametrize(
    "config,fn,args",
    [
        ("2", "config2_inputs", (2024, 4_600_000)),
        ("3", "config3_inputs", (4_600_000, None)),
        ("4", "config4_inputs", (12_000_000, None)),
        ("5", "config5_inputs", (100_000_000, 505)),
        ("repeat", "adversarial_inputs", (12_000_000, 5150)),
    ],
)
def test_full_size_takes_the_reference_inputs_unchanged(monkeypatch, config, fn, args):
    """Uncut and unseeded, each configuration is its simulator's full-size
    call with the reference seeds, passed on as it is (nothing simulated
    here)."""
    made, got = ("genome", "codes", "cfg"), []
    monkeypatch.setattr(simulate, fn, lambda *a: got.append(a) or made)
    assert bench.make_inputs(config) == (*made, None)
    assert got == [args]


def test_metric_names():
    names = {
        config: bench.metric_name(config, bench.SETUPS[config].genome_bp, 1, False, "H100") for config in bench.SETUPS
    }
    assert names == {
        "2": "wall_clock_4.6Mbp_50x_k31_1xH100",
        "3": "wall_clock_4.6Mbp_40x_err_k31_1xH100",
        "4": "wall_clock_12Mbp_60x_paired_k31_1xH100",
        "5": "wall_clock_100Mbp_40x_k41_1xH100",
        "repeat": "wall_clock_12Mbp_repeat_k31_1xH100",
    }
    assert bench.metric_name("5", 100_000_000, 4, False, "H100") == "wall_clock_100Mbp_40x_k41_4xH100"
    assert bench.metric_name("5", 25_000_000, 4, True, "H100") == "wall_clock_25Mbp_40x_k41_sharded_traversal_4xH100"
