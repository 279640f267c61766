"""The harness end to end on the CPU (the assembler's plain kernels), at a
tiny cell made only of new files: it runs and agrees with the reference, and
its comparison fails where the timed path is broken underneath."""

import json
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest

from euler_bench import cells, control, reads, reference, run
from euler_bench.tests.conftest import TINY, TINY_CLEAN
from tpu_euler_torch import oracle
from tpu_euler_torch.io.encode import encode_reads
from tpu_euler_torch.pipeline import assemble as pipeline
from tpu_euler_torch.simulate import homopolymer_genome, interspersed_repeat_genome, random_genome, simulate_reads

ROOT = Path(__file__).resolve().parents[2]


SEED = 2**31 + 17


def _run(root, seconds=0.0, workload=TINY, **kw):
    return run.run_cell(workload, SEED, seconds, False, device="cpu", root=root, t_start=time.perf_counter(), **kw)


def test_a_cell_made_of_new_files_runs_and_is_correct(tiny_root):
    out = _run(tiny_root, seconds=0.5)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"assembly_s", "cold_assembly_s", "setup_s"}  # no device number from a CPU run
    assert list(out)[-1] == "checks"
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert out["device"]["platform"] == "cpu" and out["device"]["memory_peak_bytes"] is None


@pytest.mark.parametrize(
    "genome, k, min_count, error_rate, circular, tip_rounds, bubble_rounds",
    [
        (random_genome(3000, seed=1), 31, 1, 0.0, True, 0, 0),
        (random_genome(3000, seed=2), 41, 1, 0.0, False, 0, 0),
        (homopolymer_genome(2500, seed=3), 21, 1, 0.0, True, 0, 0),
        (interspersed_repeat_genome(4000, seed=4, repeat_len=150), 33, 1, 0.0, False, 0, 0),
        (random_genome(3000, seed=5), 31, 2, 0.004, True, 0, 0),
        (interspersed_repeat_genome(3000, seed=6, repeat_len=120), 63, 2, 0.003, True, 0, 0),
        (random_genome(3000, seed=5), 31, 1, 0.004, True, 3, 2),
        (random_genome(3000, seed=9), 21, 1, 0.006, False, 2, 2),
        (random_genome(3000, seed=10), 41, 1, 0.005, False, 3, 1),
        (interspersed_repeat_genome(4000, seed=11, repeat_len=150), 33, 1, 0.005, True, 3, 2),
    ],
)
def test_reference_agrees_with_the_assembler_and_its_oracle(
    genome, k, min_count, error_rate, circular, tip_rounds, bubble_rounds
):
    reads_ = simulate_reads(genome, 100, 14, seed=7, error_rate=error_rate, circular=circular)
    codes = encode_reads(reads_, 100)
    clean = {"tip_rounds": tip_rounds, "bubble_rounds": bubble_rounds}
    ref = reference.assemble(codes, {"k": k, "min_count": min_count, **clean}, "cpu")
    assert ref.contigs == {s.encode() for s in oracle.assemble_oracle(reads_, k, min_count=min_count, **clean)}
    cfg = pipeline.AssemblyConfig(
        k=k, min_count=min_count, read_batch=512, read_len=100, spectrum_capacity=1 << 16, **clean)
    got = pipeline.assemble_codes(codes, cfg, "cpu")
    assert (got.contigs, got.n_kmers_counted, got.n_distinct_kmers) == (ref.contigs, ref.windows, ref.distinct)
    assert len(ref.clipped) <= tip_rounds and len(ref.popped) <= bubble_rounds
    if tip_rounds:  # the case cleans: its reads leave tips and bubbles to remove
        assert sum(ref.clipped) > 0 and sum(ref.popped) > 0


def test_a_bubble_whose_branches_tie_stays():
    """A sequence X + m + rc(X): its two strands are two chains from node X
    to node rc(X) with the same canonical k-mers, so they tie on count and
    least k-mer, and the group stays; popping either would remove both,
    since a k-mer goes in both orientations."""
    x, m = "ACGGTCATTGCAGTTCAGGA", "GTTACCGATG"
    comp = str.maketrans("ACGT", "TGCA")
    seq = x + m + x.translate(comp)[::-1]
    k = 21
    codes = encode_reads([seq], 100)
    settings = {"k": k, "min_count": 1, "tip_rounds": 3, "bubble_rounds": 2}
    ref = reference.assemble(codes, settings, "cpu")
    assert ref.contigs == {min(seq, seq.translate(comp)[::-1]).encode()}
    assert ref.clipped == [0] and ref.popped == [0]
    assert ref.contigs == {s.encode() for s in oracle.assemble_oracle([seq], k, tip_rounds=3, bubble_rounds=2)}
    cfg = pipeline.AssemblyConfig(k=k, read_batch=512, read_len=100, spectrum_capacity=1 << 10,
                                  tip_rounds=3, bubble_rounds=2)
    assert pipeline.assemble_codes(codes, cfg, "cpu").contigs == ref.contigs


def test_a_cleaning_cell_made_of_new_files_runs_and_is_correct(tiny_root):
    """Two read sets, from seeds S and S + 2^32, assembled in turn and each
    compared with its own reference."""
    cell = cells.load(tiny_root, TINY_CLEAN)
    assert cell.read_sets == 2
    for i in range(cell.read_sets):
        codes = reads.host_codes(reads.make_codes(seed=SEED + i * run.READ_SET_STRIDE, device="cpu", **cell.read_params()))
        ref = reference.assemble(codes, cell.settings(), "cpu")
        assert sum(ref.clipped) > 0 and sum(ref.popped) > 0  # the cell's reads leave tips and bubbles
    out = _run(tiny_root, seconds=0.5, workload=TINY_CLEAN)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 2
    assert all(c["value"] == 0 for c in out["checks"].values())


def _altered(res):
    """One base of one contig changed where the assembly produces it."""
    c = sorted(res.contigs)[0]
    i = len(c) // 2
    swap = {ord("A"): b"C", ord("C"): b"G", ord("G"): b"T", ord("T"): b"A"}[c[i]]
    res.contigs = (res.contigs - {c}) | {c[:i] + swap + c[i + 1 :]}
    return res


def _half_batch(codes, cfg, dev):
    """Half of each batch of reads left out."""
    return pipeline.assemble_codes(codes[: codes.shape[0] // 2], cfg, dev)


def _unchanged_spectrum(monkeypatch):
    """The count step returns the spectrum it started from."""
    from tpu_euler_torch.kmer.count import empty_spectrum

    def count(codes_all, cfg, device, t):
        return empty_spectrum(cfg.spectrum_capacity, cfg.k, device), 0

    monkeypatch.setattr(pipeline, "count_spectrum_oneshot", count)


@pytest.mark.parametrize(
    "fault", ["altered_base", "half_batch", "unchanged_state", "control", "no_cleaning", "control_of_cleaning"])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, fault):
    kw = {"workload": TINY_CLEAN} if fault in ("no_cleaning", "control_of_cleaning") else {}
    if fault == "no_cleaning":
        kw["assemble"] = control.no_cleaning_assemble
    elif fault == "control_of_cleaning":
        kw["assemble"] = control.control_assemble
    elif fault == "altered_base":
        kw["assemble"] = lambda codes, cfg, dev: _altered(pipeline.assemble_codes(codes, cfg, dev))
    elif fault == "half_batch":
        kw["assemble"] = _half_batch
    elif fault == "unchanged_state":
        _unchanged_spectrum(monkeypatch)
    else:
        kw["assemble"] = control.control_assemble
    out = _run(tiny_root, **kw)
    read_sets = cells.load(tiny_root, kw.get("workload", TINY)).read_sets  # a 0 s window assembles each once
    assert out["correct"] is False and out["failed"] == out["attempted"] == read_sets
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_one_changed_base_fails_the_comparison():
    ref = reference.Reference(windows=10, distinct=5, contigs={b"ACGTACGTAC", b"TTTTGGGG"})
    res = types.SimpleNamespace(contigs={b"ACGTACGTAC", b"TTTTGGGC"}, n_kmers_counted=10, n_distinct_kmers=5)
    got = run.compare(res, ref)
    assert got["contigs_only_program"] == got["contigs_only_reference"] == 1
    assert run.compare(types.SimpleNamespace(**{**vars(res), "contigs": set(ref.contigs)}), ref) == dict.fromkeys(
        run.LIMITS, 0)


def test_the_command_gives_no_result_without_the_native_packer(monkeypatch, capsys):
    """Where the native read packer does not load, the assembler would pack
    on its slower numpy path: set-up stops with no result."""
    import torch

    from tpu_euler_torch.io import native

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(native, "native_available", lambda: False)
    rc = run.main(["--workload", "ecoli-k31-exact-50x", "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == "" and "native read packer" in out.err


def test_a_metric_with_a_reader_of_its_own_is_read_from_new_files(tiny_root):
    bench = tiny_root / "euler_bench"
    (bench / "metrics" / "stages_seen.json").write_text(json.dumps({"kind": "reader"}))
    (bench / "metrics" / "stages_seen.py").write_text(
        "def read(ctx):\n    return float(len(ctx['stages'])) if ctx['stages'] else None\n")
    metric = {"name": "stages_seen", "recipe": {"kind": "reader"}}
    assert run.per_layer_value(metric, {"trace": None, "stages": [{}, {}]}, bench) == 2.0
    assert run.per_layer_value(metric, {"trace": None, "stages": []}, bench) is None


def test_a_layer_span_that_is_gone_is_named():
    from euler_bench import devtrace

    module = types.SimpleNamespace(**{n: (lambda: n) for n in devtrace.LAYER_SPANS if n != "chains_from_t"})
    kept = dict(vars(module))
    with devtrace.layer_spans(module) as missing:
        assert missing == ["chains_from_t"] and module.apply_cutoff is not kept["apply_cutoff"]
    assert vars(module) == kept


def test_the_command_fails_without_a_card():
    out = subprocess.run(
        [sys.executable, "euler_bench/run.py", "--workload", "ecoli-k31-exact-50x", "--seed", "1", "--seconds", "1",
         "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_the_command_fails_beside_only_its_own_files(tmp_path):
    """A folder that holds BENCHMARK.json and the benchmark's paths, and not
    the assembler, gives no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in json.loads((ROOT / "BENCHMARK.json").read_text())["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p, ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "euler_bench/run.py", "--workload", "ecoli-k31-exact-50x", "--seed", "1", "--seconds", "1",
         "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0 and out.stdout == ""
