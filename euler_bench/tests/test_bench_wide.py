"""The plant cell (``athaliana-k77-exact-40x``): its configuration is
TAIR10.1 chromosome by chromosome and its reckoning the assembler's; a tiny
cell of new files at its shape (k = 77, 150-base reads, a linear and a
circular chromosome, the grouped count) runs correct on the CPU and its
faults do not; the reference, the assembler and the oracle agree at that
shape with and without cleaning; the ``.wide`` metrics name the cell and
their two readers read what they say."""

import json
import time
from pathlib import Path

import pytest

from euler_bench import cells, control, devtrace, reads, reference, rooflines, run
from euler_bench.tests.conftest import add_cell
from euler_bench.tests.test_bench_harness import _altered, _half_batch
from tpu_euler_torch import oracle, trace
from tpu_euler_torch.io.encode import decode_read
from tpu_euler_torch.pipeline import assemble as pipeline
from tpu_euler_torch.simulate import random_genome, simulate_read_codes

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "athaliana-k77-exact-40x"
TINY_WIDE = "tiny-k77-exact-30x"
#: the cell's per-layer metrics and the end-to-end metric each moves: the card's
#: layers its time, the host feed the cold assembly that ``setup_s`` holds
WIDE = {name: "device_busy_s" for name in (
    "count_s.wide", "graph_walk_s.wide", "extract_roofline.wide", "key_sort_s.wide", "key_sort_rows.wide",
    "assembly_wall_s.wide", "walk_s.wide", "emit_s.wide", "emit_copy_s.wide")}
WIDE.update({"feed_wait_s.wide": "setup_s", "pack_s.wide": "setup_s"})
SEED = 2**31 + 77


def test_athaliana_is_tair10_chromosome_by_chromosome():
    cell = cells.load(ROOT, CELL)
    chroms = cell.config["chromosomes"]
    assert [c["name"] for c in chroms] == ["1", "2", "3", "4", "5", "Pt", "Mt"]
    assert [c["bp"] for c in chroms] == [30_427_671, 19_698_289, 23_459_830, 18_585_056, 26_975_502, 154_478, 366_924]
    assert sum(c["bp"] for c in chroms) == 119_667_750
    assert [c["circular"] for c in chroms] == [False] * 5 + [True] * 2
    (entry,) = [c for c in SPEC["configs"] if c["name"] == "athaliana-k77"]
    assert entry["reduced"] == ["k_list"] == list(cell.config["reduced_from_source"])
    assert entry["source"] == "https://www.ncbi.nlm.nih.gov/datasets/genome/GCF_000001735.4/"


def test_the_plant_cell_runs_the_assembler_as_deployed():
    """The settings, and what they make of the reads: 31,911,400 reads,
    2,361,443,600 windows, 122 batches of 2^18, 14 drains (13 groups of 9
    batches, then 5) over an arena of 318,587,904 rows of three words."""
    from tpu_euler_torch.config import AssemblyConfig
    from tpu_euler_torch.kmer import keys

    cell = cells.load(ROOT, CELL)
    want = AssemblyConfig(k=77, read_len=150, read_batch=262144, oneshot_rows=192_000_000, node_cap_factor=1.15,
                          spectrum_capacity=144_000_000, min_count=1)
    assert pipeline.AssemblyConfig(**cell.settings()) == want
    assert (cell.chips, cell.read_sets, cell.traffic["coverage"], cell.traffic["error_rate"]) == (1, 1, 40, 0.0)
    n_reads = reads.read_count(119_667_750, 150, 40)
    Wb = want.read_batch * want.windows_per_read
    n_batches = -(-n_reads // want.read_batch)
    bpg = want.oneshot_rows // Wb
    assert (n_reads, n_reads * want.windows_per_read, n_batches, bpg, -(-n_batches // bpg)) == (
        31_911_400, 2_361_443_600, 122, 9, 14)
    assert pipeline.arena_rows(want.spectrum_capacity, bpg * Wb) == 318_587_904
    assert keys.nwords(77) == keys.nwords(76) == keys.nwords(78) == 3
    assert n_batches * Wb > want.oneshot_rows  # the grouped count
    assert rooflines.extract_fill_bytes_of(n_reads, cell.settings()) == 58_493_596_200  # 17.46 ms at 3.35 TB/s


def test_the_wide_metrics_name_the_plant_cell():
    """Each ``.wide`` metric this cell needs is there, names the cell and
    moves the metric its layer moves; other cells and metrics may join."""
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    timed = [n for n, m in e2e.items() if CELL in m.get("workloads", []) and n not in ("setup_s", "peak_device_gib")]
    assert "device_busy_s" in timed
    per_layer = {m["name"]: m for m in SPEC["per_layer"]}
    for name, moves in WIDE.items():
        m = per_layer[name]
        assert CELL in m["workloads"] and m["moves"] == moves, name
        assert (ROOT / "euler_bench" / "metrics" / f"{name}.json").is_file()
    assert per_layer["key_sort_s.wide"]["layer"] == per_layer["key_sort_rows.wide"]["layer"] == "key sort"
    assert CELL in [w["name"] for w in SPEC["workloads"]]
    cell = cells.load(ROOT, CELL)
    assert set(WIDE) <= {m["name"] for m in cell.per_layer}
    assert {*timed, "setup_s", "peak_device_gib"} <= {m["name"] for m in cell.end_to_end}


class _Trace:
    def __init__(self, by_name):
        self.by_name = by_name

    kernel_seconds = devtrace.Reduced.kernel_seconds


def test_key_sort_seconds_are_the_cub_radix_sorts_per_assembly():
    read = cells.load_reader(ROOT / "euler_bench", "key_sort_s.wide")
    t = _Trace({
        "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<at_cuda_detail::cub::DeviceRadixSortPolicy<long>>": 3.0,
        "void at_cuda_detail::cub::DeviceRadixSortHistogramKernel<at_cuda_detail::cub::DeviceRadixSortPolicy<long>>": 0.5,
        "void at_cuda_detail::cub::DeviceRadixSortExclusiveSumKernel<at_cuda_detail::cub::DeviceRadixSortPolicy>": 0.5,
        "void at::native::vectorized_gather_kernel<16, long>(char*, char*, long, long)": 9.0,
        "extract_canonical_fill_kernel": 1.0,
    })
    assert read({"trace": t, "stages": [{}] * 4}) == pytest.approx(1.0)
    assert read({"trace": _Trace({"extract_canonical_fill_kernel": 1.0}), "stages": [{}]}) is None
    assert read({"trace": None, "stages": [{}]}) is None and read({"trace": t, "stages": []}) is None


def test_key_sort_rows_read_the_counter_per_assembly(monkeypatch):
    read = cells.load_reader(ROOT / "euler_bench", "key_sort_rows.wide")

    def rollup(rows):
        return {"assembly": 1, "seconds": {}, "cpu_seconds": {}, "calls": {},
                "counters": {} if rows is None else {"key_sort_rows": rows}}

    monkeypatch.setattr(trace, "history", lambda: [rollup(10**9), rollup(300), rollup(600)])
    assert read({"stages": [{}, {}]}) == 450.0
    assert read({"stages": [{}] * 4}) is None  # fewer rollups than assemblies
    monkeypatch.setattr(trace, "history", lambda: [rollup(None), rollup(None)])
    assert read({"stages": [{}, {}]}) is None  # a program without the counter


@pytest.fixture
def wide_root(tiny_root) -> Path:
    add_cell(
        tiny_root, TINY_WIDE,
        {"chromosomes": [{"name": "a", "bp": 8000, "circular": False}, {"name": "b", "bp": 4000, "circular": True}],
         "k": 77, "read_len": 150, "read_batch": 256, "oneshot_rows": 2 * 256 * 74, "node_cap_factor": 1.15,
         "chips": 1},
        {"coverage": 30, "min_count": 1, "spectrum_capacity": 1 << 15},
        "tiny-k77", "tiny-exact-30x-150",
    )
    return tiny_root


def _run(root, **kw):
    return run.run_cell(TINY_WIDE, SEED, 0.0, False, device="cpu", root=root, t_start=time.perf_counter(), **kw)


def test_a_plant_shaped_cell_of_new_files_runs_and_is_correct(wide_root):
    """k = 77 on 150-base reads of a linear and a circular chromosome, in
    groups of two batches: the run agrees with the reference, and its key
    sorts are three-word sorts."""
    before = trace.totals()
    out = _run(wide_root)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] == 1
    assert all(c["value"] == 0 for c in out["checks"].values())
    grew = trace.since(before)
    assert grew["key_sorts"] > 0 and grew["key_sort_passes"] == 3 * grew["key_sorts"]
    cell = cells.load(wide_root, TINY_WIDE)
    codes = reads.host_codes(reads.make_codes(seed=SEED, device="cpu", **cell.read_params()))
    assert codes.shape[1] == 150
    assert len(reference.assemble(codes, cell.settings(), "cpu").contigs) >= 2


@pytest.mark.parametrize("fault", ["control", "altered_base", "half_batch"])
def test_a_broken_plant_shaped_path_is_not_correct(wide_root, fault):
    assemble = {
        "control": control.control_assemble,
        "altered_base": lambda codes, cfg, dev: _altered(pipeline.assemble_codes(codes, cfg, dev)),
        "half_batch": _half_batch,
    }[fault]
    out = _run(wide_root, assemble=assemble)
    assert out["correct"] is False and out["failed"] == out["attempted"] == 1
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("circular", [False, True])
@pytest.mark.parametrize("cleaning", [False, True])
def test_reference_agrees_with_the_assembler_and_its_oracle_at_k77(circular, cleaning):
    """The reference, the assembler (grouped count, in groups of two
    batches) and the oracle on 150-base reads at k = 77: error-free with a
    cutoff of 1, or with 0.8% errors, a cutoff of 2, tips and bubbles."""
    error_rate, min_count = (0.008, 2) if cleaning else (0.0, 1)
    clean = {"tip_rounds": 3, "bubble_rounds": 2} if cleaning else {"tip_rounds": 0, "bubble_rounds": 0}
    codes = simulate_read_codes(random_genome(4000, seed=7701 + circular), read_len=150, coverage=25, seed=7703,
                                error_rate=error_rate, circular=circular)
    ref = reference.assemble(codes, {"k": 77, "min_count": min_count, **clean}, "cpu")
    text = [decode_read(c) for c in codes]
    assert ref.contigs == {s.encode() for s in oracle.assemble_oracle(text, 77, min_count=min_count, **clean)}
    cfg = pipeline.AssemblyConfig(k=77, min_count=min_count, read_batch=128, read_len=150,
                                  spectrum_capacity=1 << 16, oneshot_rows=2 * 128 * 74, **clean)
    got = pipeline.assemble_codes(codes, cfg, "cpu")
    assert (got.contigs, got.n_kmers_counted, got.n_distinct_kmers) == (ref.contigs, ref.windows, ref.distinct)
    if cleaning:
        assert sum(ref.clipped) + sum(ref.popped) > 0
    assert got.trace.counters["key_sort_passes"] == 3 * got.trace.counters["key_sorts"] > 0
