"""BENCHMARK.json and the files it names: names, units, settings, the byte
function, the read generator, and what the benchmark imports."""

import ast
import json
from pathlib import Path

import pytest
import torch

from euler_bench import cells, reads, rooflines

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "euler_bench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in SPEC["workloads"]]


def test_names_and_units_use_allowed_characters():
    names = [c["name"] for c in SPEC["configs"]] + WORKLOADS
    names += [w[k] for w in SPEC["workloads"] for k in ("config", "traffic")]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [r for c in SPEC["configs"] for r in c["reduced"]]
    for name in names:
        assert cells.NAME.match(name), name
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert cells.UNIT.match(m["unit"]), m["unit"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in SPEC[group]]
        assert len(got) == len(set(got)), group


def test_every_metric_has_its_fields_and_files():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["layer"] and "\n" not in m["layer"]
        recipe = json.loads((BENCH / "metrics" / f"{m['name']}.json").read_text())
        assert recipe["kind"] in ("stage_mean", "device_idle", "kernel_roofline", "reader")
        if recipe["kind"] == "kernel_roofline":
            assert callable(getattr(rooflines, recipe["bytes"]))
        if recipe["kind"] == "reader":
            assert (BENCH / "metrics" / f"{recipe.get('reader', m['name'])}.py").is_file()
        for w in m.get("workloads", []):
            assert w in WORKLOADS


@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_cell_loads_and_reports_enough(workload):
    cell = cells.load(ROOT, workload)
    assert cell.chips == 1
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and e2e & {"assembly_s", "device_busy_s", "device_busy_s.clean"}
    assert cell.per_layer and all(m["moves"] in e2e for m in cell.per_layer)
    assert cell.traffic["why"] and len(cell.traffic["why"]) <= 200


@pytest.mark.parametrize(
    "workload, port_settings",
    [("ecoli-k31-exact-50x", "CONFIG2"), ("celegans-k41-exact-40x", "config5_cfg"), ("ecoli-k31-err-40x", "CONFIG3")],
)
def test_cell_settings_are_the_spec_rows(workload, port_settings):
    """Each cell assembles with the SPEC row's settings, field for field, as
    the port's own inputs for that row, so the cells continue the history;
    its genome is the row's size (E. coli as SPEC rounds it, C. elegans at
    WBcel235's own lengths, within 0.3% of SPEC's 100 Mbp)."""
    import dataclasses

    from tpu_euler_torch import simulate

    want = getattr(simulate, port_settings)
    want = want() if callable(want) else want
    cell = cells.load(ROOT, workload)
    assert cell.settings() == {f.name: getattr(want, f.name) for f in dataclasses.fields(want)}
    genome_bp = {"CONFIG2": simulate.CONFIG2_GENOME_BP, "config5_cfg": simulate.CONFIG5_GENOME_BP,
                 "CONFIG3": simulate.CONFIG3_GENOME_BP}[port_settings]
    coverage = {"CONFIG2": simulate.CONFIG2_COVERAGE, "config5_cfg": simulate.CONFIG5_COVERAGE,
                "CONFIG3": simulate.CONFIG3_COVERAGE}[port_settings]
    error_rate = {"CONFIG3": simulate.CONFIG3_ERROR_RATE}.get(port_settings, 0.0)
    got_bp = sum(c["bp"] for c in cell.config["chromosomes"])
    assert abs(got_bp / genome_bp - 1) < 0.003 and cell.traffic["coverage"] == coverage
    assert cell.traffic["error_rate"] == error_rate
    assert cell.settings()["spectrum_capacity"] >= got_bp


def test_celegans_is_wbcel235_chromosome_by_chromosome():
    chroms = cells.load(ROOT, "celegans-k41-exact-40x").config["chromosomes"]
    assert [c["name"] for c in chroms] == ["I", "II", "III", "IV", "V", "X", "MtDNA"]
    assert sum(c["bp"] for c in chroms) == 100_286_401
    assert [c["circular"] for c in chroms] == [False] * 6 + [True]


@pytest.mark.parametrize("k, want", [(31, 156_762_112), (41, 261_619_712)])
def test_extract_bytes_match_the_kernel_table(k, want):
    """PERF.md's kernel table, row 1: a config-2 batch of 2^18 reads of 100
    bases with its map."""
    assert rooflines.extract_fill_bytes(1 << 18, 100, k, 1 << 18) == want


def test_extract_bytes_count_reads_not_pad_rows():
    full = rooflines.extract_fill_bytes(1 << 18, 100, 31, 1 << 18)
    assert rooflines.extract_fill_bytes(3 * (1 << 18) + 5, 100, 31, 1 << 18) == 3 * full + 5 * (25 + 13 + 70 * 8)
    # a read length that is a multiple of 8: only the partial batch ships its map
    assert rooflines.extract_fill_bytes(2 * 64 + 3, 96, 31, 64) == 131 * (24 + 66 * 8) + 3 * 12


LAYOUT = [{"bp": 1500, "circular": False}, {"bp": 1200, "circular": True}, {"bp": 300, "circular": False}]


@pytest.mark.parametrize("error_rate", [0.0, 0.01])
def test_reads_repeat_for_a_seed(error_rate):
    kw = dict(chromosomes=LAYOUT, read_len=100, coverage=10, device="cpu", error_rate=error_rate)
    a = reads.make_codes(seed=2**31 + 5, **kw)
    b = reads.make_codes(seed=2**31 + 5, **kw)
    c = reads.make_codes(seed=2**31 + 6, **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == c.shape == (reads.read_count(3000, 100, 10), 100)
    assert a.dtype == torch.int8 and int(a.min()) >= 0 and int(a.max()) <= 3


def test_reads_are_windows_of_the_genome_on_either_strand():
    """Every read lies in one chromosome (over the end of a circular one,
    never over the end of a linear one), and every chromosome is read."""
    g = torch.randint(0, 4, (3000,), generator=reads._generator(9, torch.device("cpu")), dtype=torch.int8)
    text = "".join("ACGT"[x] for x in g.tolist())
    a, b = text[:1500], text[1500:2700]
    chroms = [a, b + b[:99], text[2700:]]
    codes = reads.make_codes(LAYOUT, 100, 20, 9, "cpu")
    comp = str.maketrans("ACGT", "TGCA")
    hits = [0, 0, 0]
    for row in codes.tolist():
        r = "".join("ACGT"[x] for x in row)
        r = r if any(r in c for c in chroms) else r.translate(comp)[::-1]
        (i,) = [i for i, c in enumerate(chroms) if r in c]
        hits[i] += 1
    assert min(hits) > 0 and hits[2] < hits[0]  # a 300-base linear chromosome has 201 starts


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                out.add(node.args[0].value)
    return out


def _top(names) -> set[str]:
    return {n.split(".")[0] for n in names}


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) >= 8
    for f in files:
        assert not _top(_imports(f)) & {"jax", "jaxlib", "flax", "tpu_euler"}, f


def test_the_reference_imports_nothing_of_the_assembler():
    for name in ("reference.py", "reads.py", "rooflines.py"):
        assert _top(_imports(BENCH / name)) <= {"__future__", "dataclasses", "numpy", "torch"}, name


def test_a_run_loads_no_jax():
    import subprocess
    import sys

    probe = (
        "import sys; sys.argv = ['x']; sys.path.insert(0, '.'); "
        "from euler_bench import run, control, reference, reads, devtrace, cells, rooflines; "
        "import tpu_euler_torch.pipeline.assemble; print(run.forbidden_modules())"
    )
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
