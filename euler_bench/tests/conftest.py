"""Shared pieces of the benchmark's tests.

They run on the CPU (``python -m pytest euler_bench/tests -q``), through the
assembler's plain kernels; those marked ``cuda`` need a card and skip
without one. ``tiny_root`` is a benchmark root in a temporary folder: a copy
of ``BENCHMARK.json`` and of the data files, plus a tiny cell made only of
new files.
"""

import json
import shutil
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
TINY = "tiny-k31-exact-30x"
TINY_CLEAN = "tiny-k31-err-30x"  # the same genome, reads with errors, cutoff and cleaning rounds


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips itself where there is none")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def add_cell(root: Path, name: str, config: dict, traffic: dict, config_name: str, traffic_name: str) -> None:
    """A cell made of new files and new entries under ``root`` (its
    configuration's only where it is new)."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    if config_name not in {c["name"] for c in spec["configs"]}:
        spec["configs"].append({"name": config_name, "source": "https://www.ncbi.nlm.nih.gov/nuccore/NC_001422.1",
                                "file": f"euler_bench/configs/{config_name}.json", "reduced": [], "why": "a tiny test"})
    spec["workloads"].append({"name": name, "config": config_name, "traffic": traffic_name, "chips": 1,
                              "why": "a tiny test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    (root / "euler_bench" / "configs" / f"{config_name}.json").write_text(json.dumps(config))
    (root / "euler_bench" / "traffic" / f"{traffic_name}.json").write_text(json.dumps(traffic))


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for kind in ("configs", "traffic", "metrics"):
        shutil.copytree(ROOT / "euler_bench" / kind, tmp_path / "euler_bench" / kind)
    add_cell(
        tmp_path, TINY,
        {"chromosomes": [{"name": "a", "bp": 7000, "circular": False}, {"name": "b", "bp": 5000, "circular": True}],
         "k": 31, "read_len": 100, "read_batch": 1024,
         "oneshot_rows": 192000000, "node_cap_factor": 2.0, "chips": 1},
        {"coverage": 30, "min_count": 1, "spectrum_capacity": 1 << 15},
        "tiny-k31", "tiny-exact-30x",
    )
    config = json.loads((tmp_path / "euler_bench" / "configs" / "tiny-k31.json").read_text())
    add_cell(
        tmp_path, TINY_CLEAN, config,
        {"coverage": 30, "error_rate": 0.01, "read_sets": 2, "min_count": 2, "spectrum_capacity": 1 << 18,
         "tip_rounds": 3, "tip_len": 0, "bubble_rounds": 2, "bubble_len": 0},
        "tiny-k31", "tiny-err-30x",
    )
    return tmp_path
