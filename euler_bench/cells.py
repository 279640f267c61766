"""The benchmark's cells, found by name.

``BENCHMARK.json`` at the checkout's root lists the configurations, the
cells and the metrics. Everything that belongs to one of them sits in a file
of its own under ``euler_bench/``:

- a configuration (a deployment: the genome's chromosomes, k, batch, chips)
  in the file its ``BENCHMARK.json`` entry names, ``configs/<name>.json``;
- a traffic mix (coverage, errors, and the assembler settings that follow
  from the reads) in ``traffic/<name>.json``;
- a per-layer metric's reading recipe in ``metrics/<name>.json``, and, where
  its ``kind`` is ``reader``, a ``metrics/<name>.py`` with ``read(ctx)``.

So a cell, a mix or a metric is added by adding files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")

# the assembler's settings (``AssemblyConfig`` fields) each file kind gives
CONFIG_SETTINGS = ("k", "read_len", "read_batch", "oneshot_rows", "node_cap_factor")
TRAFFIC_SETTINGS = ("min_count", "spectrum_capacity", "tip_rounds", "tip_len", "bubble_rounds", "bubble_len")
TRAFFIC_DEFAULTS = {"tip_rounds": 0, "tip_len": 0, "bubble_rounds": 0, "bubble_len": 0}


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]  # BENCHMARK.json entries this cell reports with --trace 0
    per_layer: list[dict]  # ... with --trace 1, each with its file's recipe under "recipe"
    bench: Path  # the euler_bench folder the files were found in

    def settings(self) -> dict:
        """Keyword arguments of the assembler's ``AssemblyConfig``."""
        out = {key: self.config[key] for key in CONFIG_SETTINGS}
        for key in TRAFFIC_SETTINGS:
            out[key] = self.traffic.get(key, TRAFFIC_DEFAULTS.get(key))
            if out[key] is None:
                raise KeyError(f"traffic mix {self.traffic['name']!r} lacks {key!r}")
        return out

    @property
    def read_sets(self) -> int:
        """Read sets a run makes and assembles in turn (the mix's
        ``read_sets``, 1 where it has none)."""
        return int(self.traffic.get("read_sets", 1))

    def read_params(self) -> dict:
        """Keyword arguments of ``reads.make_codes`` (all but the seed and
        the device)."""
        return {
            "chromosomes": self.config["chromosomes"],
            "read_len": self.config["read_len"],
            "coverage": self.traffic["coverage"],
            "error_rate": self.traffic.get("error_rate", 0.0),
        }


def checked_name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    return name


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def reports(metric: dict, workload: str) -> bool:
    """Whether a cell reports a metric: every cell, unless the metric lists
    its cells."""
    return workload in metric.get("workloads", [workload])


def load(root, workload: str) -> Cell:
    """Cell ``workload`` of ``<root>/BENCHMARK.json``, its files read from
    ``<root>/euler_bench/``."""
    root = Path(root)
    spec = _json(root / "BENCHMARK.json")
    bench = root / "euler_bench"
    (entry,) = [w for w in spec["workloads"] if w["name"] == checked_name(workload)] or [None]
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    (cfg_entry,) = [c for c in spec["configs"] if c["name"] == entry["config"]]
    config = {**_json(root / cfg_entry["file"]), "name": cfg_entry["name"]}
    traffic = {**_json(bench / "traffic" / f"{checked_name(entry['traffic'])}.json"), "name": entry["traffic"]}
    per_layer = []
    for m in spec["per_layer"]:
        if reports(m, workload):
            per_layer.append({**m, "recipe": _json(bench / "metrics" / f"{checked_name(m['name'])}.json")})
    return Cell(
        name=workload,
        chips=entry["chips"],
        config=config,
        traffic=traffic,
        end_to_end=[m for m in spec["end_to_end"] if reports(m, workload)],
        per_layer=per_layer,
        bench=bench,
    )


def load_reader(bench: Path, name: str):
    """``read`` of ``metrics/<name>.py``: a per-layer metric's own reader."""
    path = bench / "metrics" / f"{checked_name(name)}.py"
    spec = importlib.util.spec_from_file_location(f"euler_bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
