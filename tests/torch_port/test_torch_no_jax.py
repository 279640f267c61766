"""The port never imports JAX, nor the reference package ``tpu_euler``: the
machine with the card has no JAX, and the port must run there alone."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

PROBE = """
import importlib, pkgutil, sys
import tpu_euler_torch
names = [m.name for m in pkgutil.walk_packages(tpu_euler_torch.__path__, "tpu_euler_torch.")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 40, names
for needed in ("cli", "io.fastx", "io.encode", "io.native", "euler.clean", "euler.tour", "euler.ranking_kernel",
               "graph.validate", "pipeline.checkpoint", "verify.compare",
               "dist.mesh", "dist.exchange", "dist.count_dist", "dist.pipeline", "dist.launch",
               "dist.traverse_dist", "entry", "fuzz", "bench_scaling", "profile_config2",
               "bench_tour", "microbench", "bench"):
    assert "tpu_euler_torch." + needed in names, needed
bad = sorted(
    m for m in sys.modules
    if m in ("jax", "tpu_euler") or m.startswith(("jax.", "jaxlib", "tpu_euler."))
)
assert not bad, bad
print("ok", len(names))
"""


def test_port_imports_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


CLI_PROBE = """
import sys, tempfile, os
from tpu_euler_torch import cli
from tpu_euler_torch.simulate import random_genome, simulate_reads
d = tempfile.mkdtemp()
reads = simulate_reads(random_genome(800, seed=1), 80, 15, seed=2, error_rate=0.004)
with open(os.path.join(d, "r.fq"), "w") as f:
    for i, r in enumerate(reads):
        f.write(f"@r{i}\\n{r}\\n+\\n{'I' * len(r)}\\n")
common = ["-k", "21", "--device", "cpu"]
assert cli.main(["assemble", os.path.join(d, "r.fq"), "-o", os.path.join(d, "c.fa"), "--min-count", "3",
                 "--tip-rounds", "2", "--bubble-rounds", "1", "--save-graph", os.path.join(d, "g.npz")] + common) == 0
assert cli.main(["assemble", "-", "-o", os.path.join(d, "d.fa"), "--resume-graph", os.path.join(d, "g.npz")] + common) == 0
assert cli.main(["tour", os.path.join(d, "r.fq"), "--min-count", "3"] + common) == 0
from tpu_euler_torch.config import AssemblyConfig
from tpu_euler_torch.dist.mesh import LoopbackComm
from tpu_euler_torch.dist.pipeline import assemble_reads_distributed
cfg = AssemblyConfig(k=21, read_batch=64, read_len=80, spectrum_capacity=1 << 13)
assert assemble_reads_distributed(reads, cfg, LoopbackComm(4, "cpu")).contigs
cfg = AssemblyConfig(k=21, min_count=3, tip_rounds=2, bubble_rounds=1, read_batch=64, read_len=80, spectrum_capacity=1 << 13)
assert assemble_reads_distributed(reads, cfg, LoopbackComm(4, "cpu"), shard_traversal=True).contigs
bad = sorted(
    m for m in sys.modules
    if m in ("jax", "tpu_euler") or m.startswith(("jax.", "jaxlib", "tpu_euler."))
)
assert not bad, bad
print("ok")
"""


def test_cli_runs_without_jax():
    """assemble (with cleaning and a graph checkpoint), a resume, tour and
    sharded assemblies over the loopback (replicated and sharded traversal)
    in one process that must end with neither package imported."""
    out = subprocess.run(
        [sys.executable, "-c", CLI_PROBE], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_port_sources_name_no_jax_import():
    """No module of the port, nor chip_smoke.py or bench_torch.py, imports
    jax or tpu_euler, lazily or not: read from the sources."""
    for path in [*sorted((ROOT / "tpu_euler_torch").rglob("*.py")), ROOT / "chip_smoke.py", ROOT / "bench_torch.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "tpu_euler"), (path, name)


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py imports lazily inside its phases, so read its imports
    from the source: the stdlib, torch, numpy and tpu_euler_torch only."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert "tpu_euler_torch" in roots
    assert not roots & {"jax", "jaxlib", "tpu_euler"}, roots
    assert roots - set(sys.stdlib_module_names) <= {"torch", "numpy", "tpu_euler_torch"}, roots
