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
assert len(names) >= 18, names
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
