"""Settings for the port's parity tests.

One torch thread per test process: the suite runs under several pytest-xdist
workers, and torch's default of one thread per core would oversubscribe the
machine. This file imports no JAX, so the CUDA tests can run where JAX is
absent (``--confcutdir=tests/torch_port`` keeps ``tests/conftest.py`` out).

It also builds the reference's native codec (``native/libfastx_codec.so``)
once, before any module of ``tests/unit`` is imported (pytest collects this
directory first). The reference builds it at first use with ``make``, which
writes the library in place; workers that load it at once could find it half
written, and such a worker skips every codec test for the rest of its life.
Here each worker runs the same ``make`` under one file lock, so every worker
finds the library whole and only loads it.
"""

import fcntl
import hashlib
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

torch.set_num_threads(1)

NATIVE = Path(__file__).resolve().parents[2] / "native"


def build_reference_codec() -> None:
    """``make -C native -s`` under an exclusive lock (a file in the system
    temp directory, named by the tree); nothing where make or g++ is missing.
    A failed build is left for the reference's own load to report."""
    if shutil.which("make") is None or shutil.which("g++") is None:
        return
    name = hashlib.sha256(str(NATIVE).encode()).hexdigest()[:16]
    with open(Path(tempfile.gettempdir()) / f"tpu_euler_native_{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run(["make", "-C", str(NATIVE), "-s"], capture_output=True, timeout=300)


build_reference_codec()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips itself where there is none"
    )
