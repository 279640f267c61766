"""Build the package's native sources into shared libraries at first use.

Each CUDA library is compiled by ``nvcc`` for ``sm_90a`` with a plain C
interface and loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds); the FASTA/FASTQ codec (``native/fastx_codec.cpp``, host C++) is
compiled by ``g++`` the same way. Output goes to ``build/tpu_euler_torch/``
at the repository root, under a name keyed by a hash of the sources and
flags, so a changed source rebuilds and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "tpu_euler_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

CXX_FLAGS = ["-O3", "-march=x86-64-v2", "-fPIC", "-shared", "-Wall", "-pthread"]

_loaded: dict[str, ctypes.CDLL] = {}
#: per library: seconds spent compiling (0.0 when reused) and nvcc's output
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build kernels")


def _compile(
    name: str, cmd: list[str], flags: list[str], sources: list[Path], included: list[Path] = ()
) -> ctypes.CDLL:
    """Run ``cmd flags -o <out> sources`` unless the library keyed by the
    flags and the bytes of ``sources`` and ``included`` is there already;
    load it."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in [*sources, *included]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([*cmd, *flags, "-o", tmp, *map(str, sources)], capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"{cmd[0]} failed for {name}:\n{log}")
        os.replace(tmp, out)
    build_info[name] = {"path": str(out), "seconds": seconds, "log": log}
    return ctypes.CDLL(str(out))


def load(name: str, sources: list[str], headers: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Compile (if needed) and load ``csrc/<sources>`` as library ``name``.
    ``headers`` are the files of ``csrc/`` that the sources include: they
    are hashed with them, so a changed header rebuilds the library."""
    if name not in _loaded:
        _loaded[name] = _compile(
            name, [_nvcc()], NVCC_FLAGS, [CSRC / s for s in sources], [CSRC / s for s in headers]
        )
    return _loaded[name]


def load_cpp(name: str, source: Path, headers: tuple[Path, ...] = ()) -> ctypes.CDLL:
    """Compile (if needed) with ``g++`` and load one host C++ source as
    library ``name``. ``headers`` are the files the source includes: they
    are hashed with it, so a changed header rebuilds the library. Raises
    where no compiler is found or the build fails."""
    if name not in _loaded:
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            raise RuntimeError("g++ not found")
        _loaded[name] = _compile(name, [cxx], CXX_FLAGS, [source], list(headers))
    return _loaded[name]
