"""ctypes bindings of the native FASTA/FASTQ codec (native/fastx_codec.cpp).

Counterpart of ``tpu_euler/io/native.py``. The codec parses and encodes a
plain file straight into the int8 code matrix, whole or by byte-range shard,
and packs a code batch at 2.25 bits a base (``pack_codes_native``). Its
source is the reference's, read where it lies; the library is built with
``g++`` at first use into ``build/tpu_euler_torch/`` (``_build.load_cpp``).
Every entry point returns None where the codec cannot serve (no compiler, a
gzip file, an unknown extension), and the caller then takes the Python
parser (``io/fastx.py``), which cuts shards at the same records.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from pathlib import Path

import numpy as np

from tpu_euler_torch import _build

log = logging.getLogger("tpu_euler_torch")

SOURCE = Path(__file__).resolve().parents[2] / "native" / "fastx_codec.cpp"

_lock = threading.Lock()
_lib = None
_tried = False

_I64P = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {  # name: (restype, argtypes)
    "fq_scan": (ctypes.c_int, [ctypes.c_char_p, _I64P, _I64P]),
    "fa_scan": (ctypes.c_int, [ctypes.c_char_p, _I64P, _I64P]),
    "fq_encode": (
        ctypes.c_int64,
        [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int8, ctypes.c_int32],
    ),
    "fa_encode": (
        ctypes.c_int64,
        [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32],
    ),
    "fq_scan_range": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, _I64P, _I64P]),
    "fa_scan_range": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, _I64P, _I64P]),
    "fq_encode_range": (
        ctypes.c_int64,
        [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int8, ctypes.c_int32,
        ],
    ),
    "fa_encode_range": (
        ctypes.c_int64,
        [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
        ],
    ),
    "pack_codes": (
        None,
        [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32],
    ),
}


def _load():
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                lib = _build.load_cpp("fastx_codec", SOURCE)
                for name, (restype, argtypes) in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.restype, fn.argtypes = restype, argtypes
                _lib = lib
            except Exception as e:
                log.info("native fastx codec unavailable (%s); using the Python parser", e)
        return _lib


def native_available() -> bool:
    return _load() is not None


def _kind(path: str) -> str | None:
    """'fq' or 'fa' for a plain file the codec takes, else None."""
    if path.endswith((".fq", ".fastq")):
        return "fq"
    if path.endswith((".fa", ".fasta", ".fna")):
        return "fa"
    return None


def _encode(lib, kind, path, span, n, rl, min_qual, min_len_keep) -> np.ndarray | None:
    """Run the codec's encode over the whole file (``span`` = ()) or a byte
    range (``span`` = (begin, end)) into an [n, rl] matrix."""
    out = np.empty((n, rl), dtype=np.int8)
    fn = getattr(lib, f"{kind}_encode" + ("_range" if span else ""))
    tail = (min_qual, min_len_keep) if kind == "fq" else (min_len_keep,)
    r = fn(path.encode(), *span, out.ctypes.data, n, rl, *tail)
    return None if r < 0 else out[:r]


def encode_file_native(
    path: str, read_len: int = 0, min_qual: int = 0, min_len_keep: int = 1
) -> np.ndarray | None:
    """Parse and encode a plain FASTA/FASTQ file into an [R, read_len] int8
    matrix (``read_len`` 0 = the file's longest read). None where the codec
    cannot serve: the caller takes the Python parser."""
    lib, kind = _load(), _kind(path)
    if lib is None or kind is None:
        return None
    n, mx = ctypes.c_int64(), ctypes.c_int64()
    scan = getattr(lib, f"{kind}_scan")
    if scan(path.encode(), ctypes.byref(n), ctypes.byref(mx)) != 0 or n.value == 0:
        return None
    return _encode(lib, kind, path, (), n.value, read_len or int(mx.value), min_qual, min_len_keep)


def encode_file_shard_native(
    path: str, shard: int, num_shards: int, read_len: int = 0, min_qual: int = 0, min_len_keep: int = 1
) -> np.ndarray | None:
    """Parse and encode byte-range shard i of n of a plain FASTA/FASTQ file.
    The range is moved to record starts in native code, by the rule of
    ``io.fastx.read_shard``. Pass ``read_len`` where shards must agree on the
    row width: a shard's longest read is its own."""
    lib, kind = _load(), _kind(path)
    if lib is None or kind is None:
        return None
    size = os.path.getsize(path)
    span = (size * shard // num_shards, size * (shard + 1) // num_shards)
    n, mx = ctypes.c_int64(), ctypes.c_int64()
    scan = getattr(lib, f"{kind}_scan_range")
    if scan(path.encode(), *span, ctypes.byref(n), ctypes.byref(mx)) != 0:
        return None
    rl = read_len or int(mx.value)
    if n.value == 0 or rl == 0:
        return np.empty((0, max(rl, 1)), dtype=np.int8)
    return _encode(lib, kind, path, span, n.value, rl, min_qual, min_len_keep)


def pack_codes_native(
    codes: np.ndarray, n_threads: int = 0, out=None
) -> tuple[np.ndarray, np.ndarray] | None:
    """The codec's threaded 2.25-bit pack of an [R, L] int8 code matrix,
    bit for bit ``encode.pack_codes_np``'s (packed [R, ceil(L/4)], nmask
    [R, ceil(L/8)], both uint8). ``out``: (packed, nmask) C-contiguous
    uint8 arrays of those shapes to write into (pinned staging memory in the
    feed), returned. None where the codec cannot serve."""
    lib = _load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    R, L = codes.shape
    shapes = ((R, -(-L // 4)), (R, -(-L // 8)))
    if out is None:
        out = tuple(np.empty(s, dtype=np.uint8) for s in shapes)
    for a, s in zip(out, shapes):
        if a.dtype != np.uint8 or a.shape != s or not a.flags.c_contiguous:
            raise ValueError(f"pack_codes_native: out must be C-contiguous uint8 {s}, got {a.dtype} {a.shape}")
    if n_threads <= 0:
        n_threads = min(16, os.cpu_count() or 1)
    lib.pack_codes(codes.ctypes.data, R, L, out[0].ctypes.data, out[1].ctypes.data, n_threads)
    return out
