"""Fused extract + canonicalize + sentinel fill: the hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``tpu_euler/kmer/pallas_extract.py``
(``extract_canonical_pallas``) fused with the XLA ops around it in the
one-shot fill step (``tpu_euler/pipeline/assemble.py:make_extract_fill_step``).
The kernel is ``csrc/extract_canonical.cu``; its source note says what bounds
it on the card and how its design answers that.

``extract_fill`` takes int8 codes [R, Lmax] (the sharded mode's path);
``extract_fill_packed`` takes the feed's 2.25-bit batches (every
single-device route): packed codes [R, ceil(Lmax/4)] uint8 and an N map
[R, ceil(Lmax/8)] uint8, or None for a batch without N or padding. Its
kernel is the same one with another tile loader, which reads the packed
bytes itself: the reference's ``unpack_codes`` (``tpu_euler/kmer/extract.py``
:51, :67) is fused into it.

Each launches the kernel for CUDA tensors and runs its plain PyTorch version
(``extract_fill_plain``, ``extract_fill_packed_plain``) for CPU tensors
only. On a CUDA tensor it launches or raises; it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_euler_torch import trace
from tpu_euler_torch.kmer import keys
from tpu_euler_torch.kmer.extract import extract_canonical_kmers, unpack_codes, unpack_codes_clean


def _check_buf(R: int, Lmax: int, buf: torch.Tensor, start: int, k: int) -> int:
    """Checks ``buf`` and ``start`` for R reads of Lmax bases; returns W."""
    word_shape = keys.word_shape(k)
    if buf.dtype != torch.int64 or tuple(buf.shape[1:]) != word_shape:
        raise TypeError(
            f"buf must be int64 {list(('N',) + word_shape)} at k = {k}, "
            f"got {buf.dtype} {tuple(buf.shape)}"
        )
    if not buf.is_contiguous():
        raise ValueError("buf must be contiguous")
    W = Lmax - k + 1
    if W < 1:
        raise ValueError(f"read length {Lmax} < k = {k}")
    if start < 0 or start + R * W > buf.shape[0]:
        raise ValueError(
            f"window rows [{start}, {start + R * W}) exceed buf of {buf.shape[0]}"
        )
    return W


def _check(codes: torch.Tensor, buf: torch.Tensor, start: int, k: int) -> int:
    keys.check_k(k)
    if codes.dtype != torch.int8 or codes.dim() != 2:
        raise TypeError(f"codes must be a 2-D int8 tensor, got {codes.dtype} {tuple(codes.shape)}")
    if codes.device != buf.device:
        raise ValueError(f"codes on {codes.device} but buf on {buf.device}")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")
    return _check_buf(*codes.shape, buf, start, k)


def extract_fill_plain(
    codes: torch.Tensor, buf: torch.Tensor, start: int, k: int
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device.

    Writes ``buf[start : start + R*W]`` = canonical key of each window (the
    sentinel ``keys.SENT``, in every word, where the window holds a code 4)
    and returns the number of valid windows as a 0-d int64 tensor. ``buf`` is
    [N] for k <= 31 and [N, W] (W = ``keys.nwords(k)``) for k > 31.
    """
    W = _check(codes, buf, start, k)
    words, valid = extract_canonical_kmers(codes, k)
    buf[start : start + codes.shape[0] * W] = keys.select(valid, words, keys.SENT)
    return valid.sum(dtype=torch.int64)


def _check_packed(packed: torch.Tensor, nmask, buf: torch.Tensor, start: int, k: int, read_len: int) -> None:
    keys.check_k(k)
    R = packed.shape[0]
    for name, x, width in (("packed", packed, -(-read_len // 4)), ("nmask", nmask, -(-read_len // 8))):
        if x is None and name == "nmask":
            continue
        if x.dtype != torch.uint8 or x.dim() != 2 or tuple(x.shape) != (R, width):
            raise TypeError(
                f"{name} must be a uint8 [{R}, {width}] tensor at read length {read_len}, "
                f"got {x.dtype} {tuple(x.shape)}"
            )
        if x.device != buf.device:
            raise ValueError(f"{name} on {x.device} but buf on {buf.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _check_buf(R, read_len, buf, start, k)


def extract_fill_packed_plain(
    packed: torch.Tensor, nmask, buf: torch.Tensor, start: int, k: int, read_len: int
) -> torch.Tensor:
    """Plain PyTorch version of the packed kernel, on any device:
    ``unpack_codes`` (or ``unpack_codes_clean`` where ``nmask`` is None),
    then ``extract_fill_plain``. Same contract and return."""
    _check_packed(packed, nmask, buf, start, k, read_len)
    codes = unpack_codes_clean(packed, read_len) if nmask is None else unpack_codes(packed, nmask, read_len)
    return extract_fill_plain(codes, buf, start, k)


_ARGS = {
    "extract_canonical_fill": [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ],
    "extract_canonical_fill_packed": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ],
}


def _lib(name: str = "extract_canonical_fill"):
    from tpu_euler_torch import _build

    lib = _build.load("extract_canonical", ["extract_canonical.cu"], headers=("kmer_tile.cuh",))
    fn = getattr(lib, name)
    fn.argtypes = _ARGS[name]
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Compile and load the kernel now (it is otherwise built at first use)."""
    _lib()


def extract_fill(
    codes: torch.Tensor, buf: torch.Tensor, start: int, k: int
) -> torch.Tensor:
    """Same contract as ``extract_fill_plain``; launches the CUDA kernel for
    CUDA tensors. The count is accumulated on the device (no sync)."""
    _check(codes, buf, start, k)
    if codes.device.type == "cpu":
        return extract_fill_plain(codes, buf, start, k)
    if codes.device.type != "cuda":
        raise ValueError(f"no kernel for device {codes.device}")
    R, Lmax = codes.shape
    fn = _lib("extract_canonical_fill")
    n_valid = torch.zeros((), dtype=torch.int64, device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            codes.data_ptr(), R, Lmax, k, buf.data_ptr(), start,
            n_valid.data_ptr(), stream,
        )
    _raise_on(err, "extract_canonical_fill", Lmax)
    trace.add("extract_int8_launches")
    return n_valid


def _raise_on(err: int, name: str, Lmax: int) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {err}"
            + (f" (reads of {Lmax} bases may exceed the kernel's shared-memory tile)" if err == 1 else "")
        )


def extract_fill_packed(
    packed: torch.Tensor, nmask, buf: torch.Tensor, start: int, k: int, read_len: int
) -> torch.Tensor:
    """Same contract as ``extract_fill_packed_plain``; launches the CUDA
    kernel's packed loader for CUDA tensors. The count is accumulated on the
    device (no sync)."""
    _check_packed(packed, nmask, buf, start, k, read_len)
    if packed.device.type == "cpu":
        return extract_fill_packed_plain(packed, nmask, buf, start, k, read_len)
    if packed.device.type != "cuda":
        raise ValueError(f"no kernel for device {packed.device}")
    fn = _lib("extract_canonical_fill_packed")
    n_valid = torch.zeros((), dtype=torch.int64, device=packed.device)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            packed.data_ptr(), None if nmask is None else nmask.data_ptr(), packed.shape[0], read_len, k,
            buf.data_ptr(), start, n_valid.data_ptr(), stream,
        )
    _raise_on(err, "extract_canonical_fill_packed", read_len)
    trace.add("extract_launches")
    return n_valid
