"""Fused extract + canonicalize + sentinel fill: the hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``tpu_euler/kmer/pallas_extract.py``
(``extract_canonical_pallas``) fused with the XLA ops around it in the
one-shot fill step (``tpu_euler/pipeline/assemble.py:make_extract_fill_step``).
The kernel is ``csrc/extract_canonical.cu``; its source note says what bounds
it on the card and how its design answers that.

``extract_fill`` launches the kernel for CUDA tensors and runs the plain
PyTorch version (``extract_fill_plain``) for CPU tensors only. On a CUDA
tensor it launches or raises; it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_euler_torch.kmer import keys
from tpu_euler_torch.kmer.extract import extract_canonical_kmers

#: kernel launches made by ``extract_fill`` (reset freely by callers)
launches = 0


def _check(codes: torch.Tensor, buf: torch.Tensor, start: int, k: int) -> int:
    keys.check_k(k)
    if codes.dtype != torch.int8 or codes.dim() != 2:
        raise TypeError(f"codes must be a 2-D int8 tensor, got {codes.dtype} {tuple(codes.shape)}")
    word_shape = keys.word_shape(k)
    if buf.dtype != torch.int64 or tuple(buf.shape[1:]) != word_shape:
        raise TypeError(
            f"buf must be int64 {list(('N',) + word_shape)} at k = {k}, "
            f"got {buf.dtype} {tuple(buf.shape)}"
        )
    if codes.device != buf.device:
        raise ValueError(f"codes on {codes.device} but buf on {buf.device}")
    if not (codes.is_contiguous() and buf.is_contiguous()):
        raise ValueError("codes and buf must be contiguous")
    R, Lmax = codes.shape
    W = Lmax - k + 1
    if W < 1:
        raise ValueError(f"read length {Lmax} < k = {k}")
    if start < 0 or start + R * W > buf.shape[0]:
        raise ValueError(
            f"window rows [{start}, {start + R * W}) exceed buf of {buf.shape[0]}"
        )
    return W


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


def _lib():
    from tpu_euler_torch import _build

    lib = _build.load("extract_canonical", ["extract_canonical.cu"], headers=("kmer_tile.cuh",))
    fn = lib.extract_canonical_fill
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ]
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
    global launches
    _check(codes, buf, start, k)
    if codes.device.type == "cpu":
        return extract_fill_plain(codes, buf, start, k)
    if codes.device.type != "cuda":
        raise ValueError(f"no kernel for device {codes.device}")
    R, Lmax = codes.shape
    fn = _lib()
    n_valid = torch.zeros((), dtype=torch.int64, device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            codes.data_ptr(), R, Lmax, k, buf.data_ptr(), start,
            n_valid.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"extract_canonical_fill launch failed: CUDA error {err}"
            + (f" (reads of {Lmax} bases may exceed the kernel's shared-memory tile)" if err == 1 else "")
        )
    launches += 1
    return n_valid
