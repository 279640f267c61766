"""The canonical contig bytes of the device emission: a hand-written CUDA kernel.

Replaces no TPU kernel. It replaces the reference's numpy tail of the
device emission (``tpu_euler/euler/extract.py:306`` ``_emission_to_contigs``
and ``:48`` ``canonicalize_contig_buffer``): from the code buffer that
``extract.emit_chains_device`` scatters, the contigs' offsets and each
contig's start edge key, it makes on the card the buffer the host then only
cuts into ``bytes`` objects (``csrc/emit_canonical.cu``; its source note
says what bounds it and what the design does about that).

``canonical_bytes`` returns one uint8 tensor: ``header_words(n)`` int64
words (the n + 1 offsets; the count of contigs whose first
``PREFIX_WINDOW`` positions are their own mirror and that the kernel's
second pass decided; for each contig, the index of its twin where the
caller names one, the twin is lower and its canonical bytes are the same,
else -1), then each contig's canonical ASCII bytes (the smaller of its
sequence and its reverse complement, byte for byte; forward where they are
equal) at its offset. ``split`` cuts such a buffer, on the host, into the
offsets, the count, the repeats and the bytes. The twins are the doubled
edge array's two strands: each contig is emitted from both, and the host
copies out and hashes each once.

The wrapper launches the kernel for CUDA tensors and runs its plain PyTorch
version (``canonical_bytes_plain``) for CPU tensors only; any other device
raises. On a CUDA tensor it launches or raises; it never falls back.
``trace``'s ``emit_canonical_launches`` counts the kernel's launches (three
a call: decide, resolve, write).
"""

from __future__ import annotations

import ctypes

import torch

from tpu_euler_torch import trace
from tpu_euler_torch.kmer import keys

#: positions of each contig that the decide pass compares with their mirrors
#: (``kPrefixWindow`` in ``csrc/emit_canonical.cuh``); a longer contig whose
#: window is its own mirror goes to the second pass
PREFIX_WINDOW = 64
LAUNCHES = 3  # a call's kernel launches

_ASCII = torch.tensor(list(b"ACGT"), dtype=torch.uint8)


def header_words(n: int) -> int:
    """int64 words before the bytes: n + 1 offsets, the count and n
    repeats, an even number, so the bytes start 16-byte aligned."""
    return 2 * n + 2


def _check(codes, chain_off, start_words, n: int, total: int, k: int, twin=None) -> torch.device:
    keys.check_k(k)
    W = keys.nwords(k)
    if codes.dtype != torch.uint8 or codes.dim() != 1 or not codes.is_contiguous():
        raise TypeError(f"codes must be a contiguous 1-D uint8 tensor, got {codes.dtype} {tuple(codes.shape)}")
    if chain_off.dtype != torch.int64 or chain_off.dim() != 1 or not chain_off.is_contiguous():
        raise TypeError("chain_off must be a contiguous 1-D int64 tensor")
    want = 1 if W == 1 else 2
    if (start_words.dtype != torch.int64 or start_words.dim() != want or not start_words.is_contiguous()
            or (W > 1 and start_words.shape[1] != W)):
        raise TypeError(f"start_words must be contiguous int64 keys of k = {k} ({W} words)")
    if n < 1 or total < 1 or codes.shape[0] < total or chain_off.shape[0] < n or start_words.shape[0] < n:
        raise ValueError(f"need n >= 1 contigs and total >= 1 bytes within the inputs: n={n}, total={total}")
    if twin is not None and (twin.dtype != torch.int64 or twin.dim() != 1 or not twin.is_contiguous()
                             or twin.shape[0] < n or twin.device != codes.device):
        raise TypeError("twin must be a contiguous 1-D int64 tensor of n or more contigs beside codes")
    if not codes.device == chain_off.device == start_words.device:
        raise ValueError("codes, chain_off and start_words must lie on one device")
    return codes.device


def canonical_bytes_plain(codes, chain_off, start_words, n: int, total: int, k: int, twin=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: the same buffer,
    from per-byte tensors (a contig id, a mirror index and an int64 code for
    every base)."""
    _check(codes, chain_off, start_words, n, total, k, twin)
    dev = codes.device
    off = chain_off[:n]
    ends = torch.cat([off[1:], torch.tensor([total], device=dev)])
    lens = ends - off
    cid = torch.repeat_interleave(torch.arange(n, device=dev), lens)
    p = torch.arange(total, device=dev)
    # stitch the (k-1)-base prefix: base i lies up = k-1-i bases above the key's last base
    up = k - 1 - torch.arange(k - 1, device=dev)
    sw = start_words[:n].reshape(n, -1)
    pref = (sw[:, sw.shape[1] - 1 - up // keys.LO_BASES] >> (2 * (up % keys.LO_BASES))) & 3
    code = codes[:total].to(torch.int64)
    slots = off[:, None] + torch.arange(k - 1, device=dev)
    inside = slots < ends[:, None]
    code[slots[inside]] = pref[inside]
    comp = 3 - code[off[cid] + ends[cid] - 1 - p]  # comp[p]: the reverse complement's code at p
    # each contig's first mismatch with its mirror (its end where none)
    neq = torch.cat([torch.nonzero(code != comp).squeeze(1), torch.tensor([total], device=dev)])
    first = torch.minimum(neq[torch.searchsorted(neq, off)], ends)
    has = first < ends
    fc = torch.clamp(first, max=total - 1)
    take_rc = has & (comp[fc] < code[fc])
    pending = (first - off >= PREFIX_WINDOW) & ((lens + 1) // 2 > PREFIX_WINDOW)
    body = _ASCII.to(dev)[torch.where(take_rc[cid], comp, code)]
    # a twin repeats a contig where it is lower, as long, and byte for byte the same
    rep = torch.full((n,), -1, dtype=torch.int64, device=dev)
    if twin is not None:
        t = twin[:n]
        tc = torch.clamp(t, 0, n - 1)
        rep = torch.where((t >= 0) & (t < torch.arange(n, device=dev)) & (lens[tc] == lens), t, -1)
        at = rep[cid]
        mine = at >= 0
        twin_p = off[torch.clamp(at, min=0)] + p - off[cid]
        differs = torch.zeros(n, dtype=torch.bool, device=dev)
        differs[cid[mine & (body != body[torch.where(mine, twin_p, p)])]] = True
        rep = torch.where(differs, -1, rep)
    head = torch.cat([off, torch.tensor([total], device=dev), pending.sum().reshape(1), rep])
    return torch.cat([head.view(torch.uint8), body])


def split(buf, n: int) -> tuple[list[int], int, list[int], memoryview]:
    """A buffer of ``canonical_bytes`` on the host (a tensor or numpy array)
    -> (the n + 1 offsets, the second pass's count, the n repeats, a
    memoryview of the bytes)."""
    arr = buf.numpy() if isinstance(buf, torch.Tensor) else buf
    h = 8 * header_words(n)
    head = arr[:h].view("<i8")
    return head[: n + 1].tolist(), int(head[n + 1]), head[n + 2 :].tolist(), memoryview(arr)[h:]


def contig_set(buf, n: int) -> tuple[set[bytes], int]:
    """The contig set of a buffer of ``canonical_bytes`` on the host, each
    contig that repeats a lower one left out, and the second pass's count."""
    off, mirrored, rep, body = split(buf, n)
    return {bytes(body[off[c] : off[c + 1]]) for c in range(n) if rep[c] < 0}, mirrored


_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def _lib():
    from tpu_euler_torch import _build

    lib = _build.load("emit_canonical", ["emit_canonical.cu"], headers=("emit_canonical.cuh",))
    fn = lib.emit_canonical_bytes
    fn.argtypes = _ARGS
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Compile and load the kernel now (it is otherwise built at first use)."""
    _lib()


def canonical_bytes(codes, chain_off, start_words, n: int, total: int, k: int, twin=None) -> torch.Tensor:
    """The canonical contig buffer (header and bytes, as the module says) of
    ``n`` contigs over ``total`` bytes: ``codes`` [>= total] uint8 base codes
    at the contigs' positions (a contig's first k - 1 slots are not read),
    ``chain_off`` [>= n] int64 ascending offsets (the first 0), ``start_words``
    [>= n] (or [>= n, W]) int64 start edge keys, whose first k - 1 bases are
    each contig's prefix, ``twin`` [>= n] int64 the contig that may repeat
    each (-1 for none), or None. On the card three launches of the kernel
    into a fresh buffer, with no host read; on the CPU the plain version."""
    dev = _check(codes, chain_off, start_words, n, total, k, twin)
    if dev.type == "cpu":
        return canonical_bytes_plain(codes, chain_off, start_words, n, total, k, twin)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    h = 8 * header_words(n)
    buf = torch.empty(h + total, dtype=torch.uint8, device=dev)
    state = torch.zeros(2 * n + 1, dtype=torch.int64, device=dev)
    head = buf[:h]
    fn = _lib()
    with torch.cuda.device(dev):
        err = fn(codes.data_ptr(), chain_off.data_ptr(), start_words.data_ptr(),
                 None if twin is None else twin.data_ptr(), buf[h:].data_ptr(), head.data_ptr(),
                 state.data_ptr(), n, total, k, keys.nwords(k),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"emit_canonical_bytes launch failed: CUDA error {err}")
    trace.add("emit_canonical_launches", LAUNCHES)
    return buf
