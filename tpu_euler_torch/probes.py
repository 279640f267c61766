"""The five TPU compiler probes of ``scripts/debug_pallas{2..6}.py`` on the card.

    python -m tpu_euler_torch.probes [--device cuda|cpu]

Each script ran one Pallas kernel on the TPU that isolated a pack or shift
operation of the extract kernel and checked it against numpy. Here each
probe has three parts: a wrapper that launches its CUDA kernel from
``csrc/probes.cu`` (built at first use, like the extract kernel), a plain
PyTorch version, and the script's own numpy expectation (``expect_*``).
``run_all`` runs every probe at the script's shape and seed through its
wrapper and raises on any mismatch with the expectation.

| probe              | script (Pallas kernel)            | output                                   |
|--------------------|-----------------------------------|------------------------------------------|
| ``lane_slices``    | ``debug_pallas2.py:33`` ``probe`` | ``codes[:, i:i+W]``, i < 8: int32 [8, R, W] |
| ``extract_stages`` | ``debug_pallas3.py:44`` ``probe`` | forward key, reverse complement, canonical key of every window: int64 [3, R*W] (or [3, R*W, 2] for k > 31) |
| ``shift_terms``    | ``debug_pallas4.py:59`` ``probe`` | limb-0 terms i = 4, 5, 8 and their OR, SUM and int32-OR accumulations: [6, R, W] |
| ``u32_shifts``     | ``debug_pallas5.py:45`` ``probe`` | ``x << s``, ``x >> s``, ``x * 2^s`` of uint32 x: [23, R, C] |
| ``hoisted_and_roll`` | ``debug_pallas6.py:51`` ``probe`` | hoisted-mask slices ``<< 20``, ``<< 18``; OR, roll-OR and roll-Horner limb-0 accumulations: [5, R, W] |

uint32 results are int32 tensors holding the same 32 bits (torch has no
uint32 shifts on the CPU): the plain versions compute in int64 and keep the
low 32 bits. ``extract_stages`` uses the port's key layer (``kmer/keys.py``),
so at k = 41 it runs the two-word keys.

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises, and counts the launch in ``launches``.
Importing this module does no work.
"""

from __future__ import annotations

import argparse
import ctypes
import sys

import numpy as np
import torch

from tpu_euler_torch.kmer import keys
from tpu_euler_torch.kmer.extract import extract_kmers

#: kernel launches per probe (reset freely by callers)
launches = {
    "lane_slices": 0,
    "extract_stages": 0,
    "shift_terms": 0,
    "u32_shifts": 0,
    "hoisted_and_roll": 0,
}

# the scripts' shapes and constants
R, LMAX, K31 = 512, 100, 31
W31 = LMAX - K31 + 1  # 70 windows per read at k = 31
N_OFFSETS = 8  # debug_pallas2.NI
LIMB0_BASES = 15  # bases 0..14 fill limb 0 of a k = 31 key
U32_COLS = 128  # debug_pallas5.C
LS = RS = (2, 8, 14, 16, 18, 20, 22, 26, 30)
MS = (14, 16, 18, 20, 22)
_M32 = 0xFFFFFFFF

_ARGTYPES = {
    "lane_slices": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int],
    "extract_stages": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int],
    "shift_terms": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int],
    "u32_shifts": [ctypes.c_void_p, ctypes.c_longlong],
    "hoisted_and_roll": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int],
}


def _lib():
    from tpu_euler_torch import _build

    lib = _build.load("probes", ["probes.cu"], headers=("kmer_tile.cuh",))
    for name, args in _ARGTYPES.items():
        fn = getattr(lib, "probe_" + name)
        fn.argtypes = args + [ctypes.c_void_p, ctypes.c_void_p]  # out, stream
        fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile and load the kernels now (they are otherwise built at first use)."""
    _lib()


def _launch(name: str, x: torch.Tensor, out: torch.Tensor, *args) -> torch.Tensor:
    """Launch probe ``name`` on CUDA tensors (``x`` in, ``out`` allocated)."""
    fn = getattr(_lib(), "probe_" + name)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), *args, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe_{name} launch failed: CUDA error {err}")
    launches[name] += 1
    return out


def _route(x: torch.Tensor) -> bool:
    """True: launch the kernel (CUDA tensor); False: plain version (CPU)."""
    if not x.is_contiguous():
        raise ValueError("probe inputs must be contiguous")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return True


def _check_codes(codes: torch.Tensor, W: int, reach: int) -> tuple[int, int]:
    """R, Lmax of an int8 [R, Lmax] code matrix whose windows w < W read
    columns up to w + reach - 1."""
    if codes.dtype != torch.int8 or codes.dim() != 2:
        raise TypeError(f"codes must be a 2-D int8 tensor, got {codes.dtype} {tuple(codes.shape)}")
    R_, Lmax = codes.shape
    if W < 1 or W + reach - 1 > Lmax:
        raise ValueError(f"{W} windows reading {reach} bases exceed read length {Lmax}")
    return R_, Lmax


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(x > 0x7FFFFFFF, x - (1 << 32), x).to(torch.int32)


# ---------------------------------------------------------------- probe 2


def lane_slices_plain(codes: torch.Tensor, W: int = W31, n_offsets: int = N_OFFSETS) -> torch.Tensor:
    _check_codes(codes, W, n_offsets)
    return torch.stack([codes[:, i : i + W].to(torch.int32) for i in range(n_offsets)])


def lane_slices(codes: torch.Tensor, W: int = W31, n_offsets: int = N_OFFSETS) -> torch.Tensor:
    """[n_offsets, R, W] int32: out[i] = codes[:, i:i+W]."""
    R_, Lmax = _check_codes(codes, W, n_offsets)
    if not _route(codes):
        return lane_slices_plain(codes, W, n_offsets)
    out = torch.empty((n_offsets, R_, W), dtype=torch.int32, device=codes.device)
    return _launch("lane_slices", codes, out, R_, Lmax, W, n_offsets)


def expect_lane_slices(codes: np.ndarray, W: int = W31, n_offsets: int = N_OFFSETS) -> np.ndarray:
    return np.stack([codes[:, i : i + W].astype(np.int32) for i in range(n_offsets)])


# ---------------------------------------------------------------- probe 3


def _check_stages_k(k: int) -> None:
    """Probe 3 emulates its script at the script's k values: its kernel
    holds one or two words per key (k <= 61)."""
    keys.check_k(k)
    if keys.nwords(k) > 2:
        raise ValueError(f"probe 3 takes k <= 61 (at most two words per key), got {k}")


def extract_stages_plain(codes: torch.Tensor, k: int = K31) -> torch.Tensor:
    _check_stages_k(k)
    _check_codes(codes, codes.shape[1] - k + 1, k)
    fwd, _ = extract_kmers(codes, k)
    return torch.stack([fwd, keys.revcomp(fwd, k), keys.canonical(fwd, k)[0]])


def extract_stages(codes: torch.Tensor, k: int = K31) -> torch.Tensor:
    """[3, R*W] int64 (or [3, R*W, 2] for k > 31): forward key, reverse
    complement and canonical key of every window of ``codes & 3``."""
    _check_stages_k(k)
    R_, Lmax = _check_codes(codes, codes.shape[1] - k + 1, k)
    if not _route(codes):
        return extract_stages_plain(codes, k)
    out = torch.empty((3, R_ * (Lmax - k + 1)) + keys.word_shape(k), dtype=torch.int64, device=codes.device)
    return _launch("extract_stages", codes, out, R_, Lmax, k)


def expect_extract_stages(codes: np.ndarray, k: int = K31) -> np.ndarray:
    """Per window: the forward key, its reverse complement and the canonical
    key, packed base by base in uint64: [3, R*W] words, or [3, R*W, 2]
    (hi, lo) for k > 31."""
    R_, Lmax = codes.shape
    W = Lmax - k + 1
    h = max(0, k - keys.LO_BASES)
    c = codes.astype(np.uint64) & np.uint64(3)
    f = np.zeros((2, R_, W), np.uint64)
    b = np.zeros((2, R_, W), np.uint64)
    for i in range(k):
        j = 0 if i < h else 1
        f[j] = (f[j] << np.uint64(2)) | c[:, i : i + W]
        b[j] = (b[j] << np.uint64(2)) | (np.uint64(3) - c[:, k - 1 - i : k - 1 - i + W])
    take_rc = (b[0] < f[0]) | ((b[0] == f[0]) & (b[1] < f[1]))
    can = np.where(take_rc[None], b, f)
    out = np.stack([f, b, can]).reshape(3, 2, R_ * W).transpose(0, 2, 1).view(np.int64)
    return out if h else out[..., 1]


# ---------------------------------------------------------------- probe 4


def shift_terms_plain(codes: torch.Tensor, W: int = W31) -> torch.Tensor:
    _check_codes(codes, W, LIMB0_BASES)
    c = codes.to(torch.int64) & 3
    terms = [c[:, i : i + W] << 2 * (LIMB0_BASES - 1 - i) for i in range(LIMB0_BASES)]
    acc_or = torch.zeros_like(terms[0])
    acc_sum = torch.zeros_like(terms[0])
    for t in terms:
        acc_or = acc_or | t
        acc_sum = (acc_sum + t) & _M32
    c32 = codes.to(torch.int32) & 3  # the script's int32 shifts
    acc_i = torch.zeros_like(c32[:, :W])
    for i in range(LIMB0_BASES):
        acc_i = acc_i | (c32[:, i : i + W] << 2 * (LIMB0_BASES - 1 - i))
    return torch.stack([_as_i32(t) for t in (terms[4], terms[5], terms[8], acc_or, acc_sum)] + [acc_i])


def shift_terms(codes: torch.Tensor, W: int = W31) -> torch.Tensor:
    """[6, R, W] uint32 bits: limb-0 terms i = 4, 5, 8, then the OR, SUM and
    int32-OR accumulations of terms 0..14."""
    R_, Lmax = _check_codes(codes, W, LIMB0_BASES)
    if not _route(codes):
        return shift_terms_plain(codes, W)
    out = torch.empty((6, R_, W), dtype=torch.int32, device=codes.device)
    return _launch("shift_terms", codes, out, R_, Lmax, W)


def expect_shift_terms(codes: np.ndarray, W: int = W31) -> np.ndarray:
    cw = codes.astype(np.uint32)
    terms = [((cw[:, i : i + W] & 3) << (2 * (14 - i))).astype(np.uint32) for i in range(15)]
    want_acc = np.zeros_like(terms[0])
    for t in terms:
        want_acc |= t
    return np.stack([terms[4], terms[5], terms[8], want_acc, want_acc, want_acc]).view(np.int32)


# ---------------------------------------------------------------- probe 5


def u32_shifts_plain(x: torch.Tensor) -> torch.Tensor:
    v = x.to(torch.int64) & _M32  # the uint32 value of the int32 bits
    outs = [(v << s) & _M32 for s in LS] + [v >> s for s in RS] + [(v * (1 << s)) & _M32 for s in MS]
    return torch.stack([_as_i32(o) for o in outs])


def u32_shifts(x: torch.Tensor) -> torch.Tensor:
    """[23, ...] uint32 bits of int32-held uint32 ``x``: x << s for s in LS,
    x >> s (logical) for s in RS, x * 2^s for s in MS."""
    if x.dtype != torch.int32:
        raise TypeError(f"x must hold uint32 bits as int32, got {x.dtype}")
    if not _route(x):
        return u32_shifts_plain(x)
    out = torch.empty((len(LS) + len(RS) + len(MS),) + tuple(x.shape), dtype=torch.int32, device=x.device)
    return _launch("u32_shifts", x, out, x.numel())


def expect_u32_shifts(x: np.ndarray) -> np.ndarray:
    x = x.view(np.uint32)
    outs = (
        [x << np.uint32(s) for s in LS]
        + [x >> np.uint32(s) for s in RS]
        + [x * np.uint32(1 << s) for s in MS]
    )
    return np.stack(outs).view(np.int32)


# ---------------------------------------------------------------- probe 6


def hoisted_and_roll_plain(codes: torch.Tensor, W: int = W31) -> torch.Tensor:
    _check_codes(codes, W, LIMB0_BASES)
    Lmax = codes.shape[1]
    cm = codes.to(torch.int64) & 3  # convert and mask before slicing
    acc = torch.zeros_like(cm[:, :W])
    for i in range(LIMB0_BASES):
        acc = acc | (cm[:, i : i + W] << 2 * (14 - i))
    accr = torch.zeros_like(cm)
    acch = torch.zeros_like(cm)
    for i in range(LIMB0_BASES):
        rolled = torch.roll(cm, Lmax - i, 1) if i else cm  # pltpu.roll(cm, Lmax - i, 1)
        accr = accr | (rolled << 2 * (14 - i))
        acch = (acch << 2) | rolled
    outs = [cm[:, 4 : 4 + W] << 20, cm[:, 5 : 5 + W] << 18, acc, accr[:, :W], acch[:, :W] & _M32]
    return torch.stack([_as_i32(o) for o in outs])


def hoisted_and_roll(codes: torch.Tensor, W: int = W31) -> torch.Tensor:
    """[5, R, W] uint32 bits: hoisted-mask slices i = 4 << 20 and i = 5 << 18,
    then the limb-0 accumulation of bases 0..14 as an OR of slices, an OR of
    rolled rows and a Horner fold of rolled rows."""
    R_, Lmax = _check_codes(codes, W, LIMB0_BASES)
    if not _route(codes):
        return hoisted_and_roll_plain(codes, W)
    out = torch.empty((5, R_, W), dtype=torch.int32, device=codes.device)
    return _launch("hoisted_and_roll", codes, out, R_, Lmax, W)


def expect_hoisted_and_roll(codes: np.ndarray, W: int = W31) -> np.ndarray:
    cw = codes.astype(np.uint32) & 3
    want = np.zeros((codes.shape[0], W), np.uint32)
    for i in range(15):
        want |= cw[:, i : i + W] << np.uint32(2 * (14 - i))
    outs = [cw[:, 4 : 4 + W] << np.uint32(20), cw[:, 5 : 5 + W] << np.uint32(18), want, want, want]
    return np.stack(outs).view(np.int32)


# ---------------------------------------------------------------- all probes


def script_codes(rows: int = R, cols: int = LMAX) -> np.ndarray:
    """The scripts' input: seed 0, uniform codes 0..3, int8 [512, 100]."""
    return np.random.default_rng(0).integers(0, 4, (rows, cols), dtype=np.int8)


def script_u32() -> np.ndarray:
    """debug_pallas5's input: seed 0, uniform uint32 [512, 128], as int32 bits."""
    rng = np.random.default_rng(0)
    return rng.integers(0, 1 << 32, (R, U32_COLS), dtype=np.uint64).astype(np.uint32).view(np.int32)


def cases(k_stages=(K31,)):
    """(name, probe, plain, input, expectation) at each script's shape and
    seed; ``extract_stages`` once per k in ``k_stages``."""
    codes, x = script_codes(), script_u32()
    out = [
        ("lane_slices", lane_slices, lane_slices_plain, codes, expect_lane_slices),
    ]
    for k in k_stages:
        out.append((
            "extract_stages" if k == K31 else f"extract_stages k={k}",
            lambda c, k=k: extract_stages(c, k),
            lambda c, k=k: extract_stages_plain(c, k),
            codes,
            lambda c, k=k: expect_extract_stages(c, k),
        ))
    out += [
        ("shift_terms", shift_terms, shift_terms_plain, codes, expect_shift_terms),
        ("u32_shifts", u32_shifts, u32_shifts_plain, x, expect_u32_shifts),
        ("hoisted_and_roll", hoisted_and_roll, hoisted_and_roll_plain, codes, expect_hoisted_and_roll),
    ]
    return out


def run_all(device, k_stages=(K31, 41)) -> list[str]:
    """Every probe at its script's shape through its wrapper on ``device``;
    raises AssertionError on a mismatch with the script's expectation.
    Returns one line per probe."""
    lines = []
    for name, probe, _, inp, expect in cases(k_stages):
        got = probe(torch.from_numpy(inp).to(device)).cpu().numpy()
        want = expect(inp)
        n_bad = int((got != want).sum()) if got.shape == want.shape else -1
        if n_bad:
            raise AssertionError(f"probe {name}: {n_bad} of {want.size} wrong (shape {got.shape} vs {want.shape})")
        lines.append(f"{name}: OK ({got.shape[0]} outputs of {got[0].size} values)")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run the five TPU compiler probes on the card.")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("probes: no CUDA device (--device cpu runs the plain versions)")
    print(f"probes on {device}" + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else " (plain versions)"))
    for line in run_all(device):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
