"""Inputs of the canonical emission kernel from contig strings, as
``extract.emit_chains_device`` leaves them (imports no JAX, so the card's
tests use it too)."""

import numpy as np
import torch

from tpu_euler_torch.kmer import keys
from tpu_euler_torch.simulate import random_genome

_CODE = np.full(256, 255, dtype=np.uint8)
_CODE[list(b"ACGT")] = [0, 1, 2, 3]
_RC = str.maketrans("ACGT", "TGCA")


def rc(s: str) -> str:
    return s.translate(_RC)[::-1]


def emission_inputs(contigs: list[str], k: int, device="cpu", junk_seed: int = 0):
    """(codes, chain_off, start_words, n, total) of ``contigs`` (each of at
    least k bases): every contig's codes at its offset, its first k - 1
    slots holding junk codes (the kernel must not read them), its first k
    bases as its start key; codes carry one spare slot past the end, as a
    capacity-padded emission does. A case's twins go beside them as
    ``torch.tensor(twin)``."""
    lens = np.array([len(c) for c in contigs], dtype=np.int64)
    assert (lens >= k).all()
    off = np.zeros(len(contigs) + 1, dtype=np.int64)
    np.cumsum(lens, out=off[1:])
    total = int(off[-1])
    codes = _CODE[np.frombuffer("".join(contigs).encode(), dtype=np.uint8)].copy()
    junk = np.random.default_rng(junk_seed).integers(0, 4, size=(len(contigs), k - 1), dtype=np.uint8)
    codes[off[:-1, None] + np.arange(k - 1)] = junk
    first = torch.from_numpy(_CODE[np.frombuffer("".join(c[:k] for c in contigs).encode(), dtype=np.uint8)])
    start_words = keys.pack(first.reshape(len(contigs), k), k)
    return (
        torch.from_numpy(np.concatenate([codes, [0]]).astype(np.uint8)).to(device),
        torch.from_numpy(off[:-1]).to(device),
        start_words.contiguous().to(device),
        len(contigs),
        total,
    )


def contig_cases(k: int) -> dict[str, list[str]]:
    """Named contig sets that reach every branch of the kernel: contigs that
    are their own reverse complement (short, and past the prefix window),
    contigs whose first mismatch with their mirror lies past the window and
    past a block's step of the second pass, odd and even lengths, both
    sides of the host code's 256-contig branch and several thousand.
    ``TWIN_CASES`` name the twins of some of them."""
    g = random_genome(200_000, seed=k)

    def seq(n: int, seed: int) -> str:
        return random_genome(n, seed=1000 * k + seed)

    pal_short = seq(k // 2 + 1, 1)
    pal_long = seq(3000, 2)
    deep = seq(5000, 3)  # mirrored 5000 positions deep: past 64 and past 4096
    mid = seq(100, 4)
    cases = {
        "one": [g[:k + 17]],
        "own_rc_short": [pal_short + rc(pal_short)],
        "own_rc_long": [pal_long + rc(pal_long), seq(k + 3, 5)],
        # first mismatch at len(x): forward where a < comp(b), else reverse complemented
        "mirror_past_window": [deep + "A" + seq(50, 6) + "C" + rc(deep), deep[:70] + "G" + mid + "T" + rc(deep[:70]),
                               deep[:200] + "T" + mid + "T" + rc(deep[:200])],
        "odd_even": [seq(k + d, 10 + d) for d in range(12)],
        "n256": [seq(k + (i % 37), 100 + i) for i in range(256)],
        "n257": [seq(k + (i % 41), 400 + i) for i in range(257)],
        "n3000": [g[s:s + k + (s % 53)] for s in range(0, 3000 * 60, 60)],
    }
    # each contig beside its reverse complement, as the doubled edge array emits them
    x = [seq(k + 5 + 7 * i, 700 + i) for i in range(5)] + [pal_long + rc(pal_long)]
    cases["twins"] = [x[0], x[1], rc(x[0]), x[2], rc(x[1]), rc(x[2]), x[3], x[4], rc(x[4]), rc(x[3]), x[5], x[5]]
    # candidates that are not repeats: a rotation, and one base changed at either end or in the prefix
    y = seq(400, 800)
    flip = {"A": "C", "C": "G", "G": "T", "T": "A"}
    cases["false_twins"] = [
        y, rc(y[7:] + y[:7]), y[:-1] + flip[y[-1]], rc(y)[:3] + flip[rc(y)[3]] + rc(y)[4:], rc(y)[:-1] + flip[rc(y)[-1]],
        y[:200], rc(y),
    ]
    return cases


#: each contig's twin in the cases that have one (-1 for none)
TWIN_CASES = {
    "twins": [2, 4, 0, 5, 1, 3, 9, 8, 7, 6, 11, 10],
    "false_twins": [1, 0, 0, 0, 0, 6, 5],
}
