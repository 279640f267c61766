"""The read generator: a genome and its reads, made from a seed on a device.

One general generator for every traffic mix. It has the semantics of the
port's simulator (``tpu_euler_torch/simulate.py``), written anew so that a
change to the port cannot change the yardstick:

- a uniform random genome laid out as the configuration's chromosomes, each
  of its length and circular or linear; every base from one
  ``torch.Generator`` seeded with S, the chromosomes in their order;
- ``ceil(coverage * G / read_len)`` reads of ``read_len`` bases, G the
  genome's length, on either strand, from a generator seeded with S + 1.
  The starts are uniform over every start of the genome at which a read
  fits: any base of a circular chromosome (the read continues over its
  end), or any base of a linear one at least ``read_len`` from its end. So
  no read spans two chromosomes;
- each base, with probability ``error_rate``, replaced by one of the other
  three.

Codes are int8, A, C, G, T = 0..3. The draws are made in a few large calls
on the device and in fixed chunks, so one seed gives the same reads on one
device and torch version; every seed gives the same sizes.
"""

from __future__ import annotations

import numpy as np
import torch

CHUNK_READS = 1 << 23  # rows drawn per call: bounds the float mask of the error draws


def _generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**64)
    return gen


def read_count(genome_bp: int, read_len: int, coverage: float) -> int:
    """Rows of the code matrix for these sizes."""
    return int(np.ceil(coverage * genome_bp / read_len))


def make_codes(
    chromosomes: list[dict],
    read_len: int,
    coverage: float,
    seed: int,
    device,
    error_rate: float = 0.0,
) -> torch.Tensor:
    """[R, read_len] int8 read codes on ``device``, made from ``seed``.
    ``chromosomes``: ``{"bp": length, "circular": bool}`` each."""
    device = torch.device(device)
    sizes = [int(c["bp"]) for c in chromosomes]
    if min(sizes) < read_len:
        raise ValueError("a chromosome is shorter than a read")
    genome = torch.randint(0, 4, (sum(sizes),), generator=_generator(seed, device), device=device, dtype=torch.int8)
    # each chromosome followed by its first read_len - 1 bases where it is
    # circular, so that row s of the windows below is the read that starts at s
    pieces, starts_of, at, ext = [], [], 0, 0
    for c, n in zip(chromosomes, sizes):
        chrom = genome[at : at + n]
        pieces.append(chrom)
        if c["circular"]:
            pieces.append(chrom[: read_len - 1])
        starts_of.append((ext, n if c["circular"] else n - read_len + 1))
        ext += n + (read_len - 1 if c["circular"] else 0)
        at += n
    windows = torch.cat(pieces).unfold(0, read_len, 1)
    del genome, pieces
    first = torch.tensor([s for s, _ in starts_of], device=device)
    fits = torch.tensor([f for _, f in starts_of], device=device)
    ends = fits.cumsum(0)  # start u of all that fit lies in chromosome i where ends[i - 1] <= u < ends[i]

    gen = _generator(seed + 1, device)
    n_rows = read_count(sum(sizes), read_len, coverage)
    u = torch.randint(0, int(ends[-1]), (n_rows,), generator=gen, device=device)
    chrom = torch.bucketize(u, ends, right=True)
    starts = first[chrom] + u - (ends - fits)[chrom]
    del u, chrom
    flip = torch.randint(0, 2, (n_rows,), generator=gen, device=device, dtype=torch.int8).bool()
    out = torch.empty((n_rows, read_len), dtype=torch.int8, device=device)
    for lo in range(0, n_rows, CHUNK_READS):
        fwd = windows[starts[lo : lo + CHUNK_READS]]
        out[lo : lo + CHUNK_READS] = torch.where(flip[lo : lo + CHUNK_READS, None], 3 - fwd.flip(1), fwd)
    del windows, starts, flip
    if error_rate > 0.0:
        for lo in range(0, n_rows, CHUNK_READS):
            c = out[lo : lo + CHUNK_READS]
            hit = torch.rand(c.shape, generator=gen, device=device) < error_rate
            shift = torch.randint(1, 4, c.shape, generator=gen, device=device, dtype=torch.int8)
            c.copy_(torch.where(hit, (c + shift) % 4, c))
    return out


def host_codes(codes: torch.Tensor) -> np.ndarray:
    """The code matrix as the host array the assembler takes."""
    return codes.cpu().numpy()
