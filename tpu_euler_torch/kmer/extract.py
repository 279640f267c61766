"""k-mer extraction from encoded read batches (plain PyTorch).

Counterpart of ``tpu_euler/kmer/extract.py:extract_canonical_kmers``. This is
the plain version that ``extract_kernel.py``'s CUDA kernel is held against.
It folds the k shifted [R, W] slices one base at a time, so its transients
stay [R, W] words instead of an [R, W, k] window stack.
"""

from __future__ import annotations

import torch

from tpu_euler_torch.kmer import keys


def extract_kmers(codes: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """All k-windows of a read batch.

    Args:
      codes: [R, Lmax] int8 base codes (0..3, 4 = N/pad).
      k: k-mer length.

    Returns:
      words: [R * W] int64 keys, or [R * W, nwords(k)] for k > 31 (W =
        Lmax - k + 1 windows per read).
      valid: [R * W] bool, True where the window holds no code 4.
    """
    R, Lmax = codes.shape
    W = Lmax - k + 1
    c = codes.to(torch.int64)
    valid = torch.ones((R, W), dtype=torch.bool, device=codes.device)
    words = []
    for a, b in keys.word_spans(k):  # one word's bases at a time
        w = torch.zeros((R, W), dtype=torch.int64, device=codes.device)
        for i in range(a, b):
            s = c[:, i : i + W]
            w = (w << 2) | (s & 3)
            valid &= s != keys.BASE_N
        words.append(w.reshape(R * W))
    out = words[0] if len(words) == 1 else torch.stack(words, dim=-1)
    return out, valid.reshape(R * W)


def extract_canonical_kmers(
    codes: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Extract + canonicalize (min of k-mer and reverse complement)."""
    words, valid = extract_kmers(codes, k)
    canon, _ = keys.canonical(words, k)
    return canon, valid
