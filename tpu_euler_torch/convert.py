"""State carried between the reference package and the port.

The reference keeps a key as ``[L]`` big-endian uint32 limbs; the port keeps
one int64 word (``limb0 << 32 | limb1`` for L = 2). These helpers convert
keys, spectra and per-edge records so the parity tests can feed both
packages the same state and compare their outputs. Inputs are anything
``np.asarray`` accepts (numpy or JAX arrays); this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_euler_torch.kmer import keys
from tpu_euler_torch.kmer.count import Spectrum


def _limbs_u64(limbs) -> np.ndarray:
    limbs = np.asarray(limbs, dtype=np.uint32)
    if limbs.shape[-1] > 2:
        raise ValueError(f"{limbs.shape[-1]} limbs do not fit one 64-bit word")
    v = np.zeros(limbs.shape[:-1], dtype=np.uint64)
    for j in range(limbs.shape[-1]):
        v = (v << np.uint64(32)) | limbs[..., j].astype(np.uint64)
    return v


def limbs_to_words(limbs, device) -> torch.Tensor:
    """[..., L] uint32 limbs (L <= 2, keys of <= 62 bits) -> int64 words."""
    return torch.from_numpy(_limbs_u64(limbs).view(np.int64)).to(device)


def words_to_limbs(words: torch.Tensor, L: int) -> np.ndarray:
    """int64 words -> [..., L] uint32 limbs (big-endian)."""
    v = words.cpu().numpy().view(np.uint64)
    out = np.empty(v.shape + (L,), dtype=np.uint32)
    for j in range(L - 1, -1, -1):
        out[..., j] = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        v = v >> np.uint64(32)
    return out


def tkeys_from_limbs(limbs, device) -> torch.Tensor:
    """Reference transition keys ([E, L] uint32, all-ones = none) -> the
    port's tkeys (``keys.to_tkey`` of the value; ``keys.SENT`` = none)."""
    limbs = np.asarray(limbs, dtype=np.uint32)
    sent = np.all(limbs == np.uint32(0xFFFFFFFF), axis=-1)
    v = (_limbs_u64(limbs) ^ np.uint64(1 << 63)).view(np.int64)
    return torch.from_numpy(np.where(sent, keys.SENT, v)).to(device)


def spectrum_from_reference(spec, device) -> Spectrum:
    """A reference ``Spectrum`` (limbs, counts, n) -> the port's."""
    return Spectrum(
        words=limbs_to_words(spec.limbs, device),
        counts=torch.from_numpy(np.array(spec.counts, dtype=np.int32)).to(device),
        n=int(np.asarray(spec.n)),
    )


def records_to_numpy(rec) -> dict[str, np.ndarray]:
    """Fields of a NamedTuple record (reference or port) as numpy arrays;
    scalar fields become 0-d arrays and missing (None) fields are skipped."""
    out = {}
    for name in rec._fields:
        v = getattr(rec, name)
        if v is None:
            continue
        out[name] = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out
