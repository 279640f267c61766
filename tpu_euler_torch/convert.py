"""State carried between the reference package and the port.

The reference keeps a key as ``[L]`` big-endian uint32 limbs; the port keeps
one int64 word (``limb0 << 32 | limb1`` for L <= 2) or, for L >= 3, a pair
``(hi, lo)`` of the same value split at bit 62 (``kmer/keys.py``). These
helpers convert keys, spectra and per-edge records so the parity tests can
feed both packages the same state and compare their outputs. Inputs are
anything ``np.asarray`` accepts (numpy or JAX arrays); this module imports
no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_euler_torch.kmer import keys
from tpu_euler_torch.kmer.count import Spectrum

_U32 = np.uint64(32)
_LO_MASK = np.uint64(keys.LO_MASK)
_SHIFT_LO = np.uint64(2 * keys.LO_BASES)


def _limbs_u64(limbs) -> np.ndarray:
    limbs = np.asarray(limbs, dtype=np.uint32)
    if limbs.shape[-1] > 2:
        raise ValueError(f"{limbs.shape[-1]} limbs do not fit one 64-bit word")
    v = np.zeros(limbs.shape[:-1], dtype=np.uint64)
    for j in range(limbs.shape[-1]):
        v = (v << _U32) | limbs[..., j].astype(np.uint64)
    return v


def _limbs_pair(limbs) -> np.ndarray:
    """[..., L] limbs (3 <= L <= 4, values below 2^124) -> [..., 2] int64
    (hi, lo)."""
    limbs = np.asarray(limbs, dtype=np.uint32)
    L = limbs.shape[-1]
    if L > 4:
        raise ValueError(f"{L} limbs do not fit two 62-bit words")
    pad = np.zeros(limbs.shape[:-1] + (4 - L,), dtype=np.uint32)
    full = np.concatenate([pad, limbs], axis=-1)
    top, bottom = _limbs_u64(full[..., :2]), _limbs_u64(full[..., 2:])
    hi = (top << np.uint64(2)) | (bottom >> _SHIFT_LO)
    return np.stack([hi, bottom & _LO_MASK], axis=-1).view(np.int64)


def limbs_to_words(limbs, device) -> torch.Tensor:
    """[..., L] uint32 limbs -> int64 words: [...] for L <= 2, [..., 2]
    (hi, lo) for L >= 3."""
    L = np.shape(limbs)[-1]
    v = _limbs_u64(limbs).view(np.int64) if L <= 2 else _limbs_pair(limbs)
    return torch.from_numpy(v).to(device)


def words_to_limbs(words: torch.Tensor, L: int) -> np.ndarray:
    """int64 words ([...] for L <= 2, [..., 2] for L >= 3) -> [..., L] uint32
    limbs (big-endian)."""
    w = words.cpu().numpy().view(np.uint64)
    if L <= 2:
        parts = [w]
    else:
        hi, lo = w[..., 0], w[..., 1]
        parts = [hi >> np.uint64(2), lo | ((hi & np.uint64(3)) << _SHIFT_LO)]
    out = np.empty(w.shape[: w.ndim - (L > 2)] + (2 * len(parts),), dtype=np.uint32)
    for j, v in enumerate(parts):
        out[..., 2 * j] = (v >> _U32).astype(np.uint32)
        out[..., 2 * j + 1] = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return out[..., out.shape[-1] - L :]


def tkeys_from_limbs(limbs, device) -> torch.Tensor:
    """Reference transition keys ([E, L] uint32, all-ones = none) -> the
    port's: for L <= 2 ``keys.to_tkey`` of the value; for L >= 3 the dense
    rank of the value among the valid keys (``keys.dense_rank``), which is
    what the port keeps of two-word transition keys. ``keys.SENT`` = none."""
    limbs = np.asarray(limbs, dtype=np.uint32)
    sent = np.all(limbs == np.uint32(0xFFFFFFFF), axis=-1)
    if limbs.shape[-1] > 2:
        rank = np.full(sent.shape, keys.SENT, dtype=np.int64)
        _, inv = np.unique(_limbs_pair(limbs[~sent]), axis=0, return_inverse=True)
        rank[~sent] = inv.reshape(-1)
        return torch.from_numpy(rank).to(device)
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
