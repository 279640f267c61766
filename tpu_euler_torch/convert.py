"""State carried between the reference package and the port.

The reference keeps a key as ``[L]`` big-endian uint32 limbs; the port keeps
one int64 word (``limb0 << 32 | limb1`` for L <= 2) or, for longer keys, W
int64 words holding the same value in base 2^62 (``kmer/keys.py``). These
helpers convert keys, spectra, arena state and per-edge records so the
parity tests can feed both packages the same state and compare their
outputs. Inputs are anything ``np.asarray`` accepts (numpy or JAX arrays);
this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_euler_torch.kmer import keys
from tpu_euler_torch.kmer.count import Spectrum

_U32 = np.uint64(32)
_WORD_BITS = 2 * keys.LO_BASES
_WORD_MASK = np.uint64(keys.LO_MASK)
_LIMB_MASK = np.uint64(0xFFFFFFFF)


def _limbs_u64(limbs) -> np.ndarray:
    limbs = np.asarray(limbs, dtype=np.uint32)
    if limbs.shape[-1] > 2:
        raise ValueError(f"{limbs.shape[-1]} limbs do not fit one 64-bit word")
    v = np.zeros(limbs.shape[:-1], dtype=np.uint64)
    for j in range(limbs.shape[-1]):
        v = (v << _U32) | limbs[..., j].astype(np.uint64)
    return v


def _limbs_multi(limbs, W: int) -> np.ndarray:
    """[..., L] limbs -> [..., W] int64 words of the same value in base
    2^62; raises if the value needs more than W words."""
    limbs = np.asarray(limbs, dtype=np.uint32)
    L = limbs.shape[-1]
    top = _WORD_BITS * W  # bits W words hold
    for j in range(L):
        lo_l = 32 * (L - 1 - j)
        if lo_l + 32 > top and (limbs[..., j] >> np.uint32(max(0, top - lo_l))).any():
            raise ValueError(f"{L}-limb keys do not fit {W} words")
    out = np.zeros(limbs.shape[:-1] + (W,), dtype=np.uint64)
    for j, i, sh in keys.limb_word_overlaps(L, W):
        v = limbs[..., j].astype(np.uint64)
        v = v << np.uint64(sh) if sh >= 0 else v >> np.uint64(-sh)
        out[..., i] |= v & _WORD_MASK
    return out.view(np.int64)


def limbs_to_words(limbs, device, nwords: int) -> torch.Tensor:
    """[..., L] uint32 limbs -> int64 words: [...] for ``nwords`` = 1 (L <=
    2), [..., W] for W = ``nwords`` words (``keys.nwords(k)`` for k-base
    keys)."""
    if nwords == 1:
        v = _limbs_u64(limbs).view(np.int64)
    else:
        v = _limbs_multi(limbs, nwords)
    return torch.from_numpy(v).to(device)


def words_to_limbs(words: torch.Tensor, L: int) -> np.ndarray:
    """int64 words ([...] for one word, L <= 2; [..., W] for W words, L >= 3)
    -> [..., L] uint32 limbs (big-endian)."""
    w = words.cpu().numpy().view(np.uint64)
    if L <= 2:
        out = np.empty(w.shape + (2,), dtype=np.uint32)
        out[..., 0] = (w >> _U32).astype(np.uint32)
        out[..., 1] = (w & _LIMB_MASK).astype(np.uint32)
        return out[..., 2 - L :]
    W = w.shape[-1]
    out = np.zeros(w.shape[:-1] + (L,), dtype=np.uint64)
    for j, i, sh in keys.limb_word_overlaps(L, W):
        v = w[..., i]
        v = v >> np.uint64(sh) if sh >= 0 else v << np.uint64(-sh)
        out[..., j] |= v & _LIMB_MASK
    return out.astype(np.uint32)


def tkeys_from_limbs(limbs, device) -> torch.Tensor:
    """Reference transition keys ([E, L] uint32, all-ones = none) -> the
    port's: for L <= 2 ``keys.to_tkey`` of the value; for L >= 3 the dense
    rank of the value among the valid keys (``keys.dense_rank``), which is
    what the port keeps of multi-word transition keys. ``keys.SENT`` = none."""
    limbs = np.asarray(limbs, dtype=np.uint32)
    sent = np.all(limbs == np.uint32(0xFFFFFFFF), axis=-1)
    if limbs.shape[-1] > 2:
        rank = np.full(sent.shape, keys.SENT, dtype=np.int64)
        _, inv = np.unique(limbs[~sent], axis=0, return_inverse=True)
        rank[~sent] = inv.reshape(-1)
        return torch.from_numpy(rank).to(device)
    v = (_limbs_u64(limbs) ^ np.uint64(1 << 63)).view(np.int64)
    return torch.from_numpy(np.where(sent, keys.SENT, v)).to(device)


def spectrum_from_reference(spec, device, nwords: int) -> Spectrum:
    """A reference ``Spectrum`` (limbs, counts, n) -> the port's."""
    return Spectrum(
        words=limbs_to_words(spec.limbs, device, nwords),
        counts=torch.from_numpy(np.array(spec.counts, dtype=np.int32)).to(device),
        n=int(np.asarray(spec.n)),
    )


def arena_from_reference(bufs, counts, device, nwords: int):
    """The reference's counting arena (a tuple of L uint32 ``[M]`` limb
    arrays, all-ones in every limb = empty row, plus uint32 ``[M]`` counts)
    -> the port's (``[M]`` or ``[M, W]`` int64 words with ``keys.SENT`` in
    every word of an empty row, int64 ``[M]`` counts)."""
    limbs = np.stack([np.asarray(b, dtype=np.uint32) for b in bufs], axis=-1)
    empty = np.all(limbs == np.uint32(0xFFFFFFFF), axis=-1)
    limbs[empty] = 0
    words = limbs_to_words(limbs, "cpu", nwords)
    words[torch.from_numpy(empty)] = keys.SENT
    c = torch.from_numpy(np.asarray(counts, dtype=np.uint32).astype(np.int64))
    return words.to(device), c.to(device)


def shard_chains_from_reference(sc, device, nwords: int, world: int):
    """A reference ``ShardChains`` (global arrays of ``world`` blocks: edge
    limbs, int32 ids with -1 = none, bool flags, [world] drops) -> the
    port's, one entry a rank: edge limbs -> words, ids -> int64 (the
    reference's ids are already -1 where its uint32 state read all ones)."""
    from tpu_euler_torch.dist.traverse_dist import ShardChains

    def blocks(a, dtype=None):
        a = np.asarray(a)
        return [torch.from_numpy(np.array(b, dtype=dtype or b.dtype)).to(device) for b in np.split(a, world)]

    return ShardChains(
        edge_words=[limbs_to_words(b, device, nwords) for b in np.split(np.asarray(sc.edge_limbs), world)],
        valid=blocks(sc.valid),
        chain=blocks(sc.chain, np.int64),
        pos=blocks(sc.pos, np.int64),
        is_start=blocks(sc.is_start),
        tail_dead=blocks(sc.tail_dead),
        head_dead=blocks(sc.head_dead),
        on_cycle=blocks(sc.on_cycle),
        dropped=[d.reshape(()) for d in blocks(sc.dropped, np.int64)],
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
