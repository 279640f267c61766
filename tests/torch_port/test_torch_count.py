"""One-shot count, cutoff and right-sizing: port vs tpu_euler, exact."""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_euler.config import AssemblyConfig
from tpu_euler.io.encode import encode_reads
from tpu_euler.kmer.count import apply_cutoff as jax_cutoff
from tpu_euler.pipeline.assemble import count_spectrum as jax_count
from tpu_euler.pipeline.assemble import right_size_spectrum as jax_right_size
from tpu_euler.reference_impl.simulate import random_genome, simulate_reads
from tpu_euler_torch import convert
from tpu_euler_torch.kmer.count import apply_cutoff
from tpu_euler_torch.pipeline.assemble import count_spectrum, right_size_spectrum


def _codes(k, seed):
    genome = random_genome(2500, seed=seed)
    reads = simulate_reads(genome, read_len=90, coverage=12, seed=seed + 1, error_rate=0.004)
    reads[2] = reads[2][:50] + "N" + reads[2][51:]
    reads[4] = reads[4][:40]
    return encode_reads(reads, 90)


def _assert_same_spectrum(port, ref):
    assert port.n == int(ref.n)
    assert torch.equal(port.words, convert.limbs_to_words(np.asarray(ref.limbs), "cpu"))
    np.testing.assert_array_equal(port.counts.numpy(), np.asarray(ref.counts))


# read_batch 100 leaves a partial (code-4 padded) final batch
@pytest.mark.parametrize("k,seed", [(21, 5), (31, 6), (33, 7), (41, 8)])
def test_oneshot_count_and_cutoff(k, seed):
    codes = _codes(k, seed)
    cfg = AssemblyConfig(k=k, read_batch=100, read_len=90, spectrum_capacity=1 << 14)
    assert codes.shape[0] % cfg.read_batch
    ref, ref_n = jax_count(codes, cfg)
    got, n = count_spectrum(codes, cfg, "cpu")
    assert n == ref_n
    _assert_same_spectrum(got, ref)
    assert (got.counts[: got.n] > 1).any() and (got.counts[: got.n] == 1).any()
    for mc in (1, 2, 3):
        _assert_same_spectrum(apply_cutoff(got, mc), jax_cutoff(ref, mc))


def test_right_size_spectrum():
    codes = _codes(31, 9)
    cfg = AssemblyConfig(k=31, read_batch=512, read_len=90, spectrum_capacity=1 << 19)
    ref, _ = jax_count(codes, cfg)
    got, _ = count_spectrum(codes, cfg, "cpu")
    rs_ref, rs = jax_right_size(ref), right_size_spectrum(got)
    assert rs.words.shape[0] == rs_ref.limbs.shape[0] == 1 << 18
    _assert_same_spectrum(rs, rs_ref)


def test_count_overflow_and_unported_routes_raise():
    codes = _codes(21, 5)
    cfg = AssemblyConfig(k=21, read_batch=256, read_len=90, spectrum_capacity=1 << 8)
    with pytest.raises(RuntimeError, match="overflowed"):
        count_spectrum(codes, cfg, "cpu")
    for rows in (0, 1000):
        with pytest.raises(NotImplementedError):
            count_spectrum(codes, dataclasses.replace(cfg, oneshot_rows=rows), "cpu")
