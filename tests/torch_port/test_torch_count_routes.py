"""The grouped (arena) and per-batch counting routes: port vs tpu_euler's
``count_spectrum`` on the same config, exact, on the shapes of
tests/integration/test_pipeline_vs_oracle.py:100-121 (several groups, a
partial last group, per-batch merging)."""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_euler.config import AssemblyConfig
from tpu_euler.io.encode import encode_reads
from tpu_euler.pipeline.assemble import count_spectrum as jax_count
from tpu_euler.reference_impl.simulate import random_genome, simulate_reads
from tpu_euler_torch import convert
from tpu_euler_torch.kmer import keys
from tpu_euler_torch.pipeline import assemble as pipe


def _codes():
    genome = random_genome(2500, seed=111)
    reads = simulate_reads(genome, read_len=100, coverage=18, seed=112, circular=True, error_rate=0.003)
    reads[7] = reads[7][:30] + "N" + reads[7][31:]
    return encode_reads(reads, 100)


def _route_cfg(route, k):
    W = 100 - k + 1
    base = AssemblyConfig(k=k, read_batch=256, read_len=100, spectrum_capacity=1 << 14)
    if route == "grouped":  # 25 batches of 18 reads, 3 a group: 9 groups, the last of 1
        return dataclasses.replace(base, read_batch=18, oneshot_rows=3 * 18 * W)
    if route == "grouped_even":  # 8 batches of 64 reads (the last partial), 2 a group
        return dataclasses.replace(base, read_batch=64, oneshot_rows=2 * 64 * W)
    return dataclasses.replace(base, read_batch=64, oneshot_rows=0)  # per batch


@pytest.mark.parametrize("route", ["grouped", "grouped_even", "per_batch"])
@pytest.mark.parametrize("k", [21, 41, 63])
def test_count_route_matches_reference(route, k):
    codes = _codes()
    cfg = _route_cfg(route, k)
    ref, ref_n = jax_count(codes, cfg)
    t = {}
    got, n = pipe.count_spectrum(codes, cfg, "cpu", t)
    assert n == ref_n
    assert got.n == int(ref.n)
    assert torch.equal(got.words, convert.limbs_to_words(np.asarray(ref.limbs), "cpu", keys.nwords(k)))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(ref.counts))
    assert (got.counts[: got.n] > 1).any() and (got.counts[: got.n] == 1).any()
    assert set(t) == {"encode", "count", "count_drain"}
    # the same spectrum as the one-shot route
    one, n1 = pipe.count_spectrum(codes, dataclasses.replace(cfg, oneshot_rows=1 << 30), "cpu")
    assert n1 == n and one.n == got.n
    assert torch.equal(one.words, got.words) and torch.equal(one.counts, got.counts)


def test_routes_taken(monkeypatch):
    """``oneshot_rows`` alone picks the route: grouped past it, per batch at
    0, one-shot within it; the grouped route drains once per group."""
    codes = _codes()
    calls = []
    for name in ("count_spectrum_oneshot", "count_spectrum_grouped", "count_spectrum_per_batch", "arena_drain"):
        fn = getattr(pipe, name)
        monkeypatch.setattr(pipe, name, lambda *a, _fn=fn, _n=name, **kw: calls.append(_n) or _fn(*a, **kw))
    for route in ("grouped", "per_batch"):
        pipe.count_spectrum(codes, _route_cfg(route, 21), "cpu")
    pipe.count_spectrum(codes, AssemblyConfig(k=21, read_len=100, spectrum_capacity=1 << 14), "cpu")
    assert calls == (
        ["count_spectrum_grouped"] + ["arena_drain"] * 9
        + ["count_spectrum_per_batch", "count_spectrum_oneshot"]
    )
