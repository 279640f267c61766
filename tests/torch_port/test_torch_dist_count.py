"""Sharded counting over a ``LoopbackComm`` against the reference's
``shard_map`` steps on the CPU mesh: the owner grouping, and every shard's
keys, counts, ``n`` and ``dropped`` after each step of the per-batch route
and after each fill and drain of the grouped route; then the gathered
spectrum. Exact, through ``convert``'s limb/word mapping."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_euler.dist import count_dist as ref_cd
from tpu_euler.dist.mesh import batch_sharding, make_mesh
from tpu_euler.io.encode import encode_reads
from tpu_euler.kmer import keys as jax_keys
from tpu_euler.kmer.extract import extract_canonical_kmers as jax_extract
from tpu_euler.reference_impl.simulate import random_genome, simulate_reads
from tpu_euler_torch import convert
from tpu_euler_torch.dist import count_dist
from tpu_euler_torch.dist.mesh import LoopbackComm
from tpu_euler_torch.kmer import keys
from tpu_euler_torch.kmer.extract import extract_canonical_kmers

ALL_ONES = np.uint32(0xFFFFFFFF)
READ_LEN = 80
ROWS = 16  # reads a rank a step


def _codes(k, n_dev, seed=3):
    """Read codes for a few steps of ``n_dev`` ranks: errors, an N, a short
    read, and a last step that padding (code 4) fills."""
    reads = simulate_reads(random_genome(600, seed=seed), READ_LEN, 5.5 * n_dev, seed=seed + k, error_rate=0.01)
    reads[1] = reads[1][:30] + "N" + reads[1][31:]
    reads[2] = reads[2][:50]
    codes = encode_reads(reads, READ_LEN)
    step = ROWS * n_dev
    n_steps = -(-codes.shape[0] // step)
    assert n_steps >= 3 and codes.shape[0] % step
    pad = np.full((n_steps * step - codes.shape[0], READ_LEN), 4, np.int8)
    return np.concatenate([codes, pad]).reshape(n_steps, step, READ_LEN)


def _port_words(limbs, k):
    """Reference rows -> the port's, the all-ones sentinel row -> keys.SENT."""
    limbs = np.array(limbs, dtype=np.uint32)
    empty = (limbs == ALL_ONES).all(axis=-1)
    limbs[empty] = 0
    words = convert.limbs_to_words(limbs, "cpu", keys.nwords(k))
    words[torch.from_numpy(empty)] = keys.SENT
    return words


def _assert_shards(acc, ref, k, c_local, what):
    ref_limbs, ref_counts = np.asarray(ref.limbs), np.asarray(ref.counts)
    assert acc.n == [int(x) for x in np.asarray(ref.n)], what
    assert [int(d) for d in acc.dropped] == [int(x) for x in np.asarray(ref.dropped)], what
    for r in range(len(acc.n)):
        block = slice(r * c_local, (r + 1) * c_local)
        want = convert.limbs_to_words(ref_limbs[block], "cpu", keys.nwords(k))
        assert torch.equal(acc.words[r], want), (what, r)
        np.testing.assert_array_equal(acc.counts[r].numpy(), ref_counts[block], err_msg=f"{what} {r}")


@pytest.mark.parametrize("k", [21, 41])
def test_group_by_owner_matches_reference(k):
    """Slabs, validity and drop count, with a ``c_dest`` small enough to
    drop: inside an owner's group the rows keep their window order."""
    codes = _codes(k, 4)[0]
    limbs, valid = jax_extract(jnp.asarray(codes), k)
    words, port_valid = extract_canonical_kmers(torch.from_numpy(codes), k)
    words = keys.select(port_valid, words, keys.SENT)
    for n_dev, c_dest in ((4, 1 << 12), (4, 500), (3, 64)):
        ref_owner = jax_keys.bucket_hash(limbs) % jnp.uint32(n_dev)
        want_limbs, want_valid, want_dropped = ref_cd._group_by_owner(limbs, valid, ref_owner, n_dev, c_dest)
        owner = torch.where(port_valid, keys.bucket_hash(words, keys.nlimbs(k)) % n_dev, n_dev)
        send, dropped = count_dist._group_by_owner(words, owner, n_dev, c_dest)
        assert int(dropped) == int(want_dropped) and (int(dropped) > 0) == (c_dest < 1 << 12)
        want_valid = np.array(want_valid)
        np.testing.assert_array_equal(keys.is_valid(send).numpy(), want_valid)
        want = convert.limbs_to_words(np.asarray(want_limbs), "cpu", keys.nwords(k))
        assert torch.equal(send[torch.from_numpy(want_valid)], want[torch.from_numpy(want_valid)])


def _rank_batches(step_codes, n_dev):
    return list(torch.from_numpy(step_codes).chunk(n_dev))


@pytest.mark.parametrize("n_dev", [2, 8])
@pytest.mark.parametrize("k", [21, 41])
def test_per_batch_steps_match_reference_shards(k, n_dev):
    steps = _codes(k, n_dev)
    windows = ROWS * (READ_LEN - k + 1)
    c_dest, c_local = int(2.0 * windows / n_dev + 256), 1 << 10
    mesh = make_mesh(n_dev)
    ref_step = ref_cd.make_dist_count_step(k, n_dev, c_dest, mesh)
    sharding = batch_sharding(mesh)
    ref = jax.device_put(
        ref_cd.empty_dist_spectrum(n_dev, c_local, jax_keys.nlimbs(k)),
        ref_cd.DistSpectrum(sharding, sharding, sharding, sharding),
    )
    comm = LoopbackComm(n_dev, "cpu")
    acc = count_dist.empty_dist_spectrum(comm, c_local, k)
    n_windows = 0
    for s, step_codes in enumerate(steps):
        ref, ref_nw = ref_step(jax.device_put(step_codes, sharding), ref)
        acc, nv = count_dist.dist_count_step(_rank_batches(step_codes, n_dev), acc, comm, k, c_dest)
        _assert_shards(acc, ref, k, c_local, f"step {s}")
        assert sum(int(x) for x in nv) == int(np.asarray(ref_nw)[0])
        n_windows += int(np.asarray(ref_nw)[0])
    assert n_windows > 0 and min(acc.n) > 0 and sum(int(d) for d in acc.dropped) == 0
    # the gathered spectrum, whole and cut
    for out_capacity in (n_dev * c_local, sum(acc.n) - 5):
        want = ref_cd.make_gather_spectrum(out_capacity, mesh)(ref)
        got = count_dist.gather_spectrum(acc, comm, out_capacity)
        assert got.n == int(want.n) == min(sum(acc.n), out_capacity)
        assert torch.equal(got.words, convert.limbs_to_words(np.asarray(want.limbs), "cpu", keys.nwords(k)))
        np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
        assert (got.counts[: got.n] > 1).any()


@pytest.mark.parametrize("n_dev", [2, 8])
@pytest.mark.parametrize("k", [21, 41])
def test_grouped_fills_and_drains_match_reference_shards(k, n_dev):
    """Two steps a group: the buffers after every fill, the shards after
    every drain (the last group is partial), with slabs that drop keys."""
    steps = _codes(k, n_dev)
    windows = ROWS * (READ_LEN - k + 1)
    c_dest, c_local, bpg = int(0.9 * windows / n_dev), 1 << 10, 2
    slab_rows = n_dev * c_dest
    t_loc = bpg * slab_rows
    L = jax_keys.nlimbs(k)
    mesh = make_mesh(n_dev)
    sharding = batch_sharding(mesh)
    ref_fill = ref_cd.make_dist_fill_step(k, n_dev, c_dest, mesh)
    ref_drain = ref_cd.make_dist_drain_step(k, c_local, mesh)
    ref_alloc = ref_cd.make_buf_alloc(n_dev * t_loc, L, mesh)
    ref = jax.device_put(
        ref_cd.empty_dist_spectrum(n_dev, c_local, L), ref_cd.DistSpectrum(sharding, sharding, sharding, sharding)
    )
    rl, rc, rn, rdropped = ref.limbs, ref.counts, ref.n, ref.dropped
    rbuf = ref_alloc()
    comm = LoopbackComm(n_dev, "cpu")
    acc = count_dist.empty_dist_spectrum(comm, c_local, k)
    bufs = count_dist.alloc_group_bufs(comm, t_loc, k)
    n_drains = 0
    for s, step_codes in enumerate(steps):
        b = s % bpg
        rbuf, rdropped, ref_nw = ref_fill(jax.device_put(step_codes, sharding), rbuf, np.int32(b * slab_rows), rdropped)
        nv = count_dist.dist_fill_step(_rank_batches(step_codes, n_dev), bufs, b * slab_rows, acc.dropped, comm, k, c_dest)
        assert sum(int(x) for x in nv) == int(np.asarray(ref_nw)[0])
        ref_rows = np.stack([np.asarray(x) for x in rbuf], axis=-1).reshape(n_dev, t_loc, L)
        for r in range(n_dev):
            assert torch.equal(bufs[r], _port_words(ref_rows[r], k)), (s, r)
        if b == bpg - 1 or s == len(steps) - 1:
            rl, rc, rn, ref_over = ref_drain(rbuf, rl, rc, rn)
            acc, over = count_dist.dist_drain_step(bufs, acc, c_local, k)
            ref = ref_cd.DistSpectrum(rl, rc, rn, rdropped)
            _assert_shards(acc, ref, k, c_local, f"drain after step {s}")
            assert [int(o) for o in over] == [int(x) for x in np.asarray(ref_over)]
            rbuf = ref_alloc()
            for buf in bufs:
                buf.fill_(keys.SENT)
            n_drains += 1
    assert n_drains == -(-len(steps) // bpg) and len(steps) % bpg  # a partial last group
    assert sum(int(d) for d in acc.dropped) > 0 and min(acc.n) > 0


def test_drain_reports_a_group_that_overflows_its_shard():
    k, n_dev = 21, 2
    steps = _codes(k, n_dev)
    c_dest, c_local = 1 << 11, 64
    comm = LoopbackComm(n_dev, "cpu")
    acc = count_dist.empty_dist_spectrum(comm, c_local, k)
    bufs = count_dist.alloc_group_bufs(comm, n_dev * c_dest, k)
    count_dist.dist_fill_step(_rank_batches(steps[0], n_dev), bufs, 0, acc.dropped, comm, k, c_dest)
    acc, over = count_dist.dist_drain_step(bufs, acc, c_local, k)
    assert over == [True, True] and acc.n == [c_local, c_local]
    with pytest.raises(ValueError, match="batches for 2 ranks"):
        count_dist.dist_fill_step(_rank_batches(steps[0], 1), bufs, 0, acc.dropped, comm, k, c_dest)
