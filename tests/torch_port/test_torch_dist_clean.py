"""The sharded tip and bubble steps over a ``LoopbackComm`` against the
reference's ``shard_map`` steps on the CPU mesh. Both packages judge the
same chains: the reference's ``ShardChains``, carried over by
``convert.shard_chains_from_reference``. ``keep`` shard by shard, the count
of edges removed and the slab drops are equal (exact), also at a slab factor
small enough to drop; the tip step agrees with both packages' host
cross-check ``find_tip_rows``."""

import functools

import numpy as np
import pytest
import torch

from tpu_euler.dist import traverse_dist as ref_td
from tpu_euler.dist.mesh import fetch_global as ref_fetch
from tpu_euler.dist.mesh import make_mesh
from tpu_euler.reference_impl.simulate import random_genome
from tpu_euler_torch import convert
from tpu_euler_torch.dist import traverse_dist as td
from tpu_euler_torch.dist.mesh import LoopbackComm
from tpu_euler_torch.kmer import keys

from torch_port_inputs import dirty_reads, port_shards, reads_with_bubbles, sharded_spectrum

C_LOCAL = {2: 1 << 12, 8: 1 << 10}


@functools.lru_cache(maxsize=None)
def _reads(kind):
    if kind == "bubbles":
        return tuple(reads_with_bubbles(random_genome(3000, seed=761), seed=762))
    return tuple(dirty_reads(seed=850))  # tips and bubbles


@functools.lru_cache(maxsize=None)
def _chains(kind, k, n_dev):
    """(the reference's chains after a cutoff of 3, its cut counts, the
    port's copy of both)."""
    c_local = C_LOCAL[n_dev]
    limbs, counts, n = sharded_spectrum(list(_reads(kind)), k, n_dev, c_local)
    mesh = make_mesh(n_dev)
    rl, rc, rn = ref_td.make_dist_cutoff_step(3, mesh)(limbs, counts, n)
    ref = ref_td.make_dist_chains_step(k, n_dev, c_local, mesh)(rl, rc, rn)
    assert int(np.asarray(ref.dropped).sum()) == 0
    sc = convert.shard_chains_from_reference(ref, "cpu", keys.nwords(k), n_dev)
    return ref, rc, sc, port_shards(rl, rc, rn, k, n_dev)[1]


def _assert_keep(keep, want, n_dev, what):
    want = np.asarray(want)
    c_local = want.shape[0] // n_dev
    for r in range(n_dev):
        np.testing.assert_array_equal(keep[r].numpy(), want[r * c_local : (r + 1) * c_local], err_msg=f"{what} rank {r}")


@pytest.mark.parametrize("n_dev,slab_factor", [(2, 2.0), (8, 2.0), (2, 0.02)], ids=["2_roomy", "8_roomy", "2_dropping"])
@pytest.mark.parametrize("k", [21, 41])
def test_tip_step_matches_reference_and_host_rows(k, n_dev, slab_factor):
    c_local, tip_len = C_LOCAL[n_dev], 2 * k
    ref, _, sc, _ = _chains("dirty", k, n_dev)
    want_keep, want_tips, want_drops = ref_td.make_dist_tip_step(
        tip_len, n_dev, c_local, make_mesh(n_dev), slab_factor=slab_factor
    )(ref.valid, ref.chain, ref.pos, ref.tail_dead, ref.head_dead)
    comm = LoopbackComm(n_dev, "cpu")
    keep, n_tips, drops = td.dist_tip_step(sc, comm, tip_len, c_local, slab_factor)
    assert (n_tips, drops) == (int(ref_fetch(want_tips)[0]), int(ref_fetch(want_drops)[0]))
    assert (drops > 0) == (slab_factor < 1)
    _assert_keep(keep, ref_fetch(want_keep), n_dev, "tip keep")
    if drops:
        return
    # the host cross-check, the port's and the reference's
    host_keep, host_tips = td.find_tip_rows(sc, comm, tip_len, c_local)
    ref_host_keep, ref_host_tips = ref_td.find_tip_rows(ref, k, tip_len, c_local)
    assert n_tips == host_tips == ref_host_tips and n_tips > 0
    np.testing.assert_array_equal(host_keep, ref_host_keep)
    _assert_keep(keep, host_keep, n_dev, "tip keep against the host rows")
    assert sum(int((~kp).sum()) for kp in keep) == n_tips // 2  # an edge and its mirror a row


def _bubble_steps(kind, k, n_dev, bubble_len, slab_factor):
    c_local = C_LOCAL[n_dev]
    ref, rc, sc, counts = _chains(kind, k, n_dev)
    want = ref_td.make_dist_bubble_step(k, bubble_len, n_dev, c_local, make_mesh(n_dev), slab_factor=slab_factor)(
        ref.edge_limbs, ref.valid, ref.chain, ref.pos, ref.is_start, ref.on_cycle, rc
    )
    got = td.dist_bubble_step(sc, counts, LoopbackComm(n_dev, "cpu"), k, bubble_len, c_local, slab_factor)
    return got, (ref_fetch(want[0]), int(ref_fetch(want[1])[0]), int(ref_fetch(want[2])[0]))


@pytest.mark.parametrize("kind", ["bubbles", "dirty"])
@pytest.mark.parametrize("n_dev", [2, 8])
@pytest.mark.parametrize("k", [21, 41])
def test_bubble_step_matches_reference(k, n_dev, kind):
    (keep, n_popped, drops), (want_keep, want_popped, want_drops) = _bubble_steps(kind, k, n_dev, 2 * k, 2.0)
    assert (n_popped, drops) == (want_popped, want_drops) and drops == 0 and n_popped > 0
    _assert_keep(keep, want_keep, n_dev, "bubble keep")
    assert sum(int((~kp).sum()) for kp in keep) == n_popped // 2


@pytest.mark.parametrize("n_dev", [2, 8])
def test_bubble_step_with_a_short_threshold_pops_nothing(n_dev):
    """A group with a chain of ``bubble_len`` edges or more is left alone."""
    (keep, n_popped, drops), (want_keep, want_popped, _) = _bubble_steps("bubbles", 21, n_dev, 5, 2.0)
    assert n_popped == want_popped == 0 and drops == 0 and all(kp.all() for kp in keep)
    _assert_keep(keep, want_keep, n_dev, "bubble keep")


@pytest.mark.parametrize("n_dev", [2, 8])
def test_bubble_step_counts_the_reference_drops(n_dev):
    """At a slab factor small enough to drop, at k = 15, where a key is one
    limb there and one word here, so that the minimum key takes as many
    rounds in both: the same drops, and the same verdicts from what was
    left."""
    (keep, n_popped, drops), (want_keep, want_popped, want_drops) = _bubble_steps("bubbles", 15, n_dev, 30, 0.02)
    assert drops == want_drops and drops > 0
    assert n_popped == want_popped
    _assert_keep(keep, want_keep, n_dev, "bubble keep with drops")


@pytest.mark.parametrize("k", [21, 41])
def test_bubble_step_drops_a_word_not_a_limb(k):
    """Where a key has more limbs than words, the minimum key's rounds, and
    with them their drops, are fewer here: W push-min and gather rounds for
    the reference's L."""
    (_, _, drops), (_, _, want_drops) = _bubble_steps("bubbles", k, 8, 2 * k, 0.02)
    assert 0 < drops < want_drops


def test_compact_step_matches_reference():
    n_dev, k = 8, 21
    c_local = C_LOCAL[n_dev]
    limbs, counts, n = sharded_spectrum(list(_reads("dirty")), k, n_dev, c_local)
    keep = np.random.default_rng(3).random(n_dev * c_local) < 0.7
    rl, rc, rn = ref_td.make_dist_compact_step(make_mesh(n_dev))(limbs, counts, n, keep)
    words, cnts, ns = td.dist_compact_step(
        *port_shards(limbs, counts, n, k, n_dev), [torch.from_numpy(b) for b in np.split(keep, n_dev)]
    )
    want_w, want_c, want_n = port_shards(rl, rc, rn, k, n_dev)
    assert ns == want_n and 0 < sum(ns) < int(n.sum())
    for r in range(n_dev):
        assert torch.equal(words[r], want_w[r]) and torch.equal(cnts[r], want_c[r]), r
