"""``exchange_gather`` / ``exchange_push`` over a ``LoopbackComm``: the
cases of tests/unit/test_exchange.py, and every rank's rows and drop count
against the reference's ``shard_map`` blocks on the CPU mesh. Exact; the
reference's all-ones uint32 is -1 in a gathered row and ``keys.SENT`` in a
row no ``min`` push reached."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from tpu_euler.dist import exchange as ref_exchange
from tpu_euler.dist.mesh import AXIS, make_mesh
from tpu_euler_torch.dist.exchange import exchange_gather, exchange_push, owner_slots
from tpu_euler_torch.dist.mesh import LoopbackComm
from tpu_euler_torch.kmer import keys

ALL_ONES = 0xFFFFFFFF
SHAPES = [(4, 64, 3), (8, 32, 1)]


def _shards(x, n_dev):
    return list(torch.from_numpy(np.asarray(x).astype(np.int64)).chunk(n_dev))


def _ref(fn, n_dev, *arrays):
    """``fn`` under shard_map on the CPU mesh: (rows, each device's drops)."""

    def body(*blocks):
        out, dropped = fn(*blocks)
        return out, dropped[None]

    mesh = make_mesh(n_dev)
    g = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=tuple(P(AXIS) for _ in arrays), out_specs=(P(AXIS), P(AXIS))))
    out, dropped = g(*map(jnp.asarray, arrays))
    return np.asarray(out).astype(np.int64), np.asarray(dropped).astype(np.int64)


def _inputs(n_dev, el_cap, width, seed):
    E = n_dev * el_cap
    rng = np.random.default_rng(seed)
    state = rng.integers(0, 2**32, (E, width), dtype=np.uint32)
    gids = rng.integers(-1, E, (E,), dtype=np.int32)  # includes -1s
    return E, state, gids


@pytest.mark.parametrize("n_dev,el_cap,width", SHAPES)
def test_exchange_gather_matches_global(n_dev, el_cap, width):
    E, state, gids = _inputs(n_dev, el_cap, width, 7)
    rows, dropped = exchange_gather(_shards(state, n_dev), _shards(gids, n_dev), LoopbackComm(n_dev, "cpu"), el_cap, c_req=el_cap)
    assert sum(int(d) for d in dropped) == 0
    expected = np.where((gids >= 0)[:, None], state[np.clip(gids, 0, E - 1)].astype(np.int64), -1)
    np.testing.assert_array_equal(torch.cat(rows).numpy(), expected)


def test_exchange_gather_overflow_detected():
    n_dev, el_cap = 4, 32
    E = n_dev * el_cap
    state = np.zeros((E, 1), dtype=np.int64)
    gids = np.zeros((E,), dtype=np.int64)  # every request targets rank 0
    rows, dropped = exchange_gather(_shards(state, n_dev), _shards(gids, n_dev), LoopbackComm(n_dev, "cpu"), el_cap, c_req=4)
    assert [int(d) for d in dropped] == [el_cap - 4] * n_dev
    # the first c_req requests of each rank were served, the rest read the fill
    assert all((r[:4] == 0).all() and (r[4:] == -1).all() for r in rows)


@pytest.mark.parametrize("combine", ["set", "min", "max"])
def test_exchange_push_combines(combine):
    n_dev, el_cap = 4, 16
    E = n_dev * el_cap
    rng = np.random.default_rng(11)
    vals = rng.integers(1, 1000, (E, 2)).astype(np.int64)
    gids = rng.integers(-1, E, (E,)).astype(np.int64)
    out, dropped = exchange_push(_shards(vals, n_dev), _shards(gids, n_dev), LoopbackComm(n_dev, "cpu"), el_cap, c_req=el_cap, combine=combine)
    out = torch.cat(out).numpy()
    assert sum(int(d) for d in dropped) == 0
    written = np.zeros(E, bool)
    written[gids[gids >= 0]] = True
    if combine == "set":  # several writers make "set" ambiguous
        assert (out[~written] == 0).all()
        for t in np.flatnonzero(written):
            assert any((out[t] == w).all() for w in vals[gids == t])
        return
    ref = np.full((E, 2), keys.SENT if combine == "min" else 0, np.int64)
    op = np.minimum if combine == "min" else np.maximum
    for i in np.flatnonzero(gids >= 0):
        ref[gids[i]] = op(ref[gids[i]], vals[i])
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("c_req_div", [1, 8])
@pytest.mark.parametrize("n_dev,el_cap,width", SHAPES)
def test_exchange_gather_matches_reference_blocks(n_dev, el_cap, width, c_req_div):
    """Every rank's rows and drops, with room for every request and with
    slabs that overflow: the same requests are dropped."""
    E, state, gids = _inputs(n_dev, el_cap, width, 21)
    c_req = el_cap // c_req_div
    want, want_dropped = _ref(
        lambda s, g: ref_exchange.exchange_gather(s, g, n_dev, el_cap, c_req), n_dev, state, gids
    )
    rows, dropped = exchange_gather(_shards(state, n_dev), _shards(gids, n_dev), LoopbackComm(n_dev, "cpu"), el_cap, c_req)
    np.testing.assert_array_equal([int(d) for d in dropped], want_dropped)
    assert (want_dropped.sum() > 0) == (c_req_div > 1)
    # an unfetched row is all-ones in the reference and -1 here; a fetched
    # row may hold all-ones as data, so compare through the fetched mask
    got = torch.cat(rows).numpy()
    fetched = (got != -1).any(axis=1)
    np.testing.assert_array_equal(got[fetched], want[fetched])
    assert (want[~fetched] == ALL_ONES).all()
    # a fill of the caller's choice
    fill = torch.arange(width) + 5
    rows, _ = exchange_gather(_shards(state, n_dev), _shards(gids, n_dev), LoopbackComm(n_dev, "cpu"), el_cap, c_req, fill=fill)
    want, _ = _ref(
        lambda s, g: ref_exchange.exchange_gather(s, g, n_dev, el_cap, c_req, fill=jnp.arange(width, dtype=jnp.uint32) + 5),
        n_dev, state, gids,
    )
    np.testing.assert_array_equal(torch.cat(rows).numpy(), want)


@pytest.mark.parametrize("combine", ["set", "min", "max", "add"])
@pytest.mark.parametrize("n_dev,el_cap,width", SHAPES)
def test_exchange_push_matches_reference_blocks(n_dev, el_cap, width, combine):
    E = n_dev * el_cap
    rng = np.random.default_rng(31)
    vals = rng.integers(1, 1 << 20, (E, width), dtype=np.uint32)
    if combine == "set":  # one writer an id, and some rows not sent
        gids = rng.permutation(E).astype(np.int32)
        gids[rng.random(E) < 0.2] = -1
    else:
        gids = rng.integers(-1, E // 2, (E,), dtype=np.int32)  # several writers an id
    for c_req in (el_cap, el_cap // 2):
        want, want_dropped = _ref(
            lambda v, g: ref_exchange.exchange_push(v, g, n_dev, el_cap, c_req, combine=combine), n_dev, vals, gids
        )
        out, dropped = exchange_push(_shards(vals, n_dev), _shards(gids, n_dev), LoopbackComm(n_dev, "cpu"), el_cap, c_req, combine=combine)
        np.testing.assert_array_equal([int(d) for d in dropped], want_dropped)
        if combine == "min":
            want = np.where(want == ALL_ONES, keys.SENT, want)
        np.testing.assert_array_equal(torch.cat(out).numpy(), want)


def test_exchange_push_add_does_not_wrap():
    """``add`` sums in int64, where the reference's uint32 sum wraps."""
    n_dev, el_cap = 2, 4
    vals = [torch.full((4, 1), 3_000_000_000), torch.full((4, 1), 3_000_000_000)]
    gids = [torch.tensor([0, 0, 5, -1]), torch.tensor([0, 5, 5, 7])]
    out, dropped = exchange_push(vals, gids, LoopbackComm(n_dev, "cpu"), el_cap, c_req=4, combine="add")
    assert torch.cat(out)[:, 0].tolist() == [9_000_000_000, 0, 0, 0, 0, 9_000_000_000, 0, 3_000_000_000]
    with pytest.raises(ValueError):
        exchange_push(vals, gids, LoopbackComm(n_dev, "cpu"), el_cap, c_req=4, combine="mean")


def test_owner_slots_keep_each_owners_row_order():
    owner = torch.tensor([2, 0, 3, 0, 2, 2, 1, 3, 0, 2])  # 3 = not sent
    rows, slots, dropped = owner_slots(owner, 3, cap=2)
    assert rows.tolist() == [1, 3, 6, 0, 4] and slots.tolist() == [0, 1, 2, 4, 5]
    assert int(dropped) == 3  # one row of owner 0, two of owner 2
