"""The sharded pipeline: the cases of tests/integration/test_distributed.py
through the port's ``assemble_reads_distributed`` over a ``LoopbackComm``,
held to the reference's sharded run on the CPU mesh, to the port's
single-device run and to the oracle; then real gloo ranks, started by
``spawn_ranks``, held to the loopback. Exact."""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_euler.config import AssemblyConfig
from tpu_euler.dist.pipeline import assemble_reads_distributed as ref_assemble_distributed
from tpu_euler.reference_impl.oracle import assemble_oracle, count_canonical_kmers
from tpu_euler.reference_impl.simulate import random_genome, simulate_paired_read_codes, simulate_reads
from tpu_euler.verify.compare import canonical_contig_set
from tpu_euler_torch.dist import mesh
from tpu_euler_torch.dist.launch import assemble_rank, spawn_ranks
from tpu_euler_torch.dist.mesh import LoopbackComm
from tpu_euler_torch.dist.pipeline import assemble_reads_distributed
from tpu_euler_torch.io.encode import decode_read, encode_reads
from tpu_euler_torch.pipeline.assemble import assemble_reads

STAGES = {"encode", "count", "count_drain", "gather", "graph", "extract"}


def loopback(n):
    return LoopbackComm(n, "cpu")


@pytest.fixture(scope="module")
def dataset():
    genome = random_genome(4000, seed=201)
    return genome, simulate_reads(genome, read_len=100, coverage=25, seed=202, circular=True)


def _same(a, b):
    assert a.contigs == b.contigs
    assert (a.n_reads, a.n_kmers_counted, a.n_distinct_kmers) == (b.n_reads, b.n_kmers_counted, b.n_distinct_kmers)


@pytest.mark.parametrize("oneshot_rows", [192_000_000, 0], ids=["grouped", "per_batch"])
@pytest.mark.parametrize("n_dev", [2, 8])
def test_dist_matches_oracle_reference_and_single(dataset, n_dev, oneshot_rows):
    _, reads = dataset
    cfg = AssemblyConfig(k=21, read_batch=128, read_len=100, spectrum_capacity=1 << 15, oneshot_rows=oneshot_rows)
    dist = assemble_reads_distributed(reads, cfg, loopback(n_dev))
    assert canonical_contig_set(dist.contig_strings) == assemble_oracle(reads, cfg.k)
    _same(dist, assemble_reads(reads, cfg, "cpu"))
    _same(dist, ref_assemble_distributed(reads, cfg, n_devices=n_dev))
    assert set(dist.stage_seconds) == STAGES


def test_dist_counts_exact(dataset):
    """Sharded counts equal a Counter's exactly: no key dropped or counted twice."""
    _, reads = dataset
    cfg = AssemblyConfig(k=31, read_batch=64, read_len=100, spectrum_capacity=1 << 15)
    dist = assemble_reads_distributed(reads, cfg, loopback(8))
    assert dist.n_kmers_counted == sum(count_canonical_kmers(reads, 31).values())
    assert dist.n_reads == len(reads)


@pytest.mark.parametrize("k,min_count", [(21, 4), (41, 3)])
def test_dist_cutoff(k, min_count):
    genome = random_genome(2500, seed=203)
    reads = simulate_reads(genome, read_len=100, coverage=35, seed=204, circular=True, error_rate=0.004)
    cfg = AssemblyConfig(k=k, min_count=min_count, read_batch=128, read_len=100, spectrum_capacity=1 << 15)
    dist = assemble_reads_distributed(reads, cfg, loopback(8))
    assert canonical_contig_set(dist.contig_strings) == assemble_oracle(reads, cfg.k, cfg.min_count)
    _same(dist, ref_assemble_distributed(reads, cfg, n_devices=8))


@pytest.mark.parametrize("oneshot_rows", [192_000_000, 0], ids=["grouped", "per_batch"])
def test_dist_overflow_detection(oneshot_rows):
    genome = random_genome(6000, seed=205)
    reads = simulate_reads(genome, read_len=100, coverage=10, seed=206)
    cfg = AssemblyConfig(k=21, read_batch=128, read_len=100, spectrum_capacity=1 << 9, oneshot_rows=oneshot_rows)
    with pytest.raises(RuntimeError, match="overflow") as port_err:
        assemble_reads_distributed(reads, cfg, loopback(8))
    with pytest.raises(RuntimeError, match="overflow") as ref_err:
        ref_assemble_distributed(reads, cfg, n_devices=8)
    assert str(port_err.value) == str(ref_err.value)


def test_dist_dropped_keys_raise_with_the_reference_message(dataset):
    _, reads = dataset
    cfg = AssemblyConfig(k=21, read_batch=128, read_len=100, spectrum_capacity=1 << 15)
    with pytest.raises(RuntimeError, match="k-mers dropped in all_to_all exchange") as port_err:
        assemble_reads_distributed(reads, cfg, loopback(4), dest_capacity_factor=0.5)
    with pytest.raises(RuntimeError, match="k-mers dropped in all_to_all exchange") as ref_err:
        ref_assemble_distributed(reads, cfg, n_devices=4, dest_capacity_factor=0.5)
    assert str(port_err.value) == str(ref_err.value)


def test_local_input_single_process_equivalent():
    genome = random_genome(1200, seed=871)
    reads = simulate_reads(genome, read_len=80, coverage=15, seed=872, circular=True)
    cfg = AssemblyConfig(k=21, read_batch=32, read_len=80, spectrum_capacity=1 << 13)
    a = assemble_reads_distributed(reads, cfg, loopback(4), local_input=True)
    b = assemble_reads_distributed(reads, cfg, loopback(4), local_input=False)
    _same(a, b)
    assert a.n_reads == len(reads)
    _same(a, ref_assemble_distributed(reads, cfg, n_devices=4, local_input=True))


def test_paired_end_codes_grouped_in_several_groups():
    """Paired-end codes (SPEC config 4's input) through ``codes=``, with
    group buffers of two steps, so several drains and a partial last one."""
    genome = random_genome(3000, seed=881)
    codes = simulate_paired_read_codes(genome, read_len=100, coverage=30, seed=882, insert_size=300)
    n_dev, cfg = 4, AssemblyConfig(k=31, read_batch=64, read_len=100, spectrum_capacity=1 << 14)
    slab_rows = n_dev * int(2.0 * cfg.read_batch * cfg.windows_per_read / n_dev + 256)
    cfg = dataclasses.replace(cfg, oneshot_rows=2 * slab_rows)
    assert -(-codes.shape[0] // (cfg.read_batch * n_dev)) == 4
    dist = assemble_reads_distributed(None, cfg, loopback(n_dev), codes=codes)
    reads = [decode_read(c) for c in codes]
    assert canonical_contig_set(dist.contig_strings) == assemble_oracle(reads, cfg.k)
    assert len(dist.contigs) == 1 and len(next(iter(dist.contigs))) == len(genome) + cfg.k - 1
    _same(dist, ref_assemble_distributed(None, cfg, n_devices=n_dev, codes=codes))


def test_shard_traversal_is_not_ported_and_says_so(dataset):
    _, reads = dataset
    cfg = AssemblyConfig(k=21, read_batch=128, read_len=100, spectrum_capacity=1 << 15)
    with pytest.raises(NotImplementedError, match="traverse_dist"):
        assemble_reads_distributed(reads, cfg, loopback(2), shard_traversal=True)


def test_more_ranks_than_gpus_raises_the_reference_message(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 4 devices, have 1"):
        mesh.rank_device("cuda", 0, 4)
    with pytest.raises(ValueError, match="requested 4 devices, have 1"):
        spawn_ranks(4, "cuda", assemble_rank, ("none.npy", None))
    assert mesh.rank_device("cuda", 0, 1) == torch.device("cuda", 0)
    assert mesh.rank_device("cpu", 3, 4) == torch.device("cpu")


def test_loopback_collectives_are_transposes():
    comm = loopback(3)
    xs = [torch.arange(6).reshape(6, 1) + 10 * r for r in range(3)]
    got = comm.all_to_all(xs)
    assert [g[:, 0].tolist() for g in got] == [[0, 1, 10, 11, 20, 21], [2, 3, 12, 13, 22, 23], [4, 5, 14, 15, 24, 25]]
    assert all(torch.equal(g, torch.cat(xs)) for g in comm.all_gather(xs))
    assert all(torch.equal(g, xs[0] + xs[1] + xs[2]) for g in comm.all_reduce_sum(xs))
    assert comm.process_allgather([7, 9]).tolist() == [[7, 9]]
    assert mesh.fetch_global(comm, xs).shape == (18, 1)
    with pytest.raises(ValueError, match="equal slabs"):
        comm.all_to_all([torch.arange(5)] * 3)


# --- real gloo ranks -------------------------------------------------------


def _save(tmp_path, name, codes):
    path = str(tmp_path / name)
    np.save(path, codes)
    return path


@pytest.mark.parametrize("world,oneshot_rows", [(2, 192_000_000), (4, 0)], ids=["2_grouped", "4_per_batch"])
def test_gloo_ranks_match_loopback(dataset, tmp_path, world, oneshot_rows):
    _, reads = dataset
    codes = encode_reads(reads, 100)
    cfg = AssemblyConfig(k=21, read_batch=128, read_len=100, spectrum_capacity=1 << 15, oneshot_rows=oneshot_rows)
    want = assemble_reads_distributed(None, cfg, loopback(world), codes=codes)
    results = spawn_ranks(world, "cpu", assemble_rank, (_save(tmp_path, "codes.npy", codes), cfg), timeout_s=240, threads=1)
    assert len(results) == world
    for got in results:
        _same(got, want)


def test_gloo_ranks_with_uneven_local_input_agree_on_the_steps(dataset, tmp_path):
    """Shards of 1, 11, 0 and 4 steps' worth of reads: every rank runs the
    longest shard's steps, and the result is the whole input's."""
    _, reads = dataset
    codes = encode_reads(reads, 100)
    cfg = AssemblyConfig(k=21, read_batch=64, read_len=100, spectrum_capacity=1 << 15)
    cuts = [0, 40, 700, 700, len(reads)]
    paths = [_save(tmp_path, f"shard{r}.npy", codes[cuts[r] : cuts[r + 1]]) for r in range(4)]
    want = assemble_reads_distributed(None, cfg, loopback(4), codes=codes)
    for got in spawn_ranks(4, "cpu", assemble_rank, (paths, cfg, True), timeout_s=240, threads=1):
        _same(got, want)


def collectives_on_a_rank(comm):
    """A ``spawn_ranks`` target: every collective of a ``ProcessComm`` on
    tensors that name their rank; returned as lists."""
    r, n = comm.ranks[0], comm.world
    x = torch.arange(2 * n).reshape(2 * n, 1) + 100 * r
    return {
        "all_to_all": comm.all_to_all([x])[0].tolist(),
        "all_gather": comm.all_gather([x[:2]])[0].tolist(),
        "all_reduce_sum": comm.all_reduce_sum([x])[0].tolist(),
        "process_allgather": comm.process_allgather([r, 7]).tolist(),
        "fetch_global": mesh.fetch_global(comm, [x[:1]]).tolist(),
    }


def test_process_comm_collectives_equal_the_loopbacks():
    n = 3
    got = spawn_ranks(n, "cpu", collectives_on_a_rank, timeout_s=120, threads=1)
    comm = loopback(n)
    xs = [torch.arange(2 * n).reshape(2 * n, 1) + 100 * r for r in range(n)]
    for r in range(n):
        assert got[r]["all_to_all"] == comm.all_to_all(xs)[r].tolist()
        assert got[r]["all_gather"] == comm.all_gather([x[:2] for x in xs])[r].tolist()
        assert got[r]["all_reduce_sum"] == comm.all_reduce_sum(xs)[r].tolist()
        assert got[r]["process_allgather"] == [[q, 7] for q in range(n)]
        assert got[r]["fetch_global"] == mesh.fetch_global(comm, [x[:1] for x in xs]).tolist()


def test_a_rank_that_dies_fails_the_spawn_and_hangs_nothing(dataset, tmp_path):
    _, reads = dataset
    cfg = AssemblyConfig(k=21, read_batch=128, read_len=100, spectrum_capacity=1 << 15)
    paths = [_save(tmp_path, "codes.npy", encode_reads(reads, 100)), str(tmp_path / "missing.npy")]
    with pytest.raises(RuntimeError, match="rank 1 of 2 exited with code 1"):
        spawn_ranks(2, "cpu", assemble_rank, (paths, cfg), timeout_s=120, threads=1)
