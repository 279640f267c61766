"""The sharded pipeline: the cases of tests/integration/test_distributed.py
through the port's ``assemble_reads_distributed`` over a ``LoopbackComm``,
held to the reference's sharded run on the CPU mesh, to the port's
single-device run and to the oracle; then real gloo ranks, started by
``spawn_ranks``, held to the loopback; then the cases of
tests/integration/test_shard_traversal.py through ``shard_traversal=True``.
Exact."""

import dataclasses
import os
import time

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
    """The sharded traversal runs (it raised ``NotImplementedError`` while it
    was not ported, whence the name): the replicated run's result, nothing
    gathered, and the reference's sharded result."""
    _, reads = dataset
    cfg = AssemblyConfig(k=21, read_batch=128, read_len=100, spectrum_capacity=1 << 15)
    got = assemble_reads_distributed(reads, cfg, loopback(2), shard_traversal=True)
    _same(got, assemble_reads_distributed(reads, cfg, loopback(2)))
    assert set(got.stage_seconds) == STAGES and got.stage_seconds["gather"] == 0.0
    assert got.stage_seconds["graph"] > 0 and got.stage_seconds["extract"] > 0
    _same(got, ref_assemble_distributed(reads, cfg, n_devices=2, shard_traversal=True))


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


def die_in_turn(comm, first: int, gap_s: float):
    """A ``spawn_ranks`` target: rank ``first`` exits with code 3 at once;
    every other rank waits in a collective, which fails when ``first``
    dies, and exits with code 4 ``gap_s`` after that."""
    if comm.ranks[0] == first:
        os._exit(3)
    try:
        comm.all_reduce_sum([torch.zeros(1)])
    finally:
        time.sleep(gap_s)
        os._exit(4)


@pytest.mark.parametrize("first", [0, 1])
def test_the_spawn_names_the_first_rank_to_die(first):
    """A peer that dies 0.05 s after the rank at fault, because of it, is
    not the rank named."""
    with pytest.raises(RuntimeError, match=f"rank {first} of 2 exited with code 3"):
        spawn_ranks(2, "cpu", die_in_turn, (first, 0.05), timeout_s=120, threads=1)


# --- the sharded traversal: tests/integration/test_shard_traversal.py ---------


def sharded(reads, cfg, n_dev, **kw):
    return assemble_reads_distributed(reads, cfg, loopback(n_dev), shard_traversal=True, **kw)


@pytest.fixture(scope="module")
def circle():
    genome = random_genome(3500, seed=801)
    return genome, simulate_reads(genome, read_len=100, coverage=22, seed=802, circular=True)


def _junk_tips(reads, genome, rng, n):
    for _ in range(n):
        p = int(rng.integers(0, len(genome) - 100))
        junk = "".join("ACGT"[c] for c in rng.integers(0, 4, 30))
        reads.extend([(genome[p : p + 70] + junk)[:100]] * 5)


def _counted_shards(codes, cfg, comm):
    """The sharded spectrum of ``codes``, counted batch by batch with the
    pipeline's own step."""
    from tpu_euler_torch.dist import count_dist

    n_dev = comm.world
    c_dest = int(2.0 * cfg.read_batch * cfg.windows_per_read / n_dev + 256)
    acc = count_dist.empty_dist_spectrum(comm, cfg.spectrum_capacity // n_dev, cfg.k)
    step_rows = cfg.read_batch * n_dev
    for i in range(0, codes.shape[0], step_rows):
        batch = np.full((step_rows, codes.shape[1]), 4, np.int8)
        batch[: len(codes[i : i + step_rows])] = codes[i : i + step_rows]
        acc, _ = count_dist.dist_count_step(list(torch.from_numpy(batch).chunk(n_dev)), acc, comm, cfg.k, c_dest)
    return acc


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_traversal_matches_oracle(circle, n_dev):
    _, reads = circle
    cfg = AssemblyConfig(k=21, read_batch=128, read_len=100, spectrum_capacity=1 << 15)
    got = sharded(reads, cfg, n_dev)
    assert canonical_contig_set(got.contig_strings) == assemble_oracle(reads, cfg.k)


def test_sharded_equals_replicated(circle):
    _, reads = circle
    cfg = AssemblyConfig(k=31, read_batch=128, read_len=100, spectrum_capacity=1 << 15)
    _same(sharded(reads, cfg, 4), assemble_reads_distributed(reads, cfg, loopback(4)))


def test_sharded_pipeline_emits_the_full_fetch_contigs(circle):
    """The pipeline's contigs are those of the chains built by hand from
    the same shards and assembled from the whole fetched arrays."""
    from tpu_euler_torch.dist import traverse_dist
    from tpu_euler_torch.euler.extract import assemble_contig_bytes

    _, reads = circle
    k, n_dev = 21, 4
    cfg = AssemblyConfig(k=k, read_batch=128, read_len=100, spectrum_capacity=1 << 15, oneshot_rows=0)
    res = sharded(reads, cfg, n_dev)
    comm = loopback(n_dev)
    c_local = cfg.spectrum_capacity // n_dev
    acc = _counted_shards(encode_reads(reads, 100), cfg, comm)
    sc = traverse_dist.dist_chains_step(acc.words, acc.n, comm, k, c_local)
    idx = np.flatnonzero(mesh.fetch_global(comm, sc.valid))
    old = assemble_contig_bytes(
        mesh.fetch_global(comm, sc.chain)[idx], mesh.fetch_global(comm, sc.pos)[idx],
        mesh.fetch_global(comm, sc.edge_words)[idx], k,
    )
    frag = traverse_dist.local_chain_fragments(sc, k)
    assert traverse_dist.assemble_contig_fragments([frag], k) == old == res.contigs
    assert frag["d2h_bytes"] > frag["chain"].nbytes + frag["pos"].nbytes + frag["base"].nbytes > 0


def test_sharded_with_cutoff_and_repeats():
    rep = random_genome(200, seed=811)
    genome = random_genome(900, seed=812) + rep + random_genome(700, seed=813) + rep + random_genome(500, seed=814)
    reads = simulate_reads(genome, read_len=100, coverage=30, seed=815, error_rate=0.004, circular=False)
    cfg = AssemblyConfig(k=21, min_count=4, read_batch=128, read_len=100, spectrum_capacity=1 << 15)
    got = sharded(reads, cfg, 8)
    assert canonical_contig_set(got.contig_strings) == assemble_oracle(reads, cfg.k, min_count=4)
    _same(got, ref_assemble_distributed(reads, cfg, n_devices=8, shard_traversal=True))


def test_sharded_k41_two_word_keys():
    """SPEC config 5's shape: k = 41 (three limbs there, two words here)."""
    genome = random_genome(1500, seed=821)
    reads = simulate_reads(genome, read_len=120, coverage=18, seed=822, circular=True)
    cfg = AssemblyConfig(k=41, read_batch=64, read_len=120, spectrum_capacity=1 << 13)
    assert canonical_contig_set(sharded(reads, cfg, 8).contig_strings) == assemble_oracle(reads, 41)


def test_sharded_paired_end_reads():
    """SPEC config 4's shape: paired-end reads, the graph sharded."""
    genome = random_genome(2500, seed=831)
    reads = simulate_reads(genome, read_len=100, coverage=25, seed=832, circular=True, paired=True, insert_size=280)
    cfg = AssemblyConfig(k=31, read_batch=128, read_len=100, spectrum_capacity=1 << 15)
    assert canonical_contig_set(sharded(reads, cfg, 4).contig_strings) == assemble_oracle(reads, 31)


def test_sharded_tip_clipping_matches_oracle():
    genome = random_genome(2500, seed=841)
    reads = simulate_reads(genome, read_len=100, coverage=25, seed=842, circular=True)
    _junk_tips(reads, genome, np.random.default_rng(840), 5)
    cfg = AssemblyConfig(k=21, min_count=3, tip_rounds=3, read_batch=128, read_len=100, spectrum_capacity=1 << 15)
    got = sharded(reads, cfg, 8)
    expected = assemble_oracle(reads, 21, min_count=3, tip_rounds=3)
    assert canonical_contig_set(got.contig_strings) == expected and len(expected) == 1
    _same(got, assemble_reads(reads, cfg, "cpu"))


def test_dist_tip_step_matches_host_rows():
    """The sharded tip step on the pipeline's own shards equals the host's
    ``find_tip_rows`` at every rank count."""
    from tpu_euler_torch.dist import traverse_dist

    genome = random_genome(2500, seed=851)
    reads = simulate_reads(genome, read_len=100, coverage=25, seed=852, circular=True)
    _junk_tips(reads, genome, np.random.default_rng(850), 5)
    cfg = AssemblyConfig(k=21, min_count=3, read_batch=128, read_len=100, spectrum_capacity=1 << 14, oneshot_rows=0)
    codes = encode_reads(reads, 100)
    for n_dev in (2, 8):
        comm = loopback(n_dev)
        c_local = cfg.spectrum_capacity // n_dev
        acc = _counted_shards(codes, cfg, comm)
        words, _, n = traverse_dist.dist_cutoff_step(acc.words, acc.counts, acc.n, cfg.min_count)
        sc = traverse_dist.dist_chains_step(words, n, comm, cfg.k, c_local)
        keep, n_tips, drops = traverse_dist.dist_tip_step(sc, comm, 2 * cfg.k, c_local)
        host_keep, host_tips = traverse_dist.find_tip_rows(sc, comm, 2 * cfg.k, c_local)
        assert drops == 0 and n_tips == host_tips > 0
        np.testing.assert_array_equal(torch.cat(keep).numpy(), host_keep)


def test_slab_overflow_auto_retry(circle, caplog):
    """A first slab factor that is too small overflows on every rank
    together, and the retry gives the oracle's contigs."""
    import logging

    _, reads = circle
    cfg = AssemblyConfig(k=21, read_batch=128, read_len=100, spectrum_capacity=1 << 15)
    with caplog.at_level(logging.WARNING, logger="tpu_euler_torch"):
        got = sharded(reads, cfg, 4, slab_factors=(0.02, 2.0))
    assert canonical_contig_set(got.contig_strings) == assemble_oracle(reads, cfg.k)
    retries = [r.getMessage() for r in caplog.records if "retrying with a bigger slab" in r.getMessage()]
    assert len(retries) == 1 and "slab_factor=0.02" in retries[0]
    # the reference says the same of the same run
    with caplog.at_level(logging.WARNING, logger="tpu_euler"):
        ref_assemble_distributed(reads, cfg, n_devices=4, shard_traversal=True, slab_factors=(0.02, 2.0))
    ref_retries = [r.getMessage() for r in caplog.records if r.name == "tpu_euler" and "retrying" in r.getMessage()]
    assert ref_retries and ref_retries[0].split(";")[0] == retries[0].split(";")[0]


@pytest.mark.parametrize("cleaning", [{}, {"min_count": 3, "tip_rounds": 2}, {"min_count": 3, "bubble_rounds": 1}], ids=["chains", "tips", "bubbles"])
def test_slab_overflow_exhausted_raises(circle, cleaning):
    """When every slab factor overflows the run raises the reference's
    error, whichever step dropped."""
    _, reads = circle
    cfg = AssemblyConfig(k=21, read_batch=128, read_len=100, spectrum_capacity=1 << 15, **cleaning)
    with pytest.raises(RuntimeError, match="slab_factor") as port_err:
        sharded(reads, cfg, 4, slab_factors=(0.02,))
    with pytest.raises(RuntimeError, match="slab_factor") as ref_err:
        ref_assemble_distributed(reads, cfg, n_devices=4, shard_traversal=True, slab_factors=(0.02,))
    assert str(port_err.value) == str(ref_err.value)
    assert str(port_err.value.__cause__) == str(ref_err.value.__cause__)


def test_sharded_bubble_popping_matches_oracle():
    from torch_port_inputs import reads_with_bubbles

    k = 21
    reads = reads_with_bubbles(random_genome(3000, seed=761), seed=762)
    cfg = AssemblyConfig(k=k, min_count=3, bubble_rounds=3, read_batch=128, read_len=100, spectrum_capacity=1 << 15)
    got = sharded(reads, cfg, 4)
    assert canonical_contig_set(got.contig_strings) == assemble_oracle(reads, k, min_count=3, bubble_rounds=3)
    _same(got, assemble_reads(reads, cfg, "cpu"))


def test_sharded_tips_and_bubbles_combined():
    """Config 3's shape: cutoff, tips and bubbles through the sharded path,
    with an equal-coverage bubble for the minimum-key tie-break."""
    from torch_port_inputs import reads_with_bubbles

    k = 21
    genome = random_genome(2800, seed=771)
    reads = reads_with_bubbles(genome, n_bubbles=3, seed=773)
    _junk_tips(reads, genome, np.random.default_rng(772), 3)
    w = list(genome[900:1000])
    w[50] = "ACGT"[("ACGT".index(w[50]) + 2) % 4]
    reads.extend(["".join(w)] * 25)
    cfg = AssemblyConfig(
        k=k, min_count=3, tip_rounds=3, bubble_rounds=3, read_batch=128, read_len=100, spectrum_capacity=1 << 15
    )
    got = sharded(reads, cfg, 8)
    assert canonical_contig_set(got.contig_strings) == assemble_oracle(reads, k, min_count=3, tip_rounds=3, bubble_rounds=3)
    _same(got, ref_assemble_distributed(reads, cfg, n_devices=8, shard_traversal=True))


@pytest.mark.parametrize("slab_factors", [(2.0, 4.0, 8.0), (0.02, 2.0), (0.02,)], ids=["holds", "retries", "exhausted"])
def test_gloo_ranks_traverse_sharded(tmp_path, slab_factors):
    """Real gloo ranks with the traversal sharded, tips and bubbles too:
    every rank returns the loopback's result (the ranks exchange their
    contig fragments); a slab overflow retries, or raises, on every rank
    together, so nothing hangs."""
    from torch_port_inputs import dirty_reads

    reads = dirty_reads(seed=850)
    codes = encode_reads(reads, 100)
    cfg = AssemblyConfig(
        k=21, min_count=3, tip_rounds=2, bubble_rounds=1, read_batch=128, read_len=100, spectrum_capacity=1 << 14
    )
    args = (_save(tmp_path, "codes.npy", codes), cfg, False, False, True, slab_factors)
    if slab_factors == (0.02,):
        with pytest.raises(RuntimeError, match="rank [01] of 2 exited with code 1"):
            spawn_ranks(2, "cpu", assemble_rank, args, timeout_s=120, threads=1)
        return
    want = sharded(None, cfg, 2, codes=codes)
    assert canonical_contig_set(want.contig_strings) == assemble_oracle(reads, 21, min_count=3, tip_rounds=2, bubble_rounds=1)
    results = spawn_ranks(2, "cpu", assemble_rank, args, timeout_s=240, threads=1)
    assert len(results) == 2
    for got in results:
        _same(got, want)
