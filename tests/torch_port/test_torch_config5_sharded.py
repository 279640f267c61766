"""SPEC config 5's shape through the sharded mode, at a small size.

Config 5's settings (``simulate.config5_inputs``: k = 41, so keys of two
words, 40x error-free 100-base reads of a circular genome, node arrays at
1.15x) on a genome of 30 kbp, with a batch, a capacity and a
``oneshot_rows`` small enough that every rank drains its group buffer two
times or more. It goes through ``assemble_reads_distributed`` at world 2
and 4, with the replicated and the sharded traversal, over loopback ranks
and over gloo ranks that ``spawn_ranks`` starts. Every run must equal the
reference's sharded run on the 8-device CPU mesh (reads, windows, distinct
k-mers, contig set) and the oracle, and be one contig of G + k - 1 bases.
Exact."""

import dataclasses

import numpy as np
import pytest

from tpu_euler.config import AssemblyConfig as RefConfig
from tpu_euler.dist.pipeline import assemble_reads_distributed as ref_assemble_distributed
from tpu_euler.reference_impl.oracle import assemble_oracle
from tpu_euler.verify.compare import canonical_contig_set
from tpu_euler_torch.dist import pipeline
from tpu_euler_torch.dist.launch import spawn_ranks
from tpu_euler_torch.dist.mesh import LoopbackComm
from tpu_euler_torch.dist.pipeline import assemble_reads_distributed
from tpu_euler_torch.io.encode import decode_read
from tpu_euler_torch.kmer import keys
from tpu_euler_torch.simulate import config5_inputs

GENOME_BP = 30_000
BATCH = 512


def slab_rows(world: int, cfg) -> int:
    """Rows a rank receives a step (the pipeline's ``world * c_dest``)."""
    return world * int(2.0 * cfg.read_batch * cfg.windows_per_read / world + 256)


@pytest.fixture(scope="module")
def config5():
    genome, codes, cfg = config5_inputs(GENOME_BP)
    cfg = dataclasses.replace(cfg, read_batch=BATCH, spectrum_capacity=1 << 16)
    # two steps a group at world 4 (three groups), two at world 2 (six)
    return genome, codes, dataclasses.replace(cfg, oneshot_rows=2 * slab_rows(4, cfg))


@pytest.fixture(scope="module")
def reference(config5):
    """The reference's sharded run of SPEC config 5 as stated (the traversal
    sharded) on four devices of the CPU mesh, and the oracle's contigs."""
    _, codes, cfg = config5
    ref = ref_assemble_distributed(
        None, RefConfig(**dataclasses.asdict(cfg)), n_devices=4, codes=codes, shard_traversal=True
    )
    return ref, assemble_oracle([decode_read(c) for c in codes], cfg.k)


def check(got, genome, cfg, reference):
    ref, oracle = reference
    assert (got.n_reads, got.n_kmers_counted, got.n_distinct_kmers) == (
        ref.n_reads, ref.n_kmers_counted, ref.n_distinct_kmers
    )
    assert got.contigs == ref.contigs
    assert canonical_contig_set(got.contig_strings) == oracle
    assert len(got.contigs) == 1 and len(next(iter(got.contigs))) == len(genome) + cfg.k - 1


def test_the_input_has_config5s_shape(config5):
    genome, codes, cfg = config5
    assert (cfg.k, keys.nwords(cfg.k), cfg.read_len, cfg.node_cap_factor) == (41, 2, 100, 1.15)
    assert codes.shape == (GENOME_BP * 40 // 100, 100) and len(genome) == GENOME_BP
    for world, groups in ((2, 6), (4, 3)):
        n_steps = -(-codes.shape[0] // (cfg.read_batch * world))
        assert -(-n_steps // (cfg.oneshot_rows // slab_rows(world, cfg))) == groups


@pytest.mark.parametrize("shard_traversal", [False, True], ids=["replicated", "sharded_traversal"])
@pytest.mark.parametrize("world", [2, 4])
def test_loopback_matches_reference_and_oracle(config5, reference, monkeypatch, world, shard_traversal):
    genome, codes, cfg = config5
    drains = []
    drain = pipeline.dist_drain_step
    monkeypatch.setattr(pipeline, "dist_drain_step", lambda *a: drains.append(1) or drain(*a))
    got = assemble_reads_distributed(None, cfg, LoopbackComm(world, "cpu"), codes=codes, shard_traversal=shard_traversal)
    check(got, genome, cfg, reference)
    assert len(drains) == {2: 6, 4: 3}[world]
    assert (got.stage_seconds["gather"] == 0.0) == shard_traversal


def both_traversals(comm, codes_path, cfg):
    """A ``spawn_ranks`` target: the replicated and the sharded traversal on
    this rank, one after the other."""
    codes = np.load(codes_path, mmap_mode="c")
    return [
        assemble_reads_distributed(None, cfg, comm, codes=codes, shard_traversal=st) for st in (False, True)
    ]


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_ranks_match_reference_and_oracle(config5, reference, tmp_path, world):
    genome, codes, cfg = config5
    path = str(tmp_path / "codes.npy")
    np.save(path, codes)
    ranks = spawn_ranks(world, "cpu", both_traversals, (path, cfg), timeout_s=240, threads=1)
    assert len(ranks) == world
    for replicated, sharded in ranks:
        check(replicated, genome, cfg, reference)
        check(sharded, genome, cfg, reference)
        assert sharded.stage_seconds["gather"] == 0.0
