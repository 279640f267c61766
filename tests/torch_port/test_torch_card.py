"""The modules on the card against the same modules on the CPU, which the
other test files hold to the reference: the extract kernel's packed loader
and the packed feed, the walk and pointer-jump kernels round by round and
the chains they give, the cut-table kernel and the canonical emission
kernel against their plain versions, cleaning round by round, the tour
field by field, checkpoints, the command line, and the sharded mode (the loopback on the
card, NCCL ranks).
Needs a CUDA device; imports no JAX, so it runs where JAX is absent:

    python -m pytest --confcutdir=tests/torch_port tests/torch_port/test_torch_card.py -m cuda
"""

import json

import pytest
import torch

from tpu_euler_torch import trace
from tpu_euler_torch.config import AssemblyConfig
from tpu_euler_torch.euler import clean
from tpu_euler_torch.euler.tour import eulerian_tour
from tpu_euler_torch.graph.build import build_graph
from tpu_euler_torch.io.encode import encode_reads
from tpu_euler_torch.kmer.count import Spectrum, apply_cutoff
from tpu_euler_torch.pipeline.assemble import count_spectrum
from tpu_euler_torch.simulate import FUNCTIONAL_GRAPHS, adversarial_genome, functional_graph_inputs, simulate_reads
from emit_inputs import TWIN_CASES, contig_cases, emission_inputs, rc


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _spectrum(k, device):
    reads = simulate_reads(adversarial_genome(30_000, 5150), 100, 40, seed=5151, error_rate=0.003, circular=False)
    cfg = AssemblyConfig(k=k, read_batch=4096, read_len=100, spectrum_capacity=1 << 18)
    spec, _ = count_spectrum(encode_reads(reads, 100), cfg, device)
    return reads, apply_cutoff(spec, 3)


def _same(a: Spectrum, b: Spectrum):
    assert a.n == b.n
    assert torch.equal(a.words.cpu(), b.words.cpu()) and torch.equal(a.counts.cpu(), b.counts.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [21, 31, 33, 41, 63, 75, 95])
def test_packed_kernel_matches_plain_on_card(card, k):
    """The packed loader against its plain version and against the int8
    loader on the unpacked codes, bit for bit: with a map (N, a short read,
    pad rows) and without one, read lengths of 100, 107 and 64, a batch that
    does not fill its last tile, rows that start off a 16-byte boundary, odd
    and even ``start``; then the batches of the pinned packed feed."""
    import numpy as np

    from tpu_euler_torch.io.encode import pack_codes_np
    from tpu_euler_torch.kmer import extract_kernel as xk
    from tpu_euler_torch.kmer import keys
    from tpu_euler_torch.kmer.extract import unpack_codes, unpack_codes_clean
    from tpu_euler_torch.pipeline.assemble import _batch_feed

    def check(p, m, L, start):
        R, W = p.shape[0], L - k + 1
        a = torch.full((start + R * W + 3,) + keys.word_shape(k), -7, dtype=torch.int64, device=card)
        b, c = a.clone(), a.clone()
        before = trace.totals()
        na = xk.extract_fill_packed(p, m, a, start, k, L)
        grew = trace.since(before)
        assert (grew["extract_int8_launches"], grew["extract_launches"]) == (0, 1)
        nb = xk.extract_fill_packed_plain(p, m, b, start, k, L)
        codes = unpack_codes_clean(p, L) if m is None else unpack_codes(p, m, L)
        nc = xk.extract_fill(codes.contiguous(), c, start, k)
        torch.cuda.synchronize()
        assert torch.equal(a, b) and torch.equal(a, c)
        assert int(na) == int(nb) == int(nc)

    rng = np.random.default_rng(k)
    for L in (100, 107, 64):
        if L < k:
            continue
        codes = rng.integers(0, 4, ((1 << 12) + 37, L)).astype(np.int8)
        dirty = codes.copy()
        dirty[rng.random(codes.shape) < 0.01] = 4
        dirty[5, L // 2 :] = 4
        dirty[-6:] = 4
        for c, with_map in ((codes, False), (dirty, True)):
            p, m = (torch.from_numpy(x).to(card) for x in pack_codes_np(c))
            m = m if with_map else None
            for start in (17, 16):
                check(p, m, L, start)
            check(p[3:], None if m is None else m[3:], L, 0)  # rows off a 16-byte boundary
    cfg = AssemblyConfig(k=k, read_batch=1000, read_len=100)
    ragged = rng.integers(0, 4, (4037, 100)).astype(np.int8)
    ragged[1500, 7] = 4
    feed = _batch_feed(ragged, cfg, card)
    try:
        for b, (p, m) in enumerate(feed):  # 5 batches through 3 slots, the last padded
            check(p, m, 100, b)
            want = np.full((1000, 100), 4, np.int8)
            part = ragged[b * 1000 : (b + 1) * 1000]
            want[: len(part)] = part
            assert np.array_equal(unpack_codes(p, m, 100).cpu().numpy(), want)
    finally:
        feed.close()
    assert b == 4


@pytest.mark.cuda
@pytest.mark.parametrize("k", [63, 77, 95, 149])
def test_packed_kernel_at_150_bases_matches_plain_on_card(card, k):
    """150-base reads (the plant cell's: three strand words and a 19-byte
    map a read, every batch with a map): the packed loader's run-time word
    loop against its plain version, bit for bit, with N and pad rows and
    without a map, at odd and even ``start``."""
    import numpy as np

    from tpu_euler_torch.io.encode import pack_codes_np
    from tpu_euler_torch.kmer import extract_kernel as xk
    from tpu_euler_torch.kmer import keys

    rng = np.random.default_rng(k + 150)
    codes = rng.integers(0, 4, ((1 << 12) + 41, 150)).astype(np.int8)
    dirty = codes.copy()
    dirty[rng.random(codes.shape) < 0.005] = 4
    dirty[-9:] = 4
    for c, with_map in ((codes, False), (dirty, True)):
        p, m = (torch.from_numpy(x).to(card) for x in pack_codes_np(c))
        m = m if with_map else None
        for start in (5, 0):
            R, W = p.shape[0], 150 - k + 1
            a = torch.full((start + R * W,) + keys.word_shape(k), -7, dtype=torch.int64, device=card)
            b = a.clone()
            na = xk.extract_fill_packed(p, m, a, start, k, 150)
            nb = xk.extract_fill_packed_plain(p, m, b, start, k, 150)
            torch.cuda.synchronize()
            assert torch.equal(a, b) and int(na) == int(nb)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FUNCTIONAL_GRAPHS, ids=[str(c[0]) for c in FUNCTIONAL_GRAPHS])
def test_walk_and_jump_kernels_match_plain_on_card(card, case):
    """The walk kernel (the minimum tracked and not) and both jump kernels
    against their plain versions on the card, every round from the same
    state (``microbench.held_rounds``), through both chain routes; then the
    chains on the card against the CPU's."""
    from tpu_euler_torch import convert, microbench
    from tpu_euler_torch.euler import ranking
    from tpu_euler_torch.euler.unitigs import _apply_cut, chains_from_t

    succ, valid, t = functional_graph_inputs(*case)
    host = (torch.from_numpy(succ), torch.from_numpy(valid), convert.tkeys_from_limbs(t, "cpu"))
    ps, pv, pt = (x.to(card) for x in host)
    E = succ.shape[0]
    before = trace.totals()
    with microbench.held_rounds() as held:
        walked = chains_from_t(pt, pv, ps, min_edges=0)
        doubled = chains_from_t(pt, pv, ps, min_edges=E)
        res = ranking.cycle_min_ruling_tables(ps, pv, pt)
        cut, _ = _apply_cut(ps, pt, res[0], res[1])
        assert ranking.rank_chains_ruling(cut, pv) is not None
    torch.cuda.synchronize()
    grew = trace.since(before)
    walks = grew["walk_launches"]
    assert held["walk_rounds"] == walks > 2 and grew["jump_launches"] > 0 and held["jumps"] >= 5
    assert held["cut_tables"] == grew["cut_table_launches"] == 1
    for min_edges, on_card in ((0, walked), (E, doubled)):
        on_cpu = chains_from_t(host[2], host[1], host[0], min_edges=min_edges)
        for name in on_cpu._fields:
            assert torch.equal(getattr(on_card, name).cpu(), getattr(on_cpu, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["random_2_19", "random_2_20_plus_3", "every_lane_set", "no_lane_set",
                                   "flags_off_a_16_byte_boundary"])
def test_cut_tables_kernel_matches_plain_on_card(card, shape):
    """The cut-table kernel bit for bit against its plain version on the
    card: random flags at E = 2^19 and at 2^20 + 3 (a ragged end), every
    lane set (every covered lane an atomic, 2^14 slots), no lane set, and
    flags that start 5 bytes past a 16-byte boundary; one launch counted,
    over E rows."""
    from tpu_euler_torch.euler import ranking_kernel

    E, S = (1 << 19 if shape == "random_2_19" else (1 << 20) + 3), 1 << 14
    gen = torch.Generator(device=card).manual_seed(2204)
    owner = (torch.randint(0, S, (E,), generator=gen, device=card) << 8) | torch.randint(
        0, 128, (E,), generator=gen, device=card)
    owner[torch.rand(E, generator=gen, device=card) < 0.05] = -1
    if shape in ("every_lane_set", "no_lane_set"):
        is_cut = torch.full((E,), shape == "every_lane_set", dtype=torch.bool, device=card)
    elif shape == "flags_off_a_16_byte_boundary":
        is_cut = (torch.rand(E + 16, generator=gen, device=card) < 0.001)[5 : 5 + E]
        assert is_cut.data_ptr() % 16 == 5
    else:
        is_cut = torch.rand(E, generator=gen, device=card) < 0.001
    before = trace.totals()
    got = ranking_kernel.cut_tables(is_cut, owner, S)
    torch.cuda.synchronize()
    grew = trace.since(before)
    want = ranking_kernel.cut_tables_plain(is_cut, owner, S)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (grew["cut_table_launches"], grew["cut_table_rows"]) == (1, E)
    assert bool((got[0] < ranking_kernel.NO_CUT).any()) == (shape != "no_lane_set")


@pytest.mark.cuda
def test_cut_tables_on_config2_walk_match_plain_on_card(card):
    """Config 2's cycle walk (``bench_tour``'s graph, E = 9,961,472): the
    kernel's tables from the walk's own flags and owner words equal the
    plain version's; ``chains_from_t`` through the walk (one cut-table
    launch over E rows) equals the doubling route, field by field."""
    from tpu_euler_torch import microbench
    from tpu_euler_torch.euler import ranking_kernel
    from tpu_euler_torch.euler.unitigs import chains_from_t

    w = microbench.walk_state(microbench.Bench("cuda"), microbench.WALK_BP)
    E = w["succ0"].shape[0]
    got = ranking_kernel.cut_tables(w["is_cut"], w["owner_off"], w["S"])
    want = ranking_kernel.cut_tables_plain(w["is_cut"], w["owner_off"], w["S"])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(w["is_cut"].sum()) >= 1 and bool((got[0] < ranking_kernel.NO_CUT).any())
    before = trace.totals()
    walked = chains_from_t(w["t"], w["valid"], w["succ0"], min_edges=0)
    torch.cuda.synchronize()
    grew = trace.since(before)
    doubled = chains_from_t(w["t"], w["valid"], w["succ0"], min_edges=E)
    assert (grew["cut_table_launches"], grew["cut_table_rows"]) == (1, E)
    for name in walked._fields:
        assert torch.equal(getattr(walked, name), getattr(doubled, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("k", [31, 41])
def test_chains_on_card_match_cpu(card, k):
    """E = 2^19 doubled edges: ``chains_from_t`` through the walk kernel
    on the card equals the plain versions on the CPU, field by field."""
    from tpu_euler_torch.euler.unitigs import chains_from_t, successor, transition_keys

    chains = []
    for device in (card, "cpu"):
        _, spec = _spectrum(k, device)
        g = build_graph(spec, k)
        succ = successor(g)
        before = trace.totals()
        chains.append(chains_from_t(transition_keys(g, succ, k), g.edge_valid, succ))
        assert (trace.since(before)["walk_launches"] > 0) == (device == card)
    for name in chains[1]._fields:
        assert torch.equal(getattr(chains[0], name).cpu(), getattr(chains[1], name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("read_len", [100, 96])
@pytest.mark.parametrize("oneshot_rows", [192_000_000, 3 * 512 * 70, 0])
def test_packed_feed_assembly_on_card_matches_cpu(card, read_len, oneshot_rows):
    """An assembly through the packed feed on each counting route, on the
    card against the CPU: the packed kernel once a batch and the int8 one
    never; at 96 bases the full batches without an N ship no map."""
    from tpu_euler_torch.pipeline.assemble import assemble_codes
    from tpu_euler_torch.simulate import random_genome

    reads = simulate_reads(random_genome(20_000, seed=99), read_len, 30, seed=100, circular=True)
    codes = encode_reads(reads, read_len)
    codes[7, 40] = 4
    cfg = AssemblyConfig(k=31, read_batch=512, read_len=read_len, spectrum_capacity=1 << 18, oneshot_rows=oneshot_rows)
    before = trace.totals()
    on_card = assemble_codes(codes, cfg, card)
    grew = trace.since(before)
    assert (grew["extract_int8_launches"], grew["extract_launches"]) == (0, -(-codes.shape[0] // 512))
    on_cpu = assemble_codes(codes, cfg, "cpu")
    assert on_card.contigs == on_cpu.contigs
    assert (on_card.n_kmers_counted, on_card.n_distinct_kmers) == (on_cpu.n_kmers_counted, on_cpu.n_distinct_kmers)


@pytest.mark.cuda
def test_k77_150_base_assembly_on_card_matches_cpu(card):
    """The plant cell's shape at 3 Mbp: k = 77 (three-word keys) on
    150-base reads of a linear and a circular chromosome, counted in groups
    of four batches (the grouped count's drains at three words): the
    spectrum bit for bit, then the contigs, on the card and on the CPU."""
    import numpy as np

    from tpu_euler_torch.pipeline.assemble import spectrum_to_contigs
    from tpu_euler_torch.simulate import random_genome, simulate_read_codes

    codes = np.concatenate([
        simulate_read_codes(random_genome(2_500_000, seed=771), 150, 20, seed=772, circular=False),
        simulate_read_codes(random_genome(500_000, seed=773), 150, 20, seed=774, circular=True),
    ])
    cfg = AssemblyConfig(k=77, read_batch=1 << 15, read_len=150, spectrum_capacity=3_600_000,
                         oneshot_rows=4 * (1 << 15) * 74, node_cap_factor=1.15)
    before = trace.totals()
    spec_card, n_card = count_spectrum(codes, cfg, card)
    grew = trace.since(before)
    spec_cpu, n_cpu = count_spectrum(codes, cfg, "cpu")
    _same(spec_card, spec_cpu)
    assert n_card == n_cpu == codes.shape[0] * 74
    assert grew["extract_launches"] == -(-codes.shape[0] // cfg.read_batch) and grew["key_sort_passes"] >= 3 * 3
    contigs = [spectrum_to_contigs([s], cfg)[0] for s in (spec_card, spec_cpu)]
    assert contigs[0] == contigs[1] and len(contigs[0]) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("k", [31, 41])
def test_cleaning_rounds_on_card_match_cpu(card, k):
    """E = 2^19 doubled edges: the ruling-set walk runs in every round."""
    _, on_card = _spectrum(k, card)
    _, on_cpu = _spectrum(k, "cpu")
    _same(on_card, on_cpu)
    removed = 0
    for one_round in (clean.clip_tips, clean.clip_tips, clean.pop_bubbles, clean.pop_bubbles):
        on_card, n_card = one_round(on_card, k, 1)
        on_cpu, n_cpu = one_round(on_cpu, k, 1)
        assert n_card == n_cpu
        _same(on_card, on_cpu)
        removed += n_card
    assert removed > 0


@pytest.mark.cuda
def test_tour_on_card_matches_cpu(card):
    tours = []
    for device in (card, "cpu"):
        _, spec = _spectrum(21, device)
        tours.append(eulerian_tour(build_graph(spec, 21)))
    a, b = tours
    for name in ("succ", "chain", "pos", "length", "in_tour"):
        assert torch.equal(getattr(a, name).cpu(), getattr(b, name)), name
    assert (a.n_chains, a.merge_rounds) == (b.n_chains, b.merge_rounds)


@pytest.mark.cuda
def test_cli_on_card_matches_cpu(card, tmp_path, capsys):
    from tpu_euler_torch import cli

    reads, _ = _spectrum(31, "cpu")
    fq = tmp_path / "reads.fq"
    with open(fq, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    clean_opts = ["-k", "31", "--min-count", "3", "--tip-rounds", "3", "--bubble-rounds", "2"]
    metrics = []
    for name, device in (("card", []), ("cpu", ["--device", "cpu"])):
        argv = ["assemble", str(fq), "-o", str(tmp_path / f"{name}.fa"), "--save-graph", str(tmp_path / f"{name}.npz")]
        assert cli.main(argv + clean_opts + device) == 0
        metrics.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert (tmp_path / "card.fa").read_text() == (tmp_path / "cpu.fa").read_text()
    for key in ("reads", "kmers_counted", "distinct_kmers", "contigs", "longest_contig"):
        assert metrics[0][key] == metrics[1][key], key
    # the card resumes from the CPU's graph checkpoint
    assert cli.main(["assemble", "-", "-k", "31", "-o", str(tmp_path / "resumed.fa"), "--resume-graph", str(tmp_path / "cpu.npz")]) == 0
    capsys.readouterr()
    assert (tmp_path / "resumed.fa").read_text() == (tmp_path / "card.fa").read_text()


@pytest.mark.cuda
@pytest.mark.parametrize("k,oneshot_rows", [(31, 192_000_000), (41, 192_000_000), (31, 0)])
def test_loopback_pipeline_on_card_matches_cpu(card, k, oneshot_rows):
    """The sharded mode over four ranks held on the one card (its keys from
    the extract kernel) against the same on the CPU, and against the
    single-device run."""
    import dataclasses

    from tpu_euler_torch.dist.mesh import LoopbackComm
    from tpu_euler_torch.dist.pipeline import assemble_reads_distributed
    from tpu_euler_torch.pipeline.assemble import assemble_codes
    from tpu_euler_torch.simulate import random_genome

    reads = simulate_reads(random_genome(20_000, seed=99), 100, 30, seed=100, circular=True)
    codes = encode_reads(reads, 100)
    cfg = AssemblyConfig(k=k, read_batch=512, read_len=100, spectrum_capacity=1 << 18, oneshot_rows=oneshot_rows)
    before = trace.totals()
    on_card = assemble_reads_distributed(None, cfg, LoopbackComm(4, card), codes=codes)
    assert trace.since(before)["extract_int8_launches"] == 4 * -(-len(reads) // (4 * 512))
    on_cpu = assemble_reads_distributed(None, cfg, LoopbackComm(4, "cpu"), codes=codes)
    single = assemble_codes(codes, dataclasses.replace(cfg, oneshot_rows=192_000_000), card)
    for other in (on_cpu, single):
        assert on_card.contigs == other.contigs
        assert (on_card.n_reads, on_card.n_kmers_counted, on_card.n_distinct_kmers) == (
            other.n_reads, other.n_kmers_counted, other.n_distinct_kmers
        )
    assert len(on_card.contigs) == 1


@pytest.mark.cuda
def test_process_comm_over_nccl_matches_loopback(card, tmp_path):
    """One rank a GPU, at the machine's GPU count (NCCL at world size 1 on a
    one-GPU machine): every rank's result is the loopback's."""
    import numpy as np

    from tpu_euler_torch.dist.launch import assemble_rank, spawn_ranks
    from tpu_euler_torch.dist.mesh import LoopbackComm
    from tpu_euler_torch.dist.pipeline import assemble_reads_distributed
    from tpu_euler_torch.simulate import random_genome

    world = torch.cuda.device_count()
    reads = simulate_reads(random_genome(20_000, seed=99), 100, 30, seed=100, circular=True)
    codes = encode_reads(reads, 100)
    np.save(tmp_path / "codes.npy", codes)
    cfg = AssemblyConfig(k=31, read_batch=512, read_len=100, spectrum_capacity=1 << 18)
    want = assemble_reads_distributed(None, cfg, LoopbackComm(world, card), codes=codes)
    for got in spawn_ranks(world, "cuda", assemble_rank, (str(tmp_path / "codes.npy"), cfg), timeout_s=300):
        assert got.contigs == want.contigs and got.n_kmers_counted == want.n_kmers_counted
    with pytest.raises(ValueError, match=f"requested {world + 1} devices, have {world}"):
        spawn_ranks(world + 1, "cuda", assemble_rank, ("none.npy", cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [31, 41])
def test_sharded_traversal_on_card_matches_cpu(card, k):
    """Cutoff, tips, bubbles and the traversal sharded over four ranks held
    on the one card: every field of the first chains step equals the CPU's,
    and the pipeline's contigs equal the CPU's and the single-device run's."""
    from tpu_euler_torch.dist import traverse_dist as td
    from tpu_euler_torch.dist.mesh import LoopbackComm
    from tpu_euler_torch.dist.pipeline import assemble_reads_distributed
    from tpu_euler_torch.pipeline.assemble import assemble_codes

    reads = simulate_reads(adversarial_genome(30_000, 5150), 100, 40, seed=5151, error_rate=0.003, circular=False)
    codes = encode_reads(reads, 100)
    cfg = AssemblyConfig(
        k=k, min_count=3, tip_rounds=3, bubble_rounds=2, read_batch=1024, read_len=100, spectrum_capacity=1 << 18
    )
    runs = [assemble_reads_distributed(None, cfg, LoopbackComm(4, d), codes=codes, shard_traversal=True) for d in (card, "cpu")]
    single = assemble_codes(codes, cfg, card)
    for other in (runs[1], single):
        assert runs[0].contigs == other.contigs and runs[0].n_distinct_kmers == other.n_distinct_kmers
    assert len(runs[0].contigs) > 1
    # the chains of one spectrum, field by field
    c_local = 1 << 14
    spec = apply_cutoff(count_spectrum(codes, cfg, "cpu")[0], 3)
    owner = td.keys.bucket_hash(spec.words[: spec.n], td.keys.nlimbs(k)) % 4
    chains = []
    for device in (card, "cpu"):
        words, ns = [], []
        for r in range(4):
            mine = spec.words[: spec.n][owner == r]
            w = torch.zeros((c_local,) + tuple(mine.shape[1:]), dtype=torch.int64)
            w[: mine.shape[0]] = mine
            words.append(w.to(device))
            ns.append(mine.shape[0])
        chains.append(td.dist_chains_step(words, ns, LoopbackComm(4, device), k, c_local))
    for name in td.ShardChains._fields:
        for a, b in zip(getattr(chains[0], name), getattr(chains[1], name)):
            assert torch.equal(a.cpu(), b), name
    assert sum(int(d) for d in chains[0].dropped) == 0


@pytest.mark.cuda
def test_dryrun_over_nccl_ranks(card):
    """The multi-rank dry run inside one rank a GPU over NCCL, at the
    machine's GPU count: every rank passes its three phases and retries."""
    from tpu_euler_torch import entry
    from tpu_euler_torch.dist.launch import spawn_ranks

    world = torch.cuda.device_count()
    summaries = spawn_ranks(world, "cuda", entry.dryrun_rank, timeout_s=600)
    assert all(s == summaries[0] and s["retries"] >= 1 and s["ranks"] == world for s in summaries)


def _emit_on_card(card, contigs, k, twin=None):
    """The canonical emission kernel on the card and its plain version on
    the CPU, from the same inputs: both buffers (the card's on the host),
    and the kernel's launches."""
    from tpu_euler_torch.euler import emit_kernel

    codes, off, sw, n, total = emission_inputs(contigs, k, junk_seed=k)
    before = trace.totals()
    got = emit_kernel.canonical_bytes(codes.to(card), off.to(card), sw.to(card), n, total, k,
                                      None if twin is None else twin.to(card))
    torch.cuda.synchronize()
    launches = trace.since(before)["emit_canonical_launches"]
    return got.cpu(), emit_kernel.canonical_bytes_plain(codes, off, sw, n, total, k, twin), launches


@pytest.mark.cuda
@pytest.mark.parametrize("k", [21, 31, 41, 63])
@pytest.mark.parametrize("case", list(contig_cases(21)))
def test_emit_kernel_matches_plain_on_card(card, k, case):
    """The canonical emission kernel's buffer (offsets, the second pass's
    count, the twins' repeats, the canonical bytes) equals its plain
    version's bit for bit, in three launches."""
    twin = torch.tensor(TWIN_CASES[case]) if case in TWIN_CASES else None
    got, want, launches = _emit_on_card(card, contig_cases(k)[case], k, twin)
    assert torch.equal(got, want)
    assert launches == 3


@pytest.mark.cuda
@pytest.mark.parametrize("sizes", [[4_641_682], [15_072_474, 13_834, 2_000_001]])
def test_emit_kernel_matches_plain_at_genome_size(card, sizes):
    """Chromosome-sized contigs, each beside its reverse complement (its
    twin), one of them its own mirror 5,000 bases deep: bit for bit."""
    from tpu_euler_torch.simulate import random_genome

    contigs, twin = [], []
    for i, size in enumerate(sizes):
        x = random_genome(size, seed=90 + i)
        if i == 1:
            x = x[:5000] + x[5000:-5000] + rc(x[:5000])
        contigs += [x, rc(x)]
        twin += [2 * i + 1, 2 * i]
    got, want, launches = _emit_on_card(card, contigs, 41, torch.tensor(twin))
    assert torch.equal(got, want) and launches == 3
