"""The port's command line: the cases of tests/integration/test_cli.py
through ``tpu_euler_torch.cli.main([..., "--device", "cpu"])``, the contigs
FASTA equal to the reference CLI's on the same file, the same metrics keys,
and the port's own rules for ``--device`` and ``--mesh`` (spawned gloo ranks,
a launcher's ranks, resumes, ``--shard-traversal``)."""

import json

import pytest

from tpu_euler import cli as ref_cli
from tpu_euler.reference_impl.oracle import assemble_oracle
from tpu_euler.reference_impl.simulate import random_genome, simulate_reads
from tpu_euler_torch.cli import main
from tpu_euler_torch.io.fastx import read_fasta
from tpu_euler_torch.verify.compare import canonical_contig_set, contig_sets_equal

CPU = ["--device", "cpu"]


def _write_fq(path, reads, quals=None):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{quals[i] if quals else 'I' * len(r)}\n")


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    reads = simulate_reads(random_genome(2500, seed=301), read_len=90, coverage=20, seed=302, circular=True)
    _write_fq(d / "reads.fq", reads)
    return str(d / "reads.fq"), reads, str(d)


@pytest.fixture(scope="module")
def errored(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_err")
    reads = simulate_reads(random_genome(2500, seed=311), read_len=90, coverage=30, seed=312, error_rate=0.004)
    _write_fq(d / "reads.fq", reads)
    return str(d / "reads.fq"), reads, str(d)


def run(cli_main, argv, capsys):
    rc = cli_main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1]) if out else None


def contigs(path):
    return [s for _, s in read_fasta(path)]


def test_assemble_matches_oracle_and_reference_cli(fastq, capsys):
    path, reads, d = fastq
    argv = ["assemble", path, "-k", "21", "--read-batch", "256"]
    rc, m = run(main, argv + ["-o", f"{d}/out.fa", "--metrics-json", f"{d}/m.json"] + CPU, capsys)
    assert rc == 0 and m["contigs"] >= 1 and m["reads"] == len(reads)
    assert canonical_contig_set(contigs(f"{d}/out.fa")) == assemble_oracle(reads, 21)
    rc, ref = run(ref_cli.main, argv + ["-o", f"{d}/ref.fa"], capsys)
    assert rc == 0
    assert open(f"{d}/out.fa").read() == open(f"{d}/ref.fa").read()
    assert list(m) == list(ref) and set(m["stages_s"]) == set(ref["stages_s"])
    for key in ("reads", "kmers_counted", "distinct_kmers", "contigs", "longest_contig"):
        assert m[key] == ref[key], key
    assert json.load(open(f"{d}/m.json")) == m


@pytest.mark.parametrize("circular", [False, True])
def test_assemble_k77_on_150_base_reads(tmp_path, capsys, circular):
    """``assemble -k 77`` on 150-base reads (three-word keys, the plant
    cell's shape): the oracle's contigs and the reference CLI's file."""
    reads = simulate_reads(random_genome(3000, seed=321), read_len=150, coverage=20, seed=322, circular=circular)
    _write_fq(tmp_path / "reads.fq", reads)
    argv = ["assemble", str(tmp_path / "reads.fq"), "-k", "77", "--read-batch", "128"]
    rc, m = run(main, argv + ["-o", str(tmp_path / "out.fa")] + CPU, capsys)
    assert rc == 0 and m["contigs"] == 1 and m["reads"] == len(reads)
    assert m["kmers_counted"] == len(reads) * (150 - 77 + 1)
    assert canonical_contig_set(contigs(tmp_path / "out.fa")) == assemble_oracle(reads, 77)
    rc, ref = run(ref_cli.main, argv + ["-o", str(tmp_path / "ref.fa")], capsys)
    assert rc == 0 and open(tmp_path / "out.fa").read() == open(tmp_path / "ref.fa").read()
    assert (m["distinct_kmers"], m["longest_contig"]) == (ref["distinct_kmers"], ref["longest_contig"])


@pytest.mark.parametrize("read_batch", [8192, 262144])
@pytest.mark.parametrize("free_bytes", [None, 80 * 10**9])
def test_automatic_capacity_at_plant_scale(read_batch, free_bytes):
    """40x of A. thaliana's 119,667,750 bp in 150-base reads: 31,911,400
    reads, 4.79 G bases, whose 2^32 the grouped count's arena refuses. The
    automatic capacity is cut to the arena's row guard and, on an 80 GB
    card, to a drain's bytes, and still holds the genome's 119.7 M
    distinct 77-mers; a small input keeps the rule of the bases."""
    from tpu_euler_torch.cli import _capacity
    from tpu_euler_torch.config import AssemblyConfig
    from tpu_euler_torch.pipeline import assemble

    n_reads = 31_911_400
    cfg = AssemblyConfig(k=77, read_len=150, read_batch=read_batch)
    group = cfg.oneshot_rows // (read_batch * 74) * (read_batch * 74)
    with pytest.raises(ValueError, match="counting arena"):
        assemble.arena_rows(1 << 32, group)
    C = _capacity(n_reads * 150, n_reads, cfg, free_bytes)
    assert 119_667_750 < C < 1 << 32
    assert assemble.arena_rows(C, group) == C + group
    if free_bytes:
        per_row = 3 * assemble.DRAIN_BYTES_PER_WORD + assemble.DRAIN_BYTES_PER_ROW
        assert (C + group) * per_row <= free_bytes * 3 // 4
    assert _capacity(60_000, 400, cfg, free_bytes) == 1 << 15


def test_assemble_where_the_bases_outgrow_the_arena(tmp_path, capsys, monkeypatch):
    """The plant's case in small: groups of two batches of 128 reads and a
    row guard of 40,000 rows, which the capacity from the bases read
    (32,768) and a group (18,944) together pass. The CLI cuts the capacity
    to the guard and assembles the oracle's contig."""
    import functools

    from tpu_euler_torch import config
    from tpu_euler_torch.kmer import keys

    reads = simulate_reads(random_genome(3000, seed=331), read_len=150, coverage=20, seed=332)
    _write_fq(tmp_path / "reads.fq", reads)
    monkeypatch.setattr(config, "AssemblyConfig", functools.partial(config.AssemblyConfig, oneshot_rows=2 * 128 * 74))
    monkeypatch.setattr(keys, "SORT_ROWS_LIMIT", 40_000)
    argv = ["assemble", str(tmp_path / "reads.fq"), "-k", "77", "--read-batch", "128", "-o", str(tmp_path / "out.fa")]
    rc, m = run(main, argv + CPU, capsys)
    assert rc == 0 and m["contigs"] == 1 and m["reads"] == len(reads) == 400
    assert canonical_contig_set(contigs(tmp_path / "out.fa")) == assemble_oracle(reads, 77)


def test_assemble_with_cleaning_matches_reference_cli(errored, capsys):
    path, reads, d = errored
    argv = ["assemble", path, "-k", "31", "--min-count", "4", "--tip-rounds", "3", "--bubble-rounds", "2"]
    rc, m = run(main, argv + ["-o", f"{d}/out.fa"] + CPU, capsys)
    assert rc == 0 and "tips" in m["stages_s"]
    want = assemble_oracle(reads, 31, 4, tip_rounds=3, bubble_rounds=2)
    assert canonical_contig_set(contigs(f"{d}/out.fa")) == want
    rc, ref = run(ref_cli.main, argv + ["-o", f"{d}/ref.fa"], capsys)
    assert rc == 0 and contigs(f"{d}/out.fa") == contigs(f"{d}/ref.fa")
    assert list(m["stages_s"]) == list(ref["stages_s"])
    assert (m["distinct_kmers"], m["kmers_counted"]) == (ref["distinct_kmers"], ref["kmers_counted"])
    # explicit thresholds reach the cleaning passes
    rc, _ = run(main, argv + ["-o", f"{d}/t.fa", "--tip-len", "5", "--bubble-len", "5"] + CPU, capsys)
    assert rc == 0
    assert canonical_contig_set(contigs(f"{d}/t.fa")) == assemble_oracle(
        reads, 31, 4, tip_rounds=3, tip_len=5, bubble_rounds=2, bubble_len=5
    )


def test_save_and_resume_spectrum(errored, capsys):
    path, reads, d = errored
    clean = ["-k", "21", "--min-count", "3", "--tip-rounds", "2", "--bubble-rounds", "1"]
    rc, m1 = run(main, ["assemble", path, "-o", f"{d}/a.fa", "--save-spectrum", f"{d}/spec.npz"] + clean + CPU, capsys)
    assert rc == 0
    rc, m2 = run(main, ["assemble", path, "-o", f"{d}/b.fa", "--resume-spectrum", f"{d}/spec.npz"] + clean + CPU, capsys)
    assert rc == 0 and contigs(f"{d}/a.fa") == contigs(f"{d}/b.fa")
    assert m2["distinct_kmers"] == m1["distinct_kmers"] and m2["reads"] == 0
    # the spectrum's counts, read before the spectrum is handed over
    assert m2["kmers_counted"] == m1["kmers_counted"]
    assert "count" not in m2["stages_s"] and "tips" in m2["stages_s"]
    # the reference resumes from the port's checkpoint, and the reverse
    rc, m3 = run(ref_cli.main, ["assemble", path, "-o", f"{d}/c.fa", "--resume-spectrum", f"{d}/spec.npz"] + clean, capsys)
    assert rc == 0 and contigs(f"{d}/c.fa") == contigs(f"{d}/a.fa") and m3["kmers_counted"] == m1["kmers_counted"]
    rc, _ = run(ref_cli.main, ["assemble", path, "-o", f"{d}/d.fa", "--save-spectrum", f"{d}/ref_spec.npz"] + clean, capsys)
    rc, m4 = run(main, ["assemble", path, "-o", f"{d}/e.fa", "--resume-spectrum", f"{d}/ref_spec.npz"] + clean + CPU, capsys)
    assert rc == 0 and contigs(f"{d}/e.fa") == contigs(f"{d}/a.fa") and m4["kmers_counted"] == m1["kmers_counted"]
    # wrong k refuses
    rc, _ = run(main, ["assemble", path, "-k", "23", "-o", f"{d}/f.fa", "--resume-spectrum", f"{d}/spec.npz"] + CPU, capsys)
    assert rc == 1


def test_save_and_resume_graph(fastq, capsys):
    path, reads, d = fastq
    rc, m1 = run(main, ["assemble", path, "-k", "21", "-o", f"{d}/g1.fa", "--read-batch", "256", "--save-graph", f"{d}/graph.npz"] + CPU, capsys)
    assert rc == 0
    rc, m2 = run(main, ["assemble", path, "-k", "21", "-o", f"{d}/g2.fa", "--resume-graph", f"{d}/graph.npz"] + CPU, capsys)
    assert rc == 0
    assert list(m2["stages_s"]) == ["extract"]
    assert contigs(f"{d}/g2.fa") == contigs(f"{d}/g1.fa")
    assert (m2["distinct_kmers"], m2["reads"], m2["kmers_counted"]) == (m1["distinct_kmers"], 0, 0)
    rc, _ = run(ref_cli.main, ["assemble", path, "-k", "21", "-o", f"{d}/g3.fa", "--resume-graph", f"{d}/graph.npz"], capsys)
    assert rc == 0 and contigs(f"{d}/g3.fa") == contigs(f"{d}/g1.fa")
    rc, _ = run(main, ["assemble", path, "-k", "31", "-o", f"{d}/g4.fa", "--resume-graph", f"{d}/graph.npz"] + CPU, capsys)
    assert rc == 1


def test_min_qual_masks_bad_bases(tmp_path, capsys):
    genome = random_genome(1200, seed=401)
    reads = simulate_reads(genome, read_len=80, coverage=20, seed=402, circular=True)
    bad, quals = [], []
    for i, r in enumerate(reads):
        r, q = list(r), ["I"] * len(r)
        if i % 3 == 0:  # a wrong base, flagged by a low quality
            r[37] = "ACGT"[("ACGT".index(r[37]) + 1) % 4]
            q[37] = "#"
        bad.append("".join(r))
        quals.append("".join(q))
    _write_fq(tmp_path / "q.fq", bad, quals)
    for name in ("q.fq", "q.fq.gz"):  # the native codec, then the Python parser
        if name.endswith(".gz"):
            import gzip

            with gzip.open(tmp_path / name, "wt") as f:
                f.write((tmp_path / "q.fq").read_text())
        rc = main(["assemble", str(tmp_path / name), "-k", "21", "-o", str(tmp_path / "q.fa"), "--read-batch", "256", "--min-qual", "10"] + CPU)
        capsys.readouterr()
        assert rc == 0
        assert canonical_contig_set(contigs(str(tmp_path / "q.fa"))) == assemble_oracle(reads, 21)


def test_tour(fastq, capsys):
    path, reads, d = fastq
    rc, m = run(main, ["tour", path, "-k", "21", "-o", f"{d}/walks.fa"] + CPU, capsys)
    assert rc == 0 and m["every_edge_once"] and m["chains"] >= 2
    rc, ref = run(ref_cli.main, ["tour", path, "-k", "21", "-o", f"{d}/ref_walks.fa"], capsys)
    assert rc == 0 and list(m) == list(ref)
    for key in ("edges", "nodes", "chains", "longest_chain_edges", "every_edge_once"):
        assert m[key] == ref[key], key
    walks = contigs(f"{d}/walks.fa")
    assert walks and all(len(w) >= 21 for w in walks)
    assert open(f"{d}/walks.fa").read() == open(f"{d}/ref_walks.fa").read()


@pytest.mark.parametrize("python_parser", [False, True])
def test_file_shard(fastq, capsys, monkeypatch, python_parser):
    """Shard read counts sum to the file's; 0/1 is the whole file; with
    --min-qual the Python parser byte-range-shards like the codec."""
    path, reads, d = fastq
    extra = []
    if python_parser:
        from tpu_euler_torch.io import native

        monkeypatch.setattr(native, "encode_file_shard_native", lambda *a, **k: None)
        extra = ["--min-qual", "2"]
    rc, full = run(main, ["assemble", path, "-k", "21", "-o", f"{d}/full.fa", "--file-shard", "0/1", "--read-batch", "256"] + extra + CPU, capsys)
    assert rc == 0 and full["reads"] == len(reads)
    n_shard = []
    for s in range(3):
        rc, m = run(main, ["assemble", path, "-k", "21", "-o", f"{d}/s{s}.fa", "--file-shard", f"{s}/3", "--read-batch", "256"] + extra + CPU, capsys)
        assert rc == 0
        n_shard.append(m["reads"])
    assert sum(n_shard) == len(reads) and all(n > 0 for n in n_shard)


def test_file_shard_bad_spec(fastq, capsys):
    path, _, d = fastq
    for argv in (
        ["--file-shard", "3/3"],
        ["--file-shard", "nope"],
        ["--file-shard", "nope", "--resume-spectrum", f"{d}/none.npz"],
        ["--file-shard", "0/2", "--resume-spectrum", f"{d}/none.npz"],
        ["--file-shard", "0/2", "--resume-graph", f"{d}/none.npz"],
    ):
        assert main(["assemble", path] + argv + CPU) == 1
        assert "--file-shard" in capsys.readouterr().err


def test_bad_input_exits_1_with_the_reference_messages(fastq, tmp_path, capsys):
    path, _, d = fastq
    short = tmp_path / "short.fq"
    _write_fq(short, ["ACGTACGT", "TTGCA"])
    for cmd in ("assemble", "tour"):
        assert main([cmd, str(tmp_path / "missing.fq"), "-k", "21"] + CPU) == 1
        assert "cannot read input" in capsys.readouterr().err
        assert main([cmd, str(short), "-k", "21"] + CPU) == 1
        assert "no reads of length >= k=21 found" in capsys.readouterr().err
    assert ref_cli.main(["assemble", str(short), "-k", "21"]) == 1
    assert "no reads of length >= k=21 found" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["--mesh", "8"], ["--shard-traversal"], ["--mesh", "2", "--shard-traversal"]])
def test_mesh_is_refused(fastq, capsys, argv):
    """More ranks than the host has GPUs is the reference's error.
    ``--shard-traversal`` is read only with ``--mesh``: alone it changes
    nothing, and with ``--mesh 2`` two gloo ranks traverse sharded and write
    the replicated run's contigs (these two cases were refusals while the
    sharded traversal was not ported)."""
    import torch

    path, reads, d = fastq
    if "--shard-traversal" in argv:
        base = ["assemble", path, "-k", "21", "--read-batch", "64"]
        replicated = ["--mesh", "2"] if "--mesh" in argv else []
        rc, want = run(main, base + ["-o", f"{d}/st_want.fa"] + replicated + CPU, capsys)
        assert rc == 0
        rc, m = run(main, base + ["-o", f"{d}/st.fa"] + argv + CPU, capsys)
        assert rc == 0 and open(f"{d}/st.fa").read() == open(f"{d}/st_want.fa").read()
        for key in ("reads", "kmers_counted", "distinct_kmers", "contigs", "longest_contig"):
            assert m[key] == want[key], key
        assert m["reads"] == len(reads) and set(m["stages_s"]) == set(want["stages_s"])
        if "--mesh" in argv:
            assert m["stages_s"]["gather"] == 0 and want["stages_s"]["gather"] > 0
            rc, ref = run(ref_cli.main, base + ["-o", f"{d}/st_ref.fa"] + argv, capsys)
            assert rc == 0 and open(f"{d}/st_ref.fa").read() == open(f"{d}/st.fa").read()
        return
    if torch.cuda.device_count() >= 8:
        pytest.skip("eight GPUs are visible: --mesh 8 runs")
    assert main(["assemble", path, "-k", "21", "-o", f"{d}/m.fa"] + argv) == 1
    captured = capsys.readouterr()
    want = f"requested 8 devices, have {torch.cuda.device_count()}" if torch.cuda.is_available() else "no CUDA device"
    assert want in captured.err and captured.out == ""


def test_mesh_with_shard_traversal_and_cleaning(errored, capsys):
    """Cutoff, tips and bubbles on two gloo ranks with the graph sharded:
    the single-device run's contigs and counts."""
    path, _, d = errored
    argv = ["assemble", path, "-k", "21", "--min-count", "3", "--tip-rounds", "2", "--bubble-rounds", "1", "--read-batch", "128"]
    rc, single = run(main, argv + ["-o", f"{d}/stc_single.fa"] + CPU, capsys)
    assert rc == 0
    rc, m = run(main, argv + ["-o", f"{d}/stc_mesh.fa", "--mesh", "2", "--shard-traversal"] + CPU, capsys)
    assert rc == 0 and open(f"{d}/stc_mesh.fa").read() == open(f"{d}/stc_single.fa").read()
    assert (m["reads"], m["kmers_counted"], m["distinct_kmers"]) == (single["reads"], single["kmers_counted"], single["distinct_kmers"])
    assert "tips" not in m["stages_s"] and m["stages_s"]["graph"] > 0


def test_mesh_on_cpu_ranks_writes_the_single_device_contigs(fastq, capsys):
    """``--mesh 2 --device cpu``: two gloo ranks started by the command."""
    path, reads, d = fastq
    argv = ["assemble", path, "-k", "21", "--read-batch", "64"]
    rc, single = run(main, argv + ["-o", f"{d}/single.fa"] + CPU, capsys)
    assert rc == 0
    rc, m = run(main, argv + ["-o", f"{d}/mesh.fa", "--mesh", "2", "--metrics-json", f"{d}/mesh.json"] + CPU, capsys)
    assert rc == 0 and open(f"{d}/mesh.fa").read() == open(f"{d}/single.fa").read()
    assert list(m) == list(single)
    for key in ("reads", "kmers_counted", "distinct_kmers", "contigs", "longest_contig"):
        assert m[key] == single[key], key
    assert set(m["stages_s"]) == {"encode", "count", "count_drain", "gather", "graph", "extract"}
    assert json.load(open(f"{d}/mesh.json")) == m
    # the reference's sharded CLI, on the same file
    rc, ref = run(ref_cli.main, argv + ["-o", f"{d}/ref_mesh.fa", "--mesh", "2"], capsys)
    assert rc == 0 and open(f"{d}/ref_mesh.fa").read() == open(f"{d}/mesh.fa").read()
    assert set(m["stages_s"]) == set(ref["stages_s"])


def test_mesh_with_file_shard_and_cleaning(errored, capsys):
    """``--file-shard`` picks the input, the ranks split it; cleaning runs
    on the gathered spectrum."""
    path, _, d = errored
    argv = ["assemble", path, "-k", "21", "--min-count", "3", "--tip-rounds", "2", "--file-shard", "1/2", "--read-batch", "128"]
    rc, single = run(main, argv + ["-o", f"{d}/fs_single.fa"] + CPU, capsys)
    assert rc == 0
    rc, m = run(main, argv + ["-o", f"{d}/fs_mesh.fa", "--mesh", "2"] + CPU, capsys)
    assert rc == 0 and open(f"{d}/fs_mesh.fa").read() == open(f"{d}/fs_single.fa").read()
    assert (m["reads"], m["kmers_counted"], m["distinct_kmers"]) == (single["reads"], single["kmers_counted"], single["distinct_kmers"])
    assert "tips" in m["stages_s"]


def test_resume_ignores_mesh(fastq, capsys):
    """A resume returns before ``--mesh`` is looked at, as in the reference."""
    path, _, d = fastq
    base = ["assemble", path, "-k", "21", "--read-batch", "256"]
    rc, m1 = run(main, base + ["-o", f"{d}/r1.fa", "--save-spectrum", f"{d}/r_spec.npz", "--save-graph", f"{d}/r_graph.npz"] + CPU, capsys)
    assert rc == 0
    for resume in (["--resume-spectrum", f"{d}/r_spec.npz"], ["--resume-graph", f"{d}/r_graph.npz"]):
        rc, m2 = run(main, base + ["-o", f"{d}/r2.fa", "--mesh", "64"] + resume + CPU, capsys)
        assert rc == 0 and contigs(f"{d}/r2.fa") == contigs(f"{d}/r1.fa")
        assert m2["reads"] == 0 and "gather" not in m2["stages_s"]
        rc, m3 = run(ref_cli.main, base + ["-o", f"{d}/r3.fa", "--mesh", "64"] + resume, capsys)
        assert rc == 0 and contigs(f"{d}/r3.fa") == contigs(f"{d}/r1.fa")


def _launch_two_ranks(path, tmp_path, extra=()):
    """``python -m tpu_euler_torch.cli assemble --mesh 2`` as two processes
    with RANK / WORLD_SIZE set, as ``torchrun`` sets them. Returns (each
    rank's standard output, the port, the repository root)."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    with socket.socket() as s:  # a free port, not a fixed one
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = str(Path(__file__).resolve().parents[2])
    procs = []
    for rank in range(2):
        env = dict(
            os.environ, RANK=str(rank), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
            PYTHONPATH=root, OMP_NUM_THREADS="1",
        )
        argv = ["assemble", path, "-k", "21", "--read-batch", "64", "--mesh", "2", "-o", str(tmp_path / f"rank{rank}.fa")]
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tpu_euler_torch.cli"] + argv + list(extra) + CPU, env=env, cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err
            outs.append(out.strip())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs, port, root


def test_mesh_under_a_launcher_with_shard_traversal(fastq, tmp_path):
    """A launcher's two ranks, each with its own shard of the file, with
    the traversal sharded: the ranks exchange their contig fragments, and
    rank 0 writes the single-device run's contigs."""
    path, reads, d = fastq
    assert main(["assemble", path, "-k", "21", "--read-batch", "64", "-o", f"{d}/ls_single.fa"] + CPU) == 0
    outs, _, _ = _launch_two_ranks(path, tmp_path, ["--shard-traversal"])
    m = json.loads(outs[0].splitlines()[-1])
    assert m["reads"] == len(reads) and outs[1] == "" and m["stages_s"]["gather"] == 0
    assert (tmp_path / "rank0.fa").read_text() == open(f"{d}/ls_single.fa").read()
    assert not (tmp_path / "rank1.fa").exists()


def test_mesh_under_a_launcher_joins_its_group(fastq, tmp_path):
    """RANK / WORLD_SIZE set, as ``torchrun`` sets them: each process is one
    rank, parses its own shard of the file, and rank 0 writes the output."""
    import os
    import subprocess
    import sys

    path, reads, d = fastq
    assert main(["assemble", path, "-k", "21", "--read-batch", "64", "-o", f"{d}/l_single.fa"] + CPU) == 0
    outs, port, root = _launch_two_ranks(path, tmp_path)
    m = json.loads(outs[0].splitlines()[-1])
    assert m["reads"] == len(reads) and outs[1] == ""
    assert (tmp_path / "rank0.fa").read_text() == open(f"{d}/l_single.fa").read()
    assert not (tmp_path / "rank1.fa").exists()
    # a mesh that is not the group's size is refused on every rank
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), PYTHONPATH=root)
    out = subprocess.run(
        [sys.executable, "-m", "tpu_euler_torch.cli", "assemble", path, "-k", "21", "--mesh", "2", "-o", str(tmp_path / "no.fa")] + CPU,
        env=env, cwd=root, capture_output=True, text=True, timeout=240,
    )
    assert out.returncode == 1 and "--mesh 2 in a process group of 1 ranks" in out.stderr


@pytest.mark.parametrize("cmd", ["assemble", "tour"])
def test_default_device_without_a_card_exits_nonzero(fastq, capsys, cmd):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device runs")
    path, _, d = fastq
    assert main([cmd, path, "-k", "21", "-o", f"{d}/never.fa"]) != 0
    captured = capsys.readouterr()
    assert "no CUDA device" in captured.err and captured.out == ""
    import os

    assert not os.path.exists(f"{d}/never.fa")


def test_profile_writes_a_trace(fastq, tmp_path, capsys):
    path, _, d = fastq
    rc, _ = run(main, ["assemble", path, "-k", "21", "-o", f"{d}/p.fa", "--profile", str(tmp_path / "prof")] + CPU, capsys)
    assert rc == 0 and (tmp_path / "prof" / "trace.json").stat().st_size > 0


def test_compare_module_keeps_the_reference_path():
    from tpu_euler.verify import compare as ref_compare

    a, b = ["ACGTT", b"ggcat"], ["AACGT", "ATGCC", "TTTT"]
    from tpu_euler_torch.verify import compare

    assert compare.canonical_contig_set(a) == ref_compare.canonical_contig_set(a)
    assert compare.diff_contig_sets(a, b) == ref_compare.diff_contig_sets(a, b)
    assert contig_sets_equal(a, b[:2]) and not contig_sets_equal(a, b)


def test_substring_gate_and_n50():
    """The indexed gate against a plain scan, on a circular and a linear
    genome; N50 on a known set."""
    from tpu_euler.reference_impl.simulate import rc
    from tpu_euler_torch.verify.compare import n50, substring_gate

    g = random_genome(5000, seed=9)
    contigs = [g[100:900], rc(g[1000:1400]).encode(), g[-100:] + g[:100], "ACGT" * 50, g[10:20], g[2000:2150][:-1] + "N"]
    for circular in (True, False):
        text = g + g if circular else g
        checked = [c.decode() if isinstance(c, bytes) else c for c in contigs if len(c) >= 150]
        ok = [c for c in checked if c in text or c in rc(text)]
        gate = substring_gate(contigs, g, 150, circular=circular)
        assert gate["contigs_total"] == 6 and gate["contigs_checked"] == len(checked) == 5
        assert gate["contigs_substring_ok"] == len(ok) == (3 if circular else 2)
        assert gate["matched_bases"] == sum(map(len, ok))
        assert gate["coverage_lower_bound"] == sum(map(len, ok)) / 5000
        assert sorted(gate["bad_contig_lens"]) == sorted(len(c) for c in checked if c not in ok)
    assert substring_gate([], g)["contigs_checked"] == 0
    assert n50([10, 5, 3, 2]) == 10 and n50([4, 4, 4, 4]) == 4 and n50([]) == 0 and n50([8, 7, 1]) == 8
