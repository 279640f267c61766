"""The command line: assemble and tour.

Counterpart of ``tpu_euler/cli.py``, with its options, messages, exit codes
and one-line metrics JSON:

    python -m tpu_euler_torch.cli assemble reads.fq -k 31 -o contigs.fa
    python -m tpu_euler_torch.cli tour reads.fq -k 21 -o walks.fa

``--device`` is the port's own option. It defaults to ``cuda``; where no
card is visible the command fails with a message rather than carry on on
the CPU, which ``--device cpu`` asks for.

``--mesh N`` counts sharded over N ranks, one rank a GPU (NCCL), or N CPU
processes with ``--device cpu`` (gloo), and traverses replicated, or, with
``--shard-traversal``, sharded too (the flag is read only with ``--mesh``).
Where a
launcher started the ranks (``torchrun``: RANK and WORLD_SIZE are set) the
command joins that group, N must be its size, each rank parses its own
byte-range shard of the input (``--file-shard I/N`` where given, else its
rank of N) and rank 0 writes the output. Otherwise the command parses the
input and starts the N ranks itself on this host.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import sys
import time


def _add_common(p, out_default: str, out_help: str):
    p.add_argument("reads", help="FASTA/FASTQ file (.gz ok)")
    p.add_argument("-k", type=int, default=31, help="k-mer length (odd)")
    p.add_argument("-o", "--out", default=out_default, help=out_help)
    p.add_argument("--min-count", type=int, default=1, help="k-mer frequency cutoff")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("-v", "--verbose", action="store_true")


def _add_assemble(sub):
    p = sub.add_parser("assemble", help="assemble reads into contigs")
    _add_common(p, "contigs.fa", "output FASTA")
    p.add_argument("--tip-rounds", type=int, default=0, help="tip-clipping rounds (0=off)")
    p.add_argument("--tip-len", type=int, default=0, help="tip threshold in edges (0=2k)")
    p.add_argument("--bubble-rounds", type=int, default=0, help="simple-bubble popping rounds (0=off)")
    p.add_argument("--bubble-len", type=int, default=0, help="bubble branch threshold in edges (0=2k)")
    p.add_argument(
        "--min-qual", type=int, default=0,
        help="mask FASTQ bases below this phred quality as N (0 = off)",
    )
    p.add_argument("--read-len", type=int, default=0, help="pad/truncate length (0=auto)")
    p.add_argument("--read-batch", type=int, default=8192)
    p.add_argument(
        "--spectrum-capacity", type=int, default=0,
        help="max distinct canonical k-mers (0 = auto from input size)",
    )
    p.add_argument("--mesh", type=int, default=0, help="ranks (one a GPU) for distributed count (0=single)")
    p.add_argument(
        "--file-shard", default="",
        help="I/N: parse only byte-range shard I of N of the input (each of N hosts reads ~1/N of the file)",
    )
    p.add_argument(
        "--shard-traversal", action="store_true",
        help="keep graph+traversal sharded across the mesh",
    )
    p.add_argument("--metrics-json", default="", help="write stage metrics to this path")
    p.add_argument("--save-spectrum", default="", help="checkpoint counted k-mer spectrum (.npz)")
    p.add_argument(
        "--resume-spectrum", default="",
        help="resume from a spectrum checkpoint (skips read counting)",
    )
    p.add_argument("--save-graph", default="", help="checkpoint graph + unitig chains (.npz)")
    p.add_argument(
        "--resume-graph", default="",
        help="resume from a graph checkpoint (skips counting AND graph/traversal)",
    )
    p.add_argument("--profile", default="", help="write a torch.profiler trace into this dir")


def _add_tour(sub):
    p = sub.add_parser(
        "tour",
        help="compute an Eulerian tour / path cover of the de Bruijn graph and report circuit statistics",
    )
    _add_common(p, "", "write tour walks as FASTA")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpu-euler-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_assemble(sub)
    _add_tour(sub)
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s %(name)s %(message)s",
    )
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device (--device cpu runs on the CPU)", file=sys.stderr)
        return 1
    return _run_assemble(args, device) if args.cmd == "assemble" else _run_tour(args, device)


def _fail(message: str):
    print(message, file=sys.stderr)
    return None, 0.0


def _capacity(total_bases: int, n_reads: int, cfg, free_bytes: int | None = None) -> int:
    """Distinct k-mers are at most about the bases read: the power of two
    at or above half of them, at least 2^14, and no more than the count of
    the reads with ``cfg`` holds (its key sort's rows and, on a card, its
    free bytes: 40x of a 120 Mbp genome is 4.8 G bases, and no arena takes
    their 2^32)."""
    from tpu_euler_torch.pipeline.assemble import count_capacity_limit

    want = 1 << max(14, (2 * total_bases).bit_length() - 2)
    return min(want, count_capacity_limit(cfg, n_reads, free_bytes))


def _free_bytes(device) -> int | None:
    """The card's free bytes before the assembly allocates; None on the CPU."""
    import torch

    return torch.cuda.mem_get_info(device)[0] if device.type == "cuda" else None


def _run_tour(args, device) -> int:
    import numpy as np

    from tpu_euler_torch.config import AssemblyConfig
    from tpu_euler_torch.euler.extract import decode_bases_np
    from tpu_euler_torch.euler.tour import eulerian_tour
    from tpu_euler_torch.graph.build import build_graph
    from tpu_euler_torch.io.encode import encode_reads
    from tpu_euler_torch.io.fastx import read_fastx, write_fasta
    from tpu_euler_torch.kmer.count import apply_cutoff
    from tpu_euler_torch.pipeline.assemble import count_spectrum

    try:
        reads = [seq for _, seq in read_fastx(args.reads) if len(seq) >= args.k]
    except FileNotFoundError as e:
        print(f"error: cannot read input: {e}", file=sys.stderr)
        return 1
    if not reads:
        print(f"no reads of length >= k={args.k} found", file=sys.stderr)
        return 1
    read_len = max(len(r) for r in reads)
    cfg = AssemblyConfig(k=args.k, min_count=args.min_count, read_len=read_len)
    cfg = dataclasses.replace(
        cfg, spectrum_capacity=_capacity(sum(len(r) for r in reads), len(reads), cfg, _free_bytes(device))
    )
    t0 = time.perf_counter()
    acc, _ = count_spectrum(encode_reads(reads, read_len), cfg, device)
    g = build_graph(apply_cutoff(acc, cfg.min_count), cfg.k)
    tour = eulerian_tour(g)

    valid = tour.in_tour.cpu().numpy()
    chain = tour.chain.cpu().numpy()[valid]
    pos = tour.pos.cpu().numpy()[valid]
    length = tour.length.cpu().numpy()[valid]
    uchain, inv = np.unique(chain, return_inverse=True)
    chain_lens = np.zeros(uchain.size, dtype=np.int64)
    np.maximum.at(chain_lens, inv, length)
    # every edge is used exactly once iff the (chain, pos) pairs are distinct
    every_edge_once = np.unique(np.stack([chain, pos], axis=1), axis=0).shape[0] == int(valid.sum())
    metrics = {
        "edges": int(valid.sum()),
        "nodes": g.n_nodes,
        "chains": tour.n_chains,
        "longest_chain_edges": int(chain_lens.max(initial=0)),
        "every_edge_once": bool(every_edge_once),
        "wall_s": round(time.perf_counter() - t0, 3),
    }
    print(json.dumps(metrics))

    if args.out:
        words = g.edge_words.cpu().numpy()[valid]
        lastb = np.frombuffer(b"ACGT", dtype=np.uint8)[words.reshape(words.shape[0], -1)[:, -1] & 3]
        # the edges of chain c are order[bnd[c]:bnd[c+1]]
        order = np.lexsort((pos, chain))
        bnd = np.concatenate([[0], np.cumsum(np.bincount(inv, minlength=uchain.size))])
        prefixes = decode_bases_np(words[order[bnd[:-1]]], args.k - 1, args.k)
        walks = [
            prefixes[c].tobytes().decode() + lastb[order[bnd[c] : bnd[c + 1]]].tobytes().decode()
            for c in range(uchain.size)
        ]
        walks.sort(key=len, reverse=True)
        write_fasta(args.out, walks, prefix="walk")
    return 0


def _parse_file_shard(args):
    """(ok, (i, n) or None) of ``--file-shard``."""
    if not args.file_shard:
        return True, None
    try:
        i, n = (int(x) for x in args.file_shard.split("/"))
        if not 0 <= i < n:
            raise ValueError
    except ValueError:
        print(f"bad --file-shard {args.file_shard!r}: want I/N with 0<=I<N", file=sys.stderr)
        return False, None
    if args.resume_spectrum or args.resume_graph:
        print(
            "--file-shard cannot be combined with --resume-spectrum/"
            "--resume-graph (the checkpoint already fixes the input)",
            file=sys.stderr,
        )
        return False, None
    return True, (i, n)


def _read_codes(args, file_shard):
    """The input as ([R, read_len] int8 codes, bases read), through the
    native codec where it serves and the Python parser elsewhere; both cut a
    shard at the same records. None where no read is as long as k."""
    from tpu_euler_torch.io import fastx
    from tpu_euler_torch.io import native
    from tpu_euler_torch.io.encode import encode_reads, encode_reads_with_qual

    opts = dict(read_len=args.read_len, min_qual=args.min_qual, min_len_keep=args.k)
    if file_shard is not None:
        codes = native.encode_file_shard_native(args.reads, *file_shard, **opts)
    else:
        codes = native.encode_file_native(args.reads, **opts)
    if codes is not None:
        return (codes, int((codes != 4).sum())) if codes.shape[0] else None

    if args.min_qual > 0 and fastx.is_fastq(args.reads):
        if file_shard is not None:
            recs = fastx.read_shard_with_qual(args.reads, *file_shard)
        else:
            recs = fastx.read_fastq_with_qual(args.reads)
        recs = [(s, q) for _, s, q in recs if len(s) >= args.k]
        reads, quals = [s for s, _ in recs], [q for _, q in recs]
    else:
        recs = fastx.read_shard(args.reads, *file_shard) if file_shard is not None else fastx.read_fastx(args.reads)
        reads, quals = [s for _, s in recs if len(s) >= args.k], None
    if not reads:
        return None
    read_len = args.read_len or max(len(r) for r in reads)
    if quals is not None:
        codes = encode_reads_with_qual(reads, quals, read_len, args.min_qual)
    else:
        codes = encode_reads(reads, read_len)
    return codes, sum(len(r) for r in reads)


def _assemble_with_args(args, device, t0):
    """Read the input or a checkpoint and assemble. Returns (result, seconds
    spent parsing), or (None, 0.0) after printing why."""
    from tpu_euler_torch import trace
    from tpu_euler_torch.config import AssemblyConfig
    from tpu_euler_torch.euler.extract import chains_to_contigs_device
    from tpu_euler_torch.pipeline.assemble import AssemblyResult, count_spectrum, spectrum_to_contigs
    from tpu_euler_torch.pipeline.checkpoint import load_graph, load_spectrum, save_spectrum

    # an invalid --file-shard fails even where a resume would return early
    ok, file_shard = _parse_file_shard(args)
    if not ok:
        return None, 0.0
    def cleaning():
        return dict(
            tip_rounds=args.tip_rounds, tip_len=args.tip_len,
            bubble_rounds=args.bubble_rounds, bubble_len=args.bubble_len,
        )

    t: dict = {}
    if args.resume_graph:
        g, chains, k = load_graph(args.resume_graph, device)
        if k != args.k:
            return _fail(f"checkpoint is k={k}, requested k={args.k}")
        with trace.assembly() as tr, trace.stage_times(t):
            contigs = chains_to_contigs_device(g, chains, k)
        return AssemblyResult(contigs, g.n_edges // 2, 0, 0, t, tr), time.perf_counter() - t0

    if args.resume_spectrum:
        spec, k = load_spectrum(args.resume_spectrum, device)
        if k != args.k:
            return _fail(f"checkpoint is k={k}, requested k={args.k}")
        cfg = AssemblyConfig(
            k=args.k, min_count=args.min_count, read_len=max(args.read_len, args.k),
            spectrum_capacity=spec.words.shape[0], **cleaning(),
        )
        # read before spectrum_to_contigs takes the spectrum over
        n_counted = int(spec.counts.sum())
        holder = [spec]
        del spec
        with trace.assembly() as tr:
            contigs, n_cut = spectrum_to_contigs(holder, cfg, t)
        return AssemblyResult(contigs, n_cut, n_counted, 0, t, tr), time.perf_counter() - t0

    if args.mesh and "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return _assemble_as_rank(args, device, file_shard, cleaning(), t0)

    read = _read_codes(args, file_shard)
    if read is None:
        return _fail(f"no reads of length >= k={args.k} found")
    codes, total_bases = read
    cfg = AssemblyConfig(
        k=args.k, min_count=args.min_count, read_batch=args.read_batch, read_len=codes.shape[1],
        spectrum_capacity=args.spectrum_capacity, **cleaning(),
    )
    if not args.spectrum_capacity:
        # a parent that spawns ranks leaves the card untouched until they start
        free = None if args.mesh else _free_bytes(device)
        cfg = dataclasses.replace(cfg, spectrum_capacity=_capacity(total_bases, codes.shape[0], cfg, free))
    t_parse = time.perf_counter() - t0
    if args.mesh:
        return _assemble_on_spawned_ranks(args.mesh, device, codes, cfg, args.shard_traversal), t_parse
    with trace.assembly() as tr:
        acc, n_windows = count_spectrum(codes, cfg, device, t)
        if args.save_spectrum:
            save_spectrum(args.save_spectrum, acc, cfg.k)
        holder = [acc]
        del acc
        contigs, n_cut = spectrum_to_contigs(holder, cfg, t, save_graph_path=args.save_graph)
    return AssemblyResult(contigs, n_cut, n_windows, codes.shape[0], t, tr), t_parse


def _assemble_on_spawned_ranks(world: int, device, codes, cfg, shard_traversal: bool = False):
    """Start ``world`` ranks on this host, hand them the parsed input as a
    file to map, and return rank 0's result (every rank's is the same);
    None, after printing why, where the host has too few devices."""
    import tempfile

    import numpy as np

    from tpu_euler_torch.dist.launch import assemble_rank, spawn_ranks
    from tpu_euler_torch.dist.mesh import rank_device

    try:
        rank_device(device.type, 0, world)
    except ValueError as e:
        return _fail(f"error: --mesh {world}: {e}")[0]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "codes.npy")
        np.save(path, codes)
        args = (path, cfg, False, False, shard_traversal)
        return spawn_ranks(world, device.type, assemble_rank, args, timeout_s=24 * 3600.0)[0]


def _assemble_as_rank(args, device, file_shard, cleaning: dict, t0):
    """One rank of a launcher's process group: parse this rank's shard of
    the input, agree with the others on the read length and the spectrum's
    capacity, and assemble with ``local_input``. Returns (result, seconds
    spent parsing), the same on every rank. A rank that raises leaves the
    group open: closing it could wait for ranks inside a collective, and
    the launcher ends them."""
    import numpy as np

    from tpu_euler_torch.config import AssemblyConfig
    from tpu_euler_torch.dist.mesh import init_process_comm
    from tpu_euler_torch.dist.pipeline import assemble_reads_distributed

    comm = init_process_comm(device.type)
    if args.mesh != comm.world:
        comm.close()
        return _fail(f"--mesh {args.mesh} in a process group of {comm.world} ranks")
    read = _read_codes(args, file_shard or (comm.ranks[0], comm.world))
    codes, total_bases = read if read is not None else (np.empty((0, 1), np.int8), 0)
    sizes = comm.process_allgather([codes.shape[0], codes.shape[1], total_bases])
    if not sizes[:, 0].sum():
        comm.close()
        return _fail(f"no reads of length >= k={args.k} found")
    read_len = int(sizes[sizes[:, 0] > 0, 1].max())
    if codes.shape[0] == 0:
        codes = np.empty((0, read_len), np.int8)
    elif codes.shape[1] < read_len:
        codes = np.pad(codes, ((0, 0), (0, read_len - codes.shape[1])), constant_values=4)
    cfg = AssemblyConfig(
        k=args.k, min_count=args.min_count, read_batch=args.read_batch, read_len=read_len,
        spectrum_capacity=args.spectrum_capacity, **cleaning,
    )
    if not args.spectrum_capacity:
        total_bases, n_reads = int(sizes[:, 2].sum()), int(sizes[:, 0].sum())
        cfg = dataclasses.replace(cfg, spectrum_capacity=_capacity(total_bases, n_reads, cfg))
    t_parse = time.perf_counter() - t0
    result = assemble_reads_distributed(
        None, cfg, comm, codes=codes, local_input=True, shard_traversal=args.shard_traversal
    )
    comm.close()
    return result, t_parse


@contextlib.contextmanager
def _profiled(trace_dir: str, device):
    """A ``torch.profiler`` trace of the block into ``trace_dir/trace.json``."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def _write_spans(trace_dir: str, result) -> None:
    """A single-device assembly's spans, from every thread, and its
    counters (``trace.Trace.to_json``) into ``trace_dir/spans.json``."""
    if trace_dir and result.trace is not None:
        with open(os.path.join(trace_dir, "spans.json"), "w") as f:
            json.dump(result.trace.to_json(), f)


def _run_assemble(args, device) -> int:
    from tpu_euler_torch.io.fastx import write_fasta

    t0 = time.perf_counter()
    try:
        with _profiled(args.profile, device):
            result, t_parse = _assemble_with_args(args, device, t0)
    except FileNotFoundError as e:
        print(f"error: cannot read input: {e}", file=sys.stderr)
        return 1
    if result is None:
        return 1
    _write_spans(args.profile, result)
    if args.mesh and int(os.environ.get("RANK", "0")) != 0:
        return 0  # a launcher's rank 0 writes the output, the same on every rank

    contigs = sorted(result.contig_strings, key=len, reverse=True)
    write_fasta(args.out, contigs)

    wall = time.perf_counter() - t0
    metrics = {
        "reads": result.n_reads,
        "kmers_counted": result.n_kmers_counted,
        "distinct_kmers": result.n_distinct_kmers,
        "contigs": len(contigs),
        "longest_contig": max((len(c) for c in contigs), default=0),
        "wall_s": round(wall, 3),
        "parse_s": round(t_parse, 3),
        "stages_s": {s: round(v, 3) for s, v in result.stage_seconds.items()},
        "kmers_per_s": round(result.n_kmers_counted / max(wall, 1e-9)),
        "reads_per_s": round(result.n_reads / max(wall, 1e-9)),
    }
    print(json.dumps(metrics))
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(metrics, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
