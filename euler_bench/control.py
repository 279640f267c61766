#!/usr/bin/env python3
"""The control of the comparison: the reference, put in the assembler's
place, with one stated guarantee broken, must come out not correct.

The assembler states no precision; it states that its contigs are the
canonical contig set, each contig the lesser of its sequence and its
reverse complement. The control drops that last step (each chain is kept as
walked), the shortcut that would tempt a later change to the emission's
host tail: the graph holds each chain on both strands, so the control gives
a contig and its reverse complement where the reference gives the lesser.

    python3 euler_bench/control.py --workload NAME --seeds S1,S2,S3

runs the whole of a run (``run.run_cell``: set-up, a one-assembly window,
the reference, the comparison) with the control in the assembler's place,
on the card at the cell's own size, once a seed, and prints each seed's
compared numbers; it exits 0 only where every seed came out not correct.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "euler_bench":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_assemble(codes, cfg, device):
    """The reference without canonical contigs, shaped as the assembler's
    result."""
    from euler_bench import reference

    t0 = time.perf_counter()
    ref = reference.assemble(codes, {"k": cfg.k, "min_count": cfg.min_count}, device, canonicalize=False)
    return types.SimpleNamespace(
        contigs=ref.contigs,
        n_distinct_kmers=ref.distinct,
        n_kmers_counted=ref.windows,
        n_reads=codes.shape[0],
        stage_seconds={"extract": time.perf_counter() - t0},
    )


def main(argv=None) -> int:
    from euler_bench import run

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    all_failed = True
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run.run_cell(args.workload, seed, 0.0, False, t_start=time.perf_counter(), assemble=control_assemble)
        all_failed &= not out["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": out["correct"], "checks": out["checks"]}),
              flush=True)
    return 0 if all_failed else 1


if __name__ == "__main__":
    sys.exit(main())
