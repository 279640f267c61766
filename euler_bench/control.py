#!/usr/bin/env python3
"""The control of the comparison: the reference, put in the assembler's
place, with one stated guarantee broken, must come out not correct.

The assembler states no precision; it states that its contigs are the
canonical contig set, each contig the lesser of its sequence and its
reverse complement. The control drops that last step (each chain is kept as
walked), the shortcut that would tempt a later change to the emission's
host tail: the graph holds each chain on both strands, so the control gives
a contig and its reverse complement where the reference gives the lesser.
It runs with the cell's whole settings (cutoff and cleaning rounds), so
that canonical orientation is the one guarantee it breaks.

    python3 euler_bench/control.py --workload NAME --seeds S1,S2,S3 [--fault no_cleaning]

runs the whole of a run (``run.run_cell``: set-up, a window of one
assembly, the reference, the comparison) with the control in the
assembler's place, on the card at the cell's own size, once a seed, and prints each seed's
compared numbers; it exits 0 only where every seed came out not correct.
``--fault no_cleaning`` puts the assembler with its tip and bubble rounds
set to 0 there instead: a fault of a cleaning cell, not correct wherever
the reference's cleaning removed a k-mer (its log says how many).
"""

from __future__ import annotations

import argparse
import dataclasses
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
    ref = reference.assemble(codes, dataclasses.asdict(cfg), device, canonicalize=False)
    return types.SimpleNamespace(
        contigs=ref.contigs,
        n_distinct_kmers=ref.distinct,
        n_kmers_counted=ref.windows,
        n_reads=codes.shape[0],
        stage_seconds={"extract": time.perf_counter() - t0},
    )


def no_cleaning_assemble(codes, cfg, device):
    """The assembler with its cleaning rounds set to 0 (a fault)."""
    from tpu_euler_torch.pipeline.assemble import assemble_codes

    return assemble_codes(codes, dataclasses.replace(cfg, tip_rounds=0, bubble_rounds=0), device)


FAULTS = {"control": control_assemble, "no_cleaning": no_cleaning_assemble}


def main(argv=None) -> int:
    from euler_bench import run

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--fault", choices=sorted(FAULTS), default="control")
    args = ap.parse_args(argv)
    all_failed = True
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run.run_cell(args.workload, seed, 0.0, False, t_start=time.perf_counter(), assemble=FAULTS[args.fault])
        all_failed &= not out["correct"]
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed, "correct": out["correct"],
                          "checks": out["checks"]}), flush=True)
    return 0 if all_failed else 1


if __name__ == "__main__":
    sys.exit(main())
