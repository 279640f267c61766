"""emit_host_s: the emission's host tail (base lookup, prefix stitch,
canonicalization in numpy), seconds per assembly (the program's ``emit:
host`` span)."""

from euler_bench import program_spans


def read(ctx):
    return program_spans.mean(ctx, "seconds", "emit: host")
