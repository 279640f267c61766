"""emit_copy_s: the emission's three reads of its buffers to the host, with
the wait for the device scatter's tail before them, seconds per assembly
(the program's ``emit: copy`` span)."""

from euler_bench import program_spans


def read(ctx):
    return program_spans.mean(ctx, "seconds", "emit: copy")
