"""walk_s: the unitig walk (``chains_from_t``) and the device sync that
ends the graph stage, seconds per assembly (the program's ``graph: walk``
and ``graph: sync`` spans)."""

from euler_bench import program_spans


def read(ctx):
    return program_spans.mean(ctx, "seconds", "graph: walk", "graph: sync")
