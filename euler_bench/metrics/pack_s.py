"""pack_s: the feed worker's pad, pack and staging of each batch into
pinned memory, seconds per assembly (the program's ``feed: pack`` spans, on
the worker thread)."""

from euler_bench import program_spans


def read(ctx):
    return program_spans.mean(ctx, "seconds", "feed: pack")
