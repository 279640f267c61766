"""pack_cpu_s: the process's CPU time over the feed worker's ``feed: pack``
spans, seconds per assembly. It counts every thread of the process (the
native packer's, and the main thread's beside them): against ``pack_s`` it
tells a pack that waits for cores (the share falls as the wall rises) from
one that is slow on its own (the share holds)."""

from euler_bench import program_spans


def read(ctx):
    return program_spans.mean(ctx, "cpu_seconds", "feed: pack")
