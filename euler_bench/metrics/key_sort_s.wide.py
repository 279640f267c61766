"""key_sort_s.wide: the device seconds of the CUB radix-sort kernels that
``torch.sort`` launches, per assembly, from the traced window. Every
stable pass of the assembler's multi-word key sort is such a sort, as are
its few one-word sorts; beside ``key_sort_rows.wide`` it tells a slower
sort from more sorting."""

RADIX_SORT = r"DeviceRadixSort|DeviceSegmentedRadixSort"


def read(ctx):
    trace, done = ctx["trace"], ctx["stages"]
    if trace is None or not done:
        return None
    seconds = trace.kernel_seconds(RADIX_SORT)
    return seconds / len(done) if seconds > 0 else None
