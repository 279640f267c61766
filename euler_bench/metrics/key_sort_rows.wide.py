"""key_sort_rows.wide: the rows that the assembler's multi-word key sorts
sorted, summed over their stable passes (the program's counter
``key_sort_rows``), per assembly of the window. A program without that
counter gives no reading."""

from euler_bench import program_spans


def read(ctx):
    done = program_spans.window(ctx)
    if done is None or not any("key_sort_rows" in r["counters"] for r in done):
        return None
    return sum(r["counters"].get("key_sort_rows", 0) for r in done) / len(done)
