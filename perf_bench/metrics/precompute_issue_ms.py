"""Host ms a chunk of the span ``chunk.precompute``: the Python of phase 1
issuing the biquad, the decimation, the windows and kernel K1 (median over
one segment's chunks, the profiler off)."""

from perf_bench.metrics import spans


def read(ctx):
    return spans.median_ms(ctx, "chunk.precompute")
