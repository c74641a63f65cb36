"""Host ms a call of the span ``frame.wait``: the wait for the device after
the readback is issued (median over the traced calls, the profiler off)."""

from perf_bench.metrics import spans


def read(ctx):
    return spans.median_ms(ctx, "frame.wait")
