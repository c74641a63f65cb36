"""Host ms a call of the span ``frame.launch``: the frame into the pinned
buffer, its upload, the replay and the readback's issue (median over the
traced calls, the profiler off)."""

from perf_bench.metrics import spans


def read(ctx):
    return spans.median_ms(ctx, "frame.launch")
