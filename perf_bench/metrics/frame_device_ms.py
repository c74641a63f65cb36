"""Device ms a call between the CUDA events of the span ``frame.launch``:
the upload, the replay and the readback, with the gaps the host leaves
between them (median over the traced calls, the profiler off)."""

from perf_bench.metrics import spans


def read(ctx):
    return spans.median_ms(ctx, "frame.launch", device=True)
