"""Device ms of the backward in one replay of RNNoise 0.2's train step: the
operations of the phase ``backward`` (perf_bench/metrics/phases.py)."""

from perf_bench.metrics import phases


def read(ctx):
    return phases.phase_ms(ctx, "backward")
