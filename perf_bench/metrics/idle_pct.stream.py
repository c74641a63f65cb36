"""The share of the traced stretch in which no operation ran on the device."""

from perf_bench.metrics import kernels


def read(ctx):
    return kernels.idle_pct(ctx["trace"])
