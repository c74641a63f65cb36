"""Kernel K2's share of its roofline: the least time of a chunk's
per-frame work (perf_bench/counts.py::k2_work) over K2's device time a
chunk."""

from perf_bench import counts
from perf_bench.metrics import kernels


def read(ctx):
    tr = ctx["cell"].traffic
    return kernels.roofline_pct(ctx["trace"], kernels.is_k2, counts.k2_work(tr["streams"], tr["chunk_frames"]))
