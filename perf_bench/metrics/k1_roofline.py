"""Kernel K1's share of its roofline: the least time the reference pitch
search needs for a chunk (perf_bench/counts.py::k1_work) over K1's device
time a chunk."""

from perf_bench import counts
from perf_bench.metrics import kernels


def read(ctx):
    tr = ctx["cell"].traffic
    return kernels.roofline_pct(ctx["trace"], kernels.is_k1, counts.k1_work(tr["streams"], tr["chunk_frames"]))
