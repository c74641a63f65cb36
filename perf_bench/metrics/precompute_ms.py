"""Device ms a chunk of every operation of the two-phase engine except
kernels K1 and K2: the chunk precompute (biquad, decimation, windows) and
the wrappers' copies, over one traced segment."""

from perf_bench.metrics import kernels


def read(ctx):
    tr = ctx["trace"]
    if not tr.ops:
        return None
    return tr.device_s(lambda n: not kernels.is_k1(n) and not kernels.is_k2(n)) / tr.units * 1e3
