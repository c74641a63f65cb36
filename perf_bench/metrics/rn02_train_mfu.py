"""RNNoise 0.2's train step's share of the card's FP32 peak: 3 x 2 x the
forward's MACs a frame x batch x sequence frames (perf_bench/counts_rn02.py,
at the configuration's widths) over the window's step time."""

from perf_bench import counts, counts_rn02
from perf_bench.drivers.train_rn02 import widths


def read(ctx):
    w = ctx["window"]
    flops = counts_rn02.train_step_flops(w["batch"], w["sequence_frames"], **widths(ctx["cell"].config))
    return 100.0 * flops / (w["train_step_ms"] / 1e3) / counts.PEAK_FLOPS
