"""The train step's share of the card's FP32 peak: 3 x 2 x the forward's
MACs a frame x batch x sequence frames (perf_bench/counts.py) over the
window's step time."""

from perf_bench import counts


def read(ctx):
    w = ctx["window"]
    flops = counts.train_step_flops(w["batch"], w["sequence_frames"])
    return 100.0 * flops / (w["train_step_ms"] / 1e3) / counts.PEAK_FLOPS
