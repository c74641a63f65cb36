"""The whole frame's share of the card's FP32 peak: the reference's flops
a stream-frame (perf_bench/counts.py::frame_flops) times the frames the
window denoised, over the window's seconds."""

from perf_bench import counts


def read(ctx):
    w = ctx["window"]
    return 100.0 * counts.frame_flops() * w["frames"] / w["seconds"] / counts.PEAK_FLOPS
