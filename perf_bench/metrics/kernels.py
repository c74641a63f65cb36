"""Which device operations are which kernel, by the kernel's name in the
profiler, and the roofline share of a kernel's time."""

from perf_bench import counts


def is_k1(name: str) -> bool:
    return "pitch_kernel" in name


def is_k2(name: str) -> bool:
    return "frame_kernel" in name


def roofline_pct(trace, match, work) -> float | None:
    """100 x the least time of ``work`` (bytes, flops) a traced unit over
    the device time a unit of the operations ``match`` accepts; None where
    none ran."""
    t = trace.device_s(match) / trace.units
    if t <= 0:
        return None
    return 100.0 * counts.bound_s(*work) / t


def idle_pct(trace) -> float | None:
    if not trace.ops or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
