"""A traced stretch of work: ``torch.profiler`` over it, reduced to device
operations, the device's busy time and its idle gaps.

Device time is the union of the intervals in which a device operation ran,
so overlapping operations are not counted twice.  An idle gap is named by
the innermost host operation or benchmark span that was open at its middle
(``torch.profiler.record_function`` labels the benchmark's own units,
``perf_bench unit <i>``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch


@dataclass
class Trace:
    window_s: float  # host wall of the traced stretch, its final synchronisation included
    units: int  # chunks, calls or steps in the stretch
    ops: list = field(default_factory=list)  # (name, start_us, dur_us) of each device operation
    busy_s: float = 0.0
    gaps: list = field(default_factory=list)  # (name, seconds), longest first

    def device_s(self, match=None) -> float:
        """Summed device seconds of the operations whose name ``match`` accepts (all by default)."""
        return sum(d for n, _, d in self.ops if match is None or match(n)) / 1e6

    def count(self) -> int:
        return len(self.ops)

    def top_ops(self, k: int = 10) -> list:
        by = {}
        for n, _, d in self.ops:
            by[n] = by.get(n, 0.0) + d / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def _reduce(prof, trace: Trace) -> None:
    cuda = torch.autograd.DeviceType.CUDA
    host = []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type != cuda:
            host.append((start, end, e.name))
        elif not e.is_user_annotation:  # the device-side copy of a benchmark span is no operation
            trace.ops.append((e.name, start, end - start))
    if not trace.ops:
        return
    spans = sorted((s, s + d) for _, s, d in trace.ops)
    busy, gaps = 0.0, []
    cur_s, cur_e = spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    trace.busy_s = busy / 1e6
    gaps.sort(key=lambda g: g[0] - g[1])
    for g0, g1 in gaps[:10]:
        mid = 0.5 * (g0 + g1)
        open_ = [(s, n) for s, e, n in host if s <= mid <= e]
        name = max(open_)[1] if open_ else "no host operation"
        trace.gaps.append([name, (g1 - g0) / 1e6])


def traced(run_unit, units: int, device) -> Trace:
    """Run ``run_unit(i)`` for i < ``units`` under the profiler, each unit
    ending in a synchronisation; returns the reduced :class:`Trace`."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(units):
            with torch.profiler.record_function(f"perf_bench unit {i}"):
                run_unit(i)
                if torch.device(device).type == "cuda":
                    torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    trace = Trace(window_s=window, units=units)
    _reduce(prof, trace)
    return trace
