"""The program's own spans and counters (``nnnoiseless_tpu_torch.tracing``,
``StepProgram.graph_nodes``), for the readers that report them.

A reader's ``ctx`` holds the profiler's trace of the stretch after the
window, the window's numbers and ``program_stats()``; the harness keeps no
recording of the program's spans.  So the first reader of a run that needs
one, :func:`spans`, runs the cell's traced stretch once more with
``tracing.recording()`` open and the profiler off (:func:`spanned` in place
of ``trace.traced``), on a program of its own that the cell's driver sets
up as it does for a run, from a fixed seed: its ``traced()`` units (one
segment of chunks from a reset; ``trace_frames`` calls from a reset), once
as a warm-up and once recorded.  It does so in a fresh process, on the
run's own device: once ``torch.profiler`` has traced the device, the
process's CUDA calls stay slower (a graph launch's host time 0.016 ->
0.085-0.147 ms on an H100), and the spans are to time the program
untraced.  So the spans describe that process's program and not the
window's: a state of the device that one process holds (the frame
replay's slow state) need not be the window's.  The recording is kept in
``ctx["spans"]``, and a node count (:func:`graph_nodes`) in
``ctx["program"]["graph_nodes"]``; where ``ctx`` already holds either, it is
used as it is.  A program without ``tracing`` or ``graph_nodes`` gives
None, and its readers report nothing.
"""

from __future__ import annotations

import gc
import importlib
import multiprocessing
import statistics
from concurrent.futures import ProcessPoolExecutor

import torch

SEED = 1  # the units' inputs; their timing does not depend on the samples
TIMEOUT_S = 600


def spanned(run_unit, units: int, device):
    """``trace.traced`` with a recording open instead of the profiler: run
    ``run_unit(i)`` for i < ``units``, each unit inside a root span
    ``perf_bench.unit`` and ending in a synchronisation; returns the
    ``tracing.Recording``."""
    from nnnoiseless_tpu_torch import tracing

    device = torch.device(device)
    with tracing.recording() as rec:
        for i in range(units):
            with tracing.span("perf_bench.unit"):
                run_unit(i)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
    return rec


def record(cell, device):
    """The recording of ``cell``'s traced units on ``device``, the run's
    device, in a program that the cell's driver sets up; raises where
    this process cannot see that device."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() <= (device.index or 0):
        raise RuntimeError(f"the run's device {device} is not visible to the process recording its spans")
    driver = importlib.import_module(f"perf_bench.drivers.{cell.traffic['driver']}")
    run = driver.Cell(cell, SEED, device)
    run.setup()
    driver.traced = spanned  # the driver's traced stretch, recorded (a process of its own)
    run.traced()  # a warm-up
    return run.traced()


def spans(ctx):
    """The recording of the cell's units, made by :func:`record` in a fresh
    process on the run's device: ``ctx["device"]`` where given, else
    ``cuda:0``, the one device ``run.py`` runs on (it refuses to run
    without a card).  None where the program has no ``tracing``."""
    if "spans" not in ctx:
        try:
            import nnnoiseless_tpu_torch.tracing  # noqa: F401
        except ImportError:
            ctx["spans"] = None
            return None
        device = str(ctx.get("device", "cuda:0"))
        with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
            ctx["spans"] = pool.submit(record, ctx["cell"], device).result(TIMEOUT_S)
    return ctx["spans"]


def median_ms(ctx, name: str, device: bool = False):
    """Median ms of the spans ``name`` in the recording (device ms with
    ``device``); None where there are none."""
    rec = spans(ctx)
    ms = [v for v in rec.ms(name, device) if v is not None] if rec is not None else []
    return statistics.median(ms) if ms else None


def graph_nodes(ctx):
    """The node count of the graphs captured in this process (the driver's
    program): None where no program counts them, none was captured, or two
    captures disagree.  The harness hands a reader no handle on the
    program, so the programs are found among the process's live objects."""
    p = ctx["program"]
    if "graph_nodes" not in p:
        from nnnoiseless_tpu_torch.programs import StepProgram

        gc.collect()
        seen = {getattr(o, "graph_nodes", None) for o in gc.get_objects()
                if type(o) is StepProgram and o.graph is not None}
        seen.discard(None)
        p["graph_nodes"] = seen.pop() if len(seen) == 1 else None
    return p["graph_nodes"]
