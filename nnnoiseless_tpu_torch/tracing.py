"""Spans at the boundaries of the port's layers: where a call's time goes,
on the host and on the device.

=====================  =====================================================
span                   stretch of the program
=====================  =====================================================
``chunk``              ``denoise.process_chunk``: one chunk of the batched
                       engine, the two below inside it
``chunk.precompute``   phase 1, ``chunk.precompute_chunk`` (the biquad, the
                       decimation, the windows, kernel K1's launch)
``chunk.frame_loop``   phase 2, ``run_frame_loop`` (kernel K2), or the scan
                       engine's frame loop (one replay a frame)
``frame``              ``FrameProgram.__call__``: one
                       ``DenoiseState.process_frame``
``frame.launch``       the frame into the pinned buffer, its upload, the
                       replay and the readback's issue; on a card a pair of
                       CUDA events times the same stretch on the device
``frame.wait``         the wait for the device (the stream's synchronize)
``program.replay``     one replay of a captured graph (on a card)
=====================  =====================================================

Tracing is off unless a caller asks for it, in one of two ways:

* ``with tracing.recording() as rec:`` keeps each span that the block's
  thread opens in :attr:`Recording.spans`: its name, its id, its parent's
  and its root's ids (every span of one unit, a call or a chunk, shares its
  root), host start and end by ``time.perf_counter_ns()``, and the kernel
  launches (``ops.counters.launch_counts()``) made inside it.  A span given a
  CUDA device also records a pair of timing events on that device's
  current stream; they are read when the recording closes, so the traced
  calls gain no synchronisation;
* while ``torch.profiler`` records, each span is also a host range
  ``nnt.<name>`` in the profiler's trace, on the clock of its device
  operations.

Otherwise :func:`span` returns one shared null context, :data:`OFF`, and
does nothing else.  No span is opened inside a step that a CUDA graph
captures: it would run once at the capture and never at a replay.

Inside such a step the host marks the ends of its phases instead:
:func:`phase` records the nodes the capture holds so far, read only while
``programs.StepProgram`` captures (:func:`phase_marks`), and does nothing
at any other time.  The train steps mark ``forward.front``,
``forward.gru`` and ``forward.head`` (RNNoise 0.2's network) or
``forward`` (the 2018 network), then ``loss``, ``backward`` and
``optimizer``; the program keeps each phase's nodes as
``StepProgram.phase_nodes``.  A graph captured from one stream is a chain,
so its nodes run in capture order and a replay's device operations, in
order of start, fall into the phases in turn.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Optional

import torch

from .ops.counters import launch_counts

OFF = contextlib.nullcontext()
_current: contextvars.ContextVar = contextvars.ContextVar("nnt_recording", default=None)
_marks: contextvars.ContextVar = contextvars.ContextVar("nnt_phase_marks", default=None)


class Span:
    """One span of a :class:`Recording`.  ``parent`` is None for a root;
    ``launches`` maps a kernel name to the launches made inside the span
    (none counted on the CPU); ``device_ms`` is the events' time, None
    where the span had no CUDA device."""

    __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns", "launches", "device_ms", "events")

    def __init__(self, name: str, id_: int, parent: Optional["Span"]):
        self.name, self.id = name, id_
        self.parent = parent.id if parent is not None else None
        self.root = parent.root if parent is not None else id_
        self.start_ns = self.end_ns = 0
        self.launches: dict = {}
        self.device_ms: Optional[float] = None
        self.events = None

    @property
    def ms(self) -> float:
        """Host milliseconds from entry to exit."""
        return (self.end_ns - self.start_ns) / 1e6


class Recording:
    """The spans opened inside one :func:`recording` block, in the order
    they were entered (a span's id is its index)."""

    def __init__(self):
        self.spans: list[Span] = []
        self._open: list[Span] = []

    def ms(self, name: str, device: bool = False) -> list:
        """Host ms (device ms with ``device``) of each span named ``name``."""
        return [s.device_ms if device else s.ms for s in self.spans if s.name == name]

    def _resolve(self) -> None:
        for s in self.spans:
            if s.events is not None:
                start, end = s.events
                end.synchronize()
                s.device_ms = start.elapsed_time(end)
                s.events = None


class _Open:
    """An open span: the profiler's range, the recording's entry, or both."""

    __slots__ = ("rec", "name", "device", "span", "range", "before")

    def __init__(self, rec: Optional[Recording], name: str, device):
        self.rec, self.name, self.device = rec, name, device
        self.span = self.range = self.before = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function("nnt." + self.name)
            self.range.__enter__()
        rec = self.rec
        if rec is not None:
            s = Span(self.name, len(rec.spans), rec._open[-1] if rec._open else None)
            rec.spans.append(s)
            rec._open.append(s)
            self.span = s
            self.before = launch_counts()
            if self.device is not None and torch.device(self.device).type == "cuda":
                s.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                s.events[0].record(torch.cuda.current_stream(self.device))
            s.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        s = self.span
        if s is not None:
            s.end_ns = time.perf_counter_ns()
            if s.events is not None:
                s.events[1].record(torch.cuda.current_stream(self.device))
            after = launch_counts()
            s.launches = {k: after[k] - n for k, n in self.before.items() if after[k] != n}
            self.rec._open.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str, device=None):
    """A context manager around one stretch of the program named ``name``:
    :data:`OFF` when no recording is open and the profiler is not
    recording.  ``device``: where the stretch's device work runs; a CUDA
    device times it with events in a recording."""
    rec = _current.get()
    if rec is None and not torch.autograd._profiler_enabled():
        return OFF
    return _Open(rec, name, device)


@contextlib.contextmanager
def recording():
    """Keep the spans that this thread opens inside the block; the device
    times are read as it closes (``with tracing.recording() as rec:``)."""
    rec = Recording()
    token = _current.set(rec)
    try:
        yield rec
    finally:
        _current.reset(token)
        rec._resolve()


class PhaseMarks:
    """The phase ends marked inside one :func:`phase_marks` block:
    ``ends`` holds (name, nodes recorded so far) in the order marked."""

    def __init__(self, count_nodes):
        self._count = count_nodes
        self.ends: list = []

    def nodes(self) -> dict:
        """Each phase's own nodes, from the previous mark (or the block's
        start) to its own, in the order marked."""
        out, at = {}, 0
        for name, end in self.ends:
            if name in out:
                raise ValueError(f"the phase {name!r} was marked twice in one step")
            out[name], at = end - at, end
        return out


def phase(name: str) -> None:
    """Mark the end of the phase ``name`` of a step under capture: the
    capture's node count is kept; outside :func:`phase_marks`, nothing."""
    marks = _marks.get()
    if marks is not None:
        marks.ends.append((name, marks._count()))


@contextlib.contextmanager
def phase_marks(count_nodes):
    """Keep the phase ends that this thread marks inside the block, each
    with ``count_nodes()``, the nodes the capture holds at that point."""
    marks = PhaseMarks(count_nodes)
    token = _marks.set(marks)
    try:
        yield marks
    finally:
        _marks.reset(token)
