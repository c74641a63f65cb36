"""The serving path's compiled programs: captured CUDA graphs of the
per-frame step and of the scan engine's frame step.

The counterparts of the JAX package's jitted programs
(``nnnoiseless_tpu/denoise.py:31-158``): ``_frame_step_jit`` compiles
``DenoiseState.process_frame`` into one device program a call, and
``_scan_batch``'s ``lax.scan`` the scan engine's frame loop into one a
chunk.  PyTorch runs eagerly, so each eager step issues hundreds of host
launches; here a step is a function that reads and writes static tensors,
and :class:`StepProgram` runs it:

* on a CUDA device, the first call runs the step once on a side stream
  (the warm-up: it builds the kernels and uploads the tables that the
  capture must find in place), restores the state the warm-up changed,
  captures the step as a CUDA graph in a memory pool of its own, and
  replays it; every later call replays it.  The graph runs the eager
  step's kernels in the eager step's order, so its outputs are the eager
  step's, bit for bit.  A capture or a replay that fails raises: nothing
  falls back to the eager step on the card;
* on the CPU, every call runs the step eagerly on the same static tensors.

:class:`FrameProgram` is ``pipeline.frame_step`` at B=1 (kernels K3, K5,
K6 on the card): one replay a frame, one upload of the frame from a
pinned buffer before it and one readback of the output and vad into a
pinned buffer after it, one synchronisation.  :class:`ScanProgram` is
``pipeline.frame_step_hoisted`` at B streams (K5, K6), fed one frame of
the chunk's precompute at a time through a static :class:`FramePre` slot.

Launch counts: a kernel wrapper counts a launch when its Python runs.
While a step is captured nothing launches, so the capture takes back the
counts its step added and records them (:attr:`StepProgram.captured`);
each replay adds them again.  The warm-up's launches are real and count.

A program's static tensors are its state: one program serves one caller
at a time (a ``DenoiseState`` owns its :class:`FrameProgram`, an
``Engine`` one :class:`ScanProgram` per batch size).
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import FRAME_SIZE, FREQ_SIZE, NB_BANDS
from .ops import fft, frame_kernel, pitch_kernel, rnn_kernel, window
from .ops.pitch import N_CAND
from .pipeline import DenoiseCarry, FramePre, frame_step, frame_step_hoisted, init_carry

# The kernel wrappers' launch counters, by the names the tools print.
COUNTERS = {
    "K1": (pitch_kernel, "launches"),
    "K2": (frame_kernel, "launches"),
    "K3": (pitch_kernel, "stacked_launches"),
    "K4": (frame_kernel, "cand_launches"),
    "K5": (rnn_kernel, "launches"),
    "K6": (window, "launches"),
    "probe": (fft, "launches"),
}


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel name."""
    return {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}


def _add_counts(counts: dict) -> None:
    for name, n in counts.items():
        mod, attr = COUNTERS[name]
        setattr(mod, attr, getattr(mod, attr) + n)


def leaves(tree) -> list:
    """The tensors of a carry (nested NamedTuples), in field order."""
    if isinstance(tree, tuple):
        return [leaf for sub in tree for leaf in leaves(sub)]
    return [tree]


def assign(static, value) -> None:
    """Copy each tensor of ``value`` into the same field of ``static`` in
    place (a field that already is the static tensor is left alone)."""
    for s, v in zip(leaves(static), leaves(value), strict=True):
        if v is not s:
            s.copy_(v)


def snapshot(tree):
    """A copy of a carry whose tensors no later step writes."""
    if isinstance(tree, tuple):
        return type(tree)(*(snapshot(sub) for sub in tree))
    return tree.clone()


class StepProgram:
    """``step()``, a function of static tensors, as a program on ``device``:
    captured once and replayed on a CUDA device, run eagerly on the CPU.

    ``state``: the static tensors whose values the step carries from call
    to call; the warm-up before the capture leaves them as it found them.
    After the capture: :attr:`captured` (kernel name -> launches recorded
    in the graph), :attr:`pool_bytes` (device memory the capture reserved
    for the graph's pool), :attr:`replays`, :attr:`warmups`.
    """

    def __init__(self, step, state, device):
        self._step = step
        self._state = tuple(state)
        self.device = torch.device(device)
        self.graph = None
        self.captured: dict = {}
        self.pool_bytes = 0
        self.replays = 0
        self.warmups = 0

    def __call__(self) -> None:
        if self.device.type != "cuda":
            self._step()
            return
        with torch.cuda.device(self.device):
            if self.graph is None:
                self._capture()
            self.graph.replay()
        self.replays += 1
        _add_counts(self.captured)

    def _capture(self) -> None:
        dev = self.device
        saved = [t.clone() for t in self._state]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._step()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.warmups += 1
        for t, s in zip(self._state, saved):
            t.copy_(s)
        del saved
        # torch.cuda.graph empties the allocator's cache as it enters; doing
        # it first makes the growth of the reserved memory the pool's size
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                self._step()
        finally:
            after = launch_counts()
            _add_counts({k: before[k] - after[k] for k in before})
        self.captured = {k: after[k] - before[k] for k in before if after[k] != before[k]}
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.graph = graph


class FrameProgram:
    """``pipeline.frame_step`` at B=1 on a static carry: the program of
    ``DenoiseState.process_frame``, as ``_frame_step_jit`` is the JAX
    package's.  :attr:`carry` holds the stream's state between calls."""

    def __init__(self, engine):
        dev = engine.device
        pin = dev.type == "cuda"
        self.device = dev
        self.carry = init_carry(engine.model.meta, 1, dev)
        self._frame = torch.zeros((1, FRAME_SIZE), dtype=torch.float32, device=dev)
        self._result = torch.zeros(FRAME_SIZE + 1, dtype=torch.float32, device=dev)  # out | vad
        self._frame_host = torch.zeros((1, FRAME_SIZE), dtype=torch.float32, pin_memory=pin)
        self._result_host = torch.zeros(FRAME_SIZE + 1, dtype=torch.float32, pin_memory=pin)
        self._frame_np, self._result_np = self._frame_host.numpy(), self._result_host.numpy()

        def step():
            carry, out, vad = frame_step(engine.rnn, self.carry, self._frame, engine.rnn_weights)
            assign(self.carry, carry)
            self._result[:FRAME_SIZE].copy_(out[0])
            self._result[FRAME_SIZE:].copy_(vad)

        self.program = StepProgram(step, leaves(self.carry), dev)

    def __call__(self, frame: np.ndarray) -> tuple[np.ndarray, float]:
        """One (480,) f32 frame -> (output (480,), vad)."""
        self._frame_np[0] = frame
        self._frame.copy_(self._frame_host, non_blocking=True)
        self.program()
        self._result_host.copy_(self._result, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return self._result_np[:FRAME_SIZE].copy(), float(self._result_np[FRAME_SIZE])

    def reset(self) -> None:
        """Zero the carry in place."""
        for leaf in leaves(self.carry):
            leaf.zero_()


class ScanProgram:
    """``pipeline.frame_step_hoisted`` at ``batch`` streams on a static
    carry, fed one frame of a chunk's precompute at a time: the scan
    engine's frame loop, as ``_scan_batch``'s ``lax.scan`` is the JAX
    package's.  A frame issues its six slot copies, one replay and the
    copies of its outputs."""

    def __init__(self, engine, batch: int):
        dev = engine.device
        z = lambda *shape, dtype=torch.float32: torch.zeros((batch,) + shape, dtype=dtype, device=dev)
        self.carry = init_carry(engine.model.meta, batch, dev)
        self.pre = FramePre(filtered=z(FRAME_SIZE), cand=z(N_CAND), x=z(2 * FREQ_SIZE),
                            ex=z(NB_BANDS), silence=z(dtype=torch.bool), ceps=z(NB_BANDS))
        self.out, self.vad = z(FRAME_SIZE), z()

        def step():
            carry, out, vad = frame_step_hoisted(engine.rnn, self.carry, self.pre, engine.rnn_weights)
            assign(self.carry, carry)
            self.out.copy_(out)
            self.vad.copy_(vad)

        self.program = StepProgram(step, leaves(self.carry), dev)

    def __call__(self, carry: DenoiseCarry, pre: FramePre, return_trace: bool = False):
        """The T frames of ``pre`` (time-major (T, B, ...), with the lag-0
        fields) from ``carry`` -> (carry' (its own tensors), out
        (B, T, 480), vad (B, T)), plus (periods (B, T) int32, pitch gains
        (B, T)) with ``return_trace``."""
        assign(self.carry, carry)
        b, t_count = self.out.shape[0], pre.filtered.shape[0]
        new = lambda *shape, dtype=torch.float32: torch.empty(
            (b, t_count) + shape, dtype=dtype, device=self.out.device)
        out, vad = new(FRAME_SIZE), new()
        if return_trace:
            periods, gains = new(dtype=torch.int32), new()
        for t in range(t_count):
            for slot, field in zip(self.pre, pre, strict=True):
                slot.copy_(field[t])
            self.program()
            out[:, t].copy_(self.out)
            vad[:, t].copy_(self.vad)
            if return_trace:
                periods[:, t].copy_(self.carry.feat.pitch_period)
                gains[:, t].copy_(self.carry.feat.pitch_gain)
        result = (snapshot(self.carry), out, vad)
        return (*result, (periods, gains)) if return_trace else result
