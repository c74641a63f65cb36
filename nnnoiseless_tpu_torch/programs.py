"""The compiled programs: captured CUDA graphs of the per-frame step, the
scan engine's frame step, the generator's frame step and the train step.

The counterparts of the JAX package's jitted programs: ``_frame_step_jit``
(``nnnoiseless_tpu/denoise.py:31``) compiles ``DenoiseState.process_frame``
into one device program a call, ``_scan_batch``'s ``lax.scan`` (``:106``)
the scan engine's frame loop into one a chunk, ``_feature_chunk``
(``nnnoiseless_tpu/training/data.py:333``) the generator's, and
``train_step_indexed`` (``nnnoiseless_tpu/training/train.py:114``) a whole
train step.  PyTorch runs eagerly, so each eager step issues hundreds (a
train step: hundreds of thousands) of host launches; here a step is a
function that reads and writes static tensors, and :class:`StepProgram`
runs it:

* on a CUDA device, the first call runs the step once on a side stream
  (the warm-up: it builds the kernels and uploads the tables that the
  capture must find in place), restores the state the warm-up changed,
  captures the step as a CUDA graph in a memory pool of its own (Python's
  cyclic collector run first and held off during the capture, so that no
  other program's graph is destroyed inside it), and replays it; every
  later call replays it.  The graph runs the eager
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
:class:`FeatureProgram` is ``pipeline.analyze_frame_hoisted`` (K6) fed the
same way: the generator's frame loop.  :class:`TrainProgram` is one train
step (forward over the sequence, backward, Adam, the clip; over a mesh the
NCCL all-reduce of the gradients too) on a static index vector.

Launch counts: a kernel wrapper counts a launch when its Python runs.
While a step is captured nothing launches, so the capture takes back the
counts its step added and records them (:attr:`StepProgram.captured`);
each replay adds them again.  The warm-up's launches are real and count.

A program's static tensors are its state: one program serves one caller
at a time (a ``DenoiseState`` owns its :class:`FrameProgram`, an
``Engine`` one :class:`ScanProgram` per batch size, a ``generate`` call its
:class:`FeatureProgram`, a ``fit`` call its :class:`TrainProgram`).
"""

from __future__ import annotations

import ctypes
import functools
import gc
import time

import numpy as np
import torch

from . import tracing
from .constants import FRAME_SIZE, FREQ_SIZE, NB_BANDS, NB_FEATURES
from .ops.counters import add_counts, launch_counts
from .ops.pitch import N_CAND
from .pipeline import (
    DenoiseCarry,
    FeatureState,
    FramePre,
    analyze_frame_hoisted,
    frame_step,
    frame_step_hoisted,
    init_carry,
    init_feature_state,
)

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


@functools.cache
def _driver() -> ctypes.CDLL:
    """The CUDA driver torch has loaded, with the two calls that count the
    nodes of a graph in capture declared (torch has no call for it)."""
    lib = ctypes.CDLL("libcuda.so.1")
    size_p = ctypes.POINTER(ctypes.c_size_t)
    lib.cuStreamGetCaptureInfo_v2.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, size_p]
    lib.cuStreamGetCaptureInfo_v2.restype = ctypes.c_int
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p, size_p]
    lib.cuGraphGetNodes.restype = ctypes.c_int
    return lib


def _capture_nodes(stream: torch.cuda.Stream) -> int:
    """The nodes recorded so far in the graph that ``stream`` is capturing:
    kernels, copies, memsets and whatever other node the capture made."""
    lib = _driver()
    status, graph, n = ctypes.c_int(), ctypes.c_void_p(), ctypes.c_size_t()
    err = lib.cuStreamGetCaptureInfo_v2(stream.cuda_stream, ctypes.byref(status), None,
                                        ctypes.byref(graph), None, None)
    if err == 0 and status.value == 1:  # CU_STREAM_CAPTURE_STATUS_ACTIVE
        err = lib.cuGraphGetNodes(graph, None, ctypes.byref(n))
    if err != 0 or status.value != 1:
        raise RuntimeError(f"cannot count the nodes of the capture (CUresult {err}, capture status {status.value})")
    return n.value


class StepProgram:
    """``step()``, a function of static tensors, as a program on ``device``:
    captured once and replayed on a CUDA device, run eagerly on the CPU.

    ``state`` (kept as :attr:`state`): the static tensors whose values the
    step carries from call to call; the warm-up before the capture leaves
    them as it found them.  A step may hold a collective (the data-parallel
    train step's all-reduce): the warm-up runs it first, which creates
    NCCL's communicator if the group had none, and the capture records it
    in the graph like a kernel, in ``torch.cuda.graph``'s default capture
    mode ("global": the process group's watchdog thread, which queries
    the events of collectives in flight, does not invalidate it).
    After the capture: :attr:`captured` (kernel name -> launches recorded
    in the graph), :attr:`pool_bytes` (device memory the capture reserved
    for the graph's pool), :attr:`warmup_s` and :attr:`capture_s` (wall
    seconds of the warm-up step and of the capture with the graph's
    instantiation), :attr:`replays`, :attr:`warmups`, and
    :attr:`graph_nodes`: the nodes of the captured graph, the device
    operations of one replay as the program counts them (0 on the CPU),
    and :attr:`phase_nodes`: the nodes of each phase the step marked with
    ``tracing.phase`` during the capture, in capture order (a step's nodes
    after its last mark belong to no phase; empty on the CPU).
    Under :mod:`tracing` each replay is the span ``program.replay``.
    """

    def __init__(self, step, state, device):
        self._step = step
        self.state = tuple(state)
        self.device = torch.device(device)
        self.graph = None
        self.captured: dict = {}
        self.pool_bytes = 0
        self.warmup_s = self.capture_s = 0.0
        self.graph_nodes = 0
        self.phase_nodes: dict = {}
        self.replays = 0
        self.warmups = 0

    def __call__(self) -> None:
        if self.device.type != "cuda":
            self._step()
            return
        with torch.cuda.device(self.device):
            if self.graph is None:
                self._capture()
            with tracing.span("program.replay"):
                self.graph.replay()
                add_counts(self.captured)
        self.replays += 1

    def _capture(self) -> None:
        dev = self.device
        saved = [t.detach().clone() for t in self.state]
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._step()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        self.warmup_s = time.perf_counter() - t0
        self.warmups += 1
        with torch.no_grad():  # the state may hold parameters
            for t, s in zip(self.state, saved):
                t.copy_(s)
        del saved
        # A program whose step closes over it is freed by the cyclic
        # collector, which destroys its graph; destroying a graph while
        # another is captured invalidates that capture.  So collect first,
        # and let no collection run inside the capture.
        gc.collect()
        # torch.cuda.graph empties the allocator's cache as it enters; doing
        # it first makes the growth of the reserved memory the pool's size
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = launch_counts()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                stream = torch.cuda.current_stream(dev)
                with tracing.phase_marks(lambda: _capture_nodes(stream)) as marks:
                    self._step()
                nodes = _capture_nodes(stream)
        finally:
            if collecting:
                gc.enable()
            after = launch_counts()
            add_counts({k: before[k] - after[k] for k in before})
        self.capture_s = time.perf_counter() - t0
        self.captured = {k: after[k] - before[k] for k in before if after[k] != before[k]}
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.graph_nodes = nodes
        self.phase_nodes = marks.nodes()
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
        """One (480,) f32 frame -> (output (480,), vad); the spans
        ``frame``, ``frame.launch`` (timed on the device too) and
        ``frame.wait``."""
        with tracing.span("frame"):
            with tracing.span("frame.launch", self.device):
                self._frame_np[0] = frame
                self._frame.copy_(self._frame_host, non_blocking=True)
                self.program()
                self._result_host.copy_(self._result, non_blocking=True)
            with tracing.span("frame.wait"):
                if self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()
            return self._result_np[:FRAME_SIZE].copy(), float(self._result_np[FRAME_SIZE])

    def reset(self) -> None:
        """Zero the carry in place."""
        for leaf in leaves(self.carry):
            leaf.zero_()


def _pre_slot(batch: int, device) -> FramePre:
    """A zeroed :class:`FramePre` of one frame (lag-0 fields included) for
    ``batch`` streams: the static slot a frame program reads."""
    z = lambda *shape, dtype=torch.float32: torch.zeros((batch,) + shape, dtype=dtype, device=device)
    return FramePre(filtered=z(FRAME_SIZE), cand=z(N_CAND), x=z(2 * FREQ_SIZE),
                    ex=z(NB_BANDS), silence=z(dtype=torch.bool), ceps=z(NB_BANDS))


def _feed(program: StepProgram, slot: FramePre, pre: FramePre, outputs: list) -> None:
    """Each frame t of ``pre`` (time-major (T, B, ...)): copy it into
    ``slot``, run ``program``, then copy each (dst, src) of ``outputs``."""
    for t in range(pre.filtered.shape[0]):
        for s, field in zip(slot, pre, strict=True):
            s.copy_(field[t])
        program()
        for dst, src in outputs:
            dst[:, t].copy_(src)


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
        self.pre = _pre_slot(batch, dev)
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
        outputs = [(out, self.out), (vad, self.vad)]
        if return_trace:
            periods, gains = new(dtype=torch.int32), new()
            outputs += [(periods, self.carry.feat.pitch_period), (gains, self.carry.feat.pitch_gain)]
        _feed(self.program, self.pre, pre, outputs)
        result = (snapshot(self.carry), out, vad)
        return (*result, (periods, gains)) if return_trace else result


class FeatureProgram:
    """``pipeline.analyze_frame_hoisted`` at ``batch`` streams on a static
    :class:`FeatureState`, fed one frame of a chunk's precompute at a time:
    the generator's frame loop, as ``_feature_chunk``'s ``lax.scan`` is the
    JAX package's.  A frame issues its six slot copies, one replay (K6
    inside) and the copy of its features.  The graph does not depend on the
    chunk's length."""

    def __init__(self, batch: int, device):
        dev = torch.device(device)
        self.state = init_feature_state(batch, dev)
        self.pre = _pre_slot(batch, dev)
        self.features = torch.zeros((batch, NB_FEATURES), dtype=torch.float32, device=dev)

        def step():
            state, an = analyze_frame_hoisted(self.state, self.pre)
            assign(self.state, state)
            self.features.copy_(an.features)

        self.program = StepProgram(step, leaves(self.state), dev)

    def __call__(self, state: FeatureState, pre: FramePre):
        """The T frames of ``pre`` (time-major (T, B, ...) with the lag-0
        fields; strided views are fine) from ``state`` -> (state' (its own
        tensors), features (B, T, 42))."""
        assign(self.state, state)
        b, t_count = self.features.shape[0], pre.filtered.shape[0]
        feats = torch.empty((b, t_count, NB_FEATURES), dtype=torch.float32, device=self.features.device)
        _feed(self.program, self.pre, pre, [(feats, self.features)])
        return snapshot(self.state), feats


class TrainProgram:
    """A train step on a static (B,) index vector: ``fit``'s program, as the
    jitted ``train_step_indexed`` is the JAX package's, on one device or
    over a ``dp`` mesh.  ``step(idx)`` runs one step of ``model`` under
    ``opt`` on the rows ``idx`` and returns the loss
    (``training.train.train_step_indexed`` on the device's dataset, or
    ``train_step_dp``, which takes this rank's slice of the global batch's
    ``idx`` and all-reduces the gradients and the loss); one replay is its
    forward over the whole sequence, the backward, the all-reduce if any,
    the optimizer's update and whatever else it launches, in the eager
    order.  Over a mesh every rank calls its program at the same steps, so
    the ranks warm up, capture and replay the same collectives in the same
    order.

    The program's state is the model's parameters, every tensor of the
    optimizer's state and each group's learning rate, all of which must
    exist before the first call (``training.network.make_optimizer`` creates
    Adam's state, zero, and keeps the learning rate in a 0-d tensor): the
    warm-up step puts them back as it found them, so the first replay is
    the first update.  The gradients are left to the capture: the step sets
    them to None before its backward, which then allocates them in the
    graph's pool, and every replay writes them anew.  On a card the
    optimizer must be capturable (no host read of its step count).
    """

    def __init__(self, step, model, opt, batch_size: int):
        params = list(model.parameters())
        dev = params[0].device
        self.idx = torch.zeros(batch_size, dtype=torch.int64, device=dev)
        self.loss = torch.zeros((), dtype=torch.float32, device=dev)

        def run():
            self.loss.copy_(step(self.idx))

        opt_state = [t for p in params for t in opt.state[p].values() if isinstance(t, torch.Tensor)]
        lrs = [g["lr"] for g in opt.param_groups if isinstance(g["lr"], torch.Tensor)]
        self.program = StepProgram(run, params + opt_state + lrs, dev)

    def __call__(self, idx: torch.Tensor) -> torch.Tensor:
        """One step on the rows ``idx`` (B,) (int64, on the device) -> the
        loss, a 0-d tensor the next call overwrites."""
        self.idx.copy_(idx)
        self.program()
        return self.loss
