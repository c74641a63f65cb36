"""Public denoising API: the two batched engines, the per-frame path, and
their wrappers.

* :func:`process_frames` runs (B, T, 480) frames (or (T, 480) for one
  stream) through the engine its :class:`Engine` chose once:
  the two-phase engine, :func:`chunk.precompute_chunk` (biquad,
  decimation, kernel K1) then :func:`ops.frame_kernel.run_frame_loop`
  (kernel K2); or the scan engine, :func:`scan_chunk`.  Either patches the
  biquad carry from the precompute.
* :class:`StreamBatch` and :func:`denoise_audio` run on it; chunking never
  changes the output, because the carry is the complete inter-frame
  dependency.
* :meth:`DenoiseState.process_frame` is the reference's per-frame API: one
  :func:`pipeline.frame_step` at B=1 (kernels K3, K5, K6 on CUDA) as a
  captured program (``programs.FrameProgram``), or the native C++ engine
  with ``engine="native"``.

Audio convention: f32 samples in the i16 range, 48 kHz mono per stream.
Every entry point takes the device as an argument, ``"cuda"`` by default:
on a CUDA device the kernels run, and ``device="cpu"`` runs their plain
versions.  Without a card a CUDA device raises (:func:`check_device`); it
never falls back to the CPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import flags, tracing
from .chunk import precompute_chunk
from .constants import FRAME_SIZE
from .model import ModelMeta, RnnModel
from .ops.frame_kernel import run_frame_loop
from .ops.rnn import Rnn
from .ops.rnn_kernel import pack_tiled
from .pipeline import DenoiseCarry, init_carry
from .programs import FrameProgram, ScanProgram, assign, snapshot

# Full-f32 products everywhere: the Toeplitz biquad loses up to ~160 i16
# units at TF32, and the DFT bases are validated only at f32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def check_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} needs a CUDA card and none is available; "
            'pass device="cpu" to run the plain versions on the CPU'
        )
    return device


class Engine:
    """A model's module state on one device, the engine that serves it, and
    the kernels' packed int8 weights (built once): ``rnn_weights``, the
    tiled layout K2 and K5 take.

    ``two_phase`` (precompute, then kernel K2) when ``fused`` is set and the
    model has the standard topology, the rule of the JAX package's
    ``two_phase_available``/``fused_scan_available``; the scan engine
    (:func:`scan_chunk`) otherwise.  ``fused`` defaults to ``NNT_FUSED``.
    The scan engine's frame loop runs as one :class:`programs.ScanProgram`
    a batch size, built at its first chunk and kept (:meth:`scan_program`).
    """

    def __init__(self, model: RnnModel, device, fused: bool = flags.FUSED):
        self.model = model
        self.device = check_device(device)
        self.rnn = Rnn.from_params(model.params, model.meta, self.device)
        standard = self.rnn.standard_topology()
        self.two_phase = fused and standard
        on_card = self.device.type == "cuda" and standard
        self.rnn_weights = pack_tiled(self.rnn, self.device) if on_card else None
        self.scan_programs: dict[int, ScanProgram] = {}

    def scan_program(self, batch: int) -> ScanProgram:
        """The scan engine's frame program for ``batch`` streams."""
        if batch not in self.scan_programs:
            self.scan_programs[batch] = ScanProgram(self, batch)
        return self.scan_programs[batch]


def _engine(model, device) -> Engine:
    """``model``: an Engine (used as is), an RnnModel, or None (the
    built-in model), placed on ``device``."""
    if isinstance(model, Engine):
        return model
    return Engine(model if model is not None else RnnModel.default(), device)


def init_batch_carry(meta: ModelMeta, batch: int, device) -> DenoiseCarry:
    """A zeroed carry for ``batch`` streams on ``device``."""
    return init_carry(meta, batch, device)


def _with_hp_mem(carry: DenoiseCarry, hp_mem: torch.Tensor) -> DenoiseCarry:
    return carry._replace(feat=carry.feat._replace(hp_mem=hp_mem))


def scan_chunk(engine: Engine, carry: DenoiseCarry, frames: torch.Tensor,
               return_trace: bool = False):
    """The scan engine on one chunk (B, T, 480) -> (carry', out (B, T, 480),
    vad (B, T)), plus (periods (B, T) int32, pitch gains (B, T)) with
    ``return_trace``, as ``ops.frame_kernel.run_frame_loop`` gives them.

    The JAX package's ``_scan_batch``: the precompute with its lag-0
    products (kernel K1 on CUDA), then the T frames of
    :func:`pipeline.frame_step_hoisted` (kernels K5 and K6 on CUDA), each
    a replay of the engine's :class:`programs.ScanProgram` for B streams.
    The returned carry's tensors are its own.  The two phases are the
    spans ``chunk.precompute`` and ``chunk.frame_loop``."""
    with tracing.span("chunk.precompute"):
        pre, hp_out = precompute_chunk(carry.feat.input_mem, carry.feat.hp_mem, frames, lag0=True)
    with tracing.span("chunk.frame_loop"):
        carry, *rest = engine.scan_program(frames.shape[0])(carry, pre, return_trace)
    return (_with_hp_mem(carry, hp_out), *rest)


def process_chunk(engine: Engine, carry: DenoiseCarry, frames: torch.Tensor):
    """One chunk (B, T, 480) on the engine's device -> (carry', out
    (B, T, 480), vad (B, T)): the scan engine, or the two-phase engine,
    whose phase 2 takes the biquad carry patched from phase 1.  The call
    is the span ``chunk``; its phases ``chunk.precompute`` and
    ``chunk.frame_loop``."""
    with tracing.span("chunk"):
        if not engine.two_phase:
            return scan_chunk(engine, carry, frames)
        with tracing.span("chunk.precompute"):
            pre, hp_out = precompute_chunk(carry.feat.input_mem, carry.feat.hp_mem, frames)
        with tracing.span("chunk.frame_loop"):
            carry2, out, vad = run_frame_loop(engine.rnn, carry, pre, engine.rnn_weights)
        return _with_hp_mem(carry2, hp_out), out, vad


def process_frames(model, carry: DenoiseCarry, frames, device=None):
    """Run frames through the denoiser.

    ``model``: an :class:`Engine` (or an RnnModel, wrapped for ``device``).
    ``frames``: (T, 480) for one stream or (B, T, 480); the carry has the
    matching batch (a (T, 480) call takes a batch-1 carry).  Returns
    (carry', out, vad) as tensors on the engine's device.
    """
    engine = _engine(model, device if device is not None else carry.lastg.device)
    frames = torch.as_tensor(frames, dtype=torch.float32, device=engine.device)
    if frames.ndim == 2:
        carry, out, vad = process_chunk(engine, carry, frames[None])
        return carry, out[0], vad[0]
    if frames.ndim == 3:
        return process_chunk(engine, carry, frames)
    raise ValueError(f"frames must be (T,480) or (B,T,480), got {tuple(frames.shape)}")


class DenoiseState:
    """Stateful single-stream denoiser, mirroring the reference API.

    >>> state = DenoiseState(device="cuda")
    >>> out, vad = state.process_frame(frame)   # frame: 480 f32 samples

    ``engine="torch"``: :meth:`process_frame` runs :func:`pipeline.frame_step`
    at B=1, as the JAX package does, through the state's own
    :class:`programs.FrameProgram`: on a card a CUDA graph captured at the
    first call (its pool the state's own) and replayed once a frame; on
    the CPU the same static carry around the eager step.  The carry lives
    in the program's static tensors: :meth:`reset` zeroes them in place,
    :meth:`process_chunk` runs the batched engine at B=1 from them and
    writes its carry back, ``carry`` reads a copy of them and assigning to
    it copies into them.  ``engine="native"``: the in-process C++ engine
    (native/denoise_engine.cc through ``native.py``), no device at all; a
    custom model reaches it as its ``.rnn`` bytes.  As with the reference,
    the first output frame holds fade-in artifacts and is usually dropped.
    """

    FRAME_SIZE = FRAME_SIZE

    def __init__(self, model=None, device="cuda", engine: str = "torch"):
        if engine not in ("torch", "native"):
            raise ValueError(f"engine must be 'torch' or 'native', got {engine!r}")
        self.backend = engine
        if engine == "native":
            from .native import NativeDenoiseState, NativeModel

            rnn_model = model.model if isinstance(model, Engine) else model
            # the library ships the default weights; only a custom model
            # needs the (lossless) .rnn round trip into its parser
            self._nmodel = NativeModel(rnn_model.to_bytes()) if rnn_model is not None else None
            self._nstate = NativeDenoiseState(self._nmodel)
            self.engine = self.program = None
        else:
            self.engine = _engine(model, device)
            self.program = FrameProgram(self.engine)

    # Constructor aliases mirroring the reference's new/from_model/with_model
    # (ownership distinctions do not exist in Python; all share the model).
    @classmethod
    def new(cls, device="cuda", engine: str = "torch") -> "DenoiseState":
        return cls(None, device, engine)

    @classmethod
    def from_model(cls, model, device="cuda", engine: str = "torch") -> "DenoiseState":
        return cls(model, device, engine)

    with_model = from_model

    def reset(self) -> None:
        if self.backend == "native":
            self._nstate.reset()
        else:
            self.program.reset()

    @property
    def carry(self) -> Optional[DenoiseCarry]:
        """A copy of the stream's carry (batch 1); None on the native engine."""
        return snapshot(self.program.carry) if self.program is not None else None

    @carry.setter
    def carry(self, value: DenoiseCarry) -> None:
        if self.program is None:
            raise ValueError("the native engine keeps its state to itself")
        assign(self.program.carry, value)

    def process_frame(self, frame) -> tuple[np.ndarray, float]:
        """Denoise one 480-sample frame; returns (output, vad_probability)."""
        frame = np.asarray(frame, np.float32)
        if frame.shape != (FRAME_SIZE,):
            raise ValueError(f"expected frame of shape ({FRAME_SIZE},)")
        if self.backend == "native":
            return self._nstate.process_frame(frame)
        return self.program(frame)

    def process_chunk(self, frames) -> tuple[np.ndarray, np.ndarray]:
        """Denoise (T, 480) frames in one engine call; returns (out, vad)."""
        frames = np.ascontiguousarray(frames, np.float32)
        if frames.ndim != 2 or frames.shape[1] != FRAME_SIZE:
            raise ValueError(f"expected frames of shape (T, {FRAME_SIZE})")
        if self.backend == "native":
            return self._nstate.process_frames(frames)
        carry, out, vad = process_frames(self.engine, self.program.carry, frames)
        assign(self.program.carry, carry)
        return out.cpu().numpy(), vad.cpu().numpy()


class StreamBatch:
    """A batch of independent denoiser streams (the engine's main entry).

    >>> batch = StreamBatch(batch=1024, device="cuda")
    >>> out, vad = batch.process(frames)        # frames: (1024, T, 480)
    """

    def __init__(self, batch: int, model=None, device="cuda"):
        self.engine = _engine(model, device)
        self.batch = batch
        self.reset()

    def reset(self) -> None:
        self.carry = init_batch_carry(self.engine.model.meta, self.batch, self.engine.device)

    def process_tensor(self, frames: torch.Tensor):
        """(B, T, 480) frames -> (out, vad) tensors on the device, without a
        host copy (the caller synchronises when it reads them)."""
        if frames.ndim != 3 or frames.shape[0] != self.batch or frames.shape[2] != FRAME_SIZE:
            raise ValueError(f"expected frames of shape ({self.batch}, T, {FRAME_SIZE})")
        self.carry, out, vad = process_frames(self.engine, self.carry, frames)
        return out, vad

    def process(self, frames) -> tuple[np.ndarray, np.ndarray]:
        out, vad = self.process_tensor(
            torch.as_tensor(np.asarray(frames, np.float32), device=self.engine.device)
        )
        return out.cpu().numpy(), vad.cpu().numpy()


def denoise_audio(
    audio,
    model: Optional[RnnModel] = None,
    drop_first_frame: bool = True,
    chunk_frames: int = 1000,
    device="cuda",
) -> np.ndarray:
    """Denoise a full mono signal (n,) or batch (B, n).

    Truncates the tail to whole frames (the reference CLI's behavior) and by
    default drops the first output frame.  Long signals run in
    ``chunk_frames``-frame chunks with exact carry handoff; the frames stay
    in host memory and each chunk is uploaded for its own call, so the
    device holds one chunk of input at a time, as in the JAX package.
    """
    engine = _engine(model, device)
    audio = np.asarray(audio, np.float32)
    squeeze = audio.ndim == 1
    if squeeze:
        audio = audio[None]
    b, n = audio.shape
    t = n // FRAME_SIZE
    frames = audio[:, : t * FRAME_SIZE].reshape(b, t, FRAME_SIZE)
    carry = init_batch_carry(engine.model.meta, b, engine.device)
    parts = []
    for start in range(0, t, chunk_frames):
        chunk = np.ascontiguousarray(frames[:, start : start + chunk_frames])
        carry, out, _ = process_frames(engine, carry, chunk)
        parts.append(out.cpu().numpy())
    out = np.concatenate(parts, axis=1).reshape(b, t * FRAME_SIZE)
    if drop_first_frame:
        out = out[:, FRAME_SIZE:]
    return out[0] if squeeze else out
