"""Public denoising API: the batched two-phase engine and its wrappers.

* :func:`process_frames` runs (B, T, 480) frames (or (T, 480) for one
  stream) through two phases per chunk: :func:`chunk.precompute_chunk`
  (biquad, decimation, kernel K1) and :func:`ops.frame_kernel.run_frame_loop`
  (kernel K2), with the biquad carry patched from the precompute.
* :class:`StreamBatch`, :func:`denoise_audio` and :class:`DenoiseState`
  all run on it; chunking never changes the output, because the carry is
  the complete inter-frame dependency.

Audio convention: f32 samples in the i16 range, 48 kHz mono per stream.
Every entry point takes the device as an argument; on a CUDA device the
kernels run, on the CPU their plain versions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .chunk import precompute_chunk
from .constants import FRAME_SIZE
from .model import ModelMeta, RnnModel
from .ops.frame_kernel import pack_weights, run_frame_loop
from .ops.rnn import Rnn
from .pipeline import DenoiseCarry, init_carry

# Full-f32 products everywhere: the Toeplitz biquad loses up to ~160 i16
# units at TF32, and the DFT bases are validated only at f32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class Engine:
    """A model's module state on one device, plus the kernel's packed int8
    weights (built once)."""

    def __init__(self, model: RnnModel, device):
        self.model = model
        self.device = torch.device(device)
        self.rnn = Rnn.from_params(model.params, model.meta, self.device)
        self.weights = (
            pack_weights(self.rnn, self.device) if self.device.type == "cuda" else None
        )


def _engine(model, device) -> Engine:
    """``model``: an Engine (used as is), an RnnModel, or None (the
    built-in model), placed on ``device``."""
    if isinstance(model, Engine):
        return model
    return Engine(model if model is not None else RnnModel.default(), device)


def init_batch_carry(meta: ModelMeta, batch: int, device) -> DenoiseCarry:
    """A zeroed carry for ``batch`` streams on ``device``."""
    return init_carry(meta, batch, device)


def process_chunk(engine: Engine, carry: DenoiseCarry, frames: torch.Tensor):
    """One chunk (B, T, 480) on the engine's device -> (carry', out
    (B, T, 480), vad (B, T)): phase 1, then phase 2 with the biquad carry
    patched from phase 1."""
    pre, hp_out = precompute_chunk(carry.feat.input_mem, carry.feat.hp_mem, frames)
    carry2, out, vad = run_frame_loop(engine.rnn, carry, pre, engine.weights)
    return carry2._replace(feat=carry2.feat._replace(hp_mem=hp_out)), out, vad


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

    Each call runs the batched engine at B=1.  As with the reference, the
    first output frame holds fade-in artifacts and is usually dropped.
    """

    FRAME_SIZE = FRAME_SIZE

    def __init__(self, model=None, device="cpu"):
        self.engine = _engine(model, device)
        self.reset()

    def reset(self) -> None:
        self.carry = init_batch_carry(self.engine.model.meta, 1, self.engine.device)

    def process_frame(self, frame) -> tuple[np.ndarray, float]:
        """Denoise one 480-sample frame; returns (output, vad_probability)."""
        frame = np.asarray(frame, np.float32)
        if frame.shape != (FRAME_SIZE,):
            raise ValueError(f"expected frame of shape ({FRAME_SIZE},)")
        out, vad = self.process_chunk(frame[None])
        return out[0], float(vad[0])

    def process_chunk(self, frames) -> tuple[np.ndarray, np.ndarray]:
        """Denoise (T, 480) frames in one engine call; returns (out, vad)."""
        frames = np.asarray(frames, np.float32)
        if frames.ndim != 2 or frames.shape[1] != FRAME_SIZE:
            raise ValueError(f"expected frames of shape (T, {FRAME_SIZE})")
        self.carry, out, vad = process_frames(self.engine, self.carry, frames)
        return out.cpu().numpy(), vad.cpu().numpy()


class StreamBatch:
    """A batch of independent denoiser streams (the engine's main entry).

    >>> batch = StreamBatch(batch=1024, device="cuda")
    >>> out, vad = batch.process(frames)        # frames: (1024, T, 480)
    """

    def __init__(self, batch: int, model=None, device="cpu"):
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
    device="cpu",
) -> np.ndarray:
    """Denoise a full mono signal (n,) or batch (B, n).

    Truncates the tail to whole frames (the reference CLI's behavior) and by
    default drops the first output frame.  Long signals run in
    ``chunk_frames``-frame chunks with exact carry handoff.
    """
    engine = _engine(model, device)
    audio = np.asarray(audio, np.float32)
    squeeze = audio.ndim == 1
    if squeeze:
        audio = audio[None]
    b, n = audio.shape
    t = n // FRAME_SIZE
    frames = torch.as_tensor(
        np.ascontiguousarray(audio[:, : t * FRAME_SIZE].reshape(b, t, FRAME_SIZE)),
        device=engine.device,
    )
    carry = init_batch_carry(engine.model.meta, b, engine.device)
    parts = []
    for start in range(0, t, chunk_frames):
        carry, out, _ = process_frames(engine, carry, frames[:, start : start + chunk_frames])
        parts.append(out.cpu().numpy())
    out = np.concatenate(parts, axis=1).reshape(b, t * FRAME_SIZE)
    if drop_first_frame:
        out = out[:, FRAME_SIZE:]
    return out[0] if squeeze else out
