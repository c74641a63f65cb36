"""Streaming signal adapter: denoise an iterator of audio frames.

Equivalent of the reference's dasp ``DenoiseSignal`` (src/signal.rs): wraps
any iterable of float samples in [-1, 1] (mono) or per-channel tuples,
rescales by 32768 into the denoiser's i16-range convention, runs one
denoiser state per channel (batched on device), discards the first output
frame (fade-in artifacts, signal.rs:83-87), and yields clamped [-1, 1]
samples with the same channel structure.  The semantics of
``nnnoiseless_tpu/signal.py``, on the port's engines.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Sequence, Union

import numpy as np

from .constants import FRAME_SIZE
from .denoise import Engine, StreamBatch
from .model import RnnModel

Sample = Union[float, Sequence[float]]


class _NativeChannelBatch:
    """StreamBatch-shaped facade over per-channel native engine states."""

    def __init__(self, channels: int, model):
        from .native import NativeDenoiseState, NativeModel

        if isinstance(model, Engine):
            model = model.model
        nmodel = NativeModel(model.to_bytes()) if model is not None else None
        self._nmodel = nmodel  # states borrow the model; keep it alive
        self._states = [NativeDenoiseState(nmodel) for _ in range(channels)]

    def process(self, frames: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        out = np.empty_like(frames)
        vad = np.empty(frames.shape[:2], np.float32)
        for c, st in enumerate(self._states):
            out[c], vad[c] = st.process_frames(np.ascontiguousarray(frames[c]))
        return out, vad


class DenoiseSignal:
    """Iterator adapter: ``for sample in DenoiseSignal(samples): ...``

    ``latency_frames`` sets the buffering: that many 10 ms frames are
    pulled from the source and denoised in one engine call (one
    :class:`StreamBatch` chunk with the channels on the batch axis), then
    yielded sample by sample.  Each call has a fixed cost on top of its
    frames (host launches, and on a CUDA device the copies each way), so
    larger values amortize it; ``latency_frames=1`` is the reference's
    per-frame pull, the least latency (src/signal.rs:90-106).

    ``engine="native"`` runs the in-process C++ engine instead, one state
    per channel and no device: the engine for one live stream at
    ``latency_frames=1``.  ``engine="torch"`` runs the batched engine on
    ``device``.
    """

    def __init__(
        self,
        source: Iterable[Sample],
        model: Optional[RnnModel] = None,
        channels: Optional[int] = None,
        latency_frames: int = 50,
        engine: str = "torch",
        device="cuda",
    ):
        if latency_frames < 1:
            raise ValueError("latency_frames must be >= 1")
        if engine not in ("torch", "native"):
            raise ValueError(f"engine must be 'torch' or 'native', got {engine!r}")
        self._source = iter(source)
        self._first = next(self._source, None)
        if self._first is None:
            self._channels = channels or 1
        elif isinstance(self._first, (int, float, np.floating, np.integer)):
            self._channels = 1
        else:
            self._channels = len(self._first)
        if channels is not None and channels != self._channels:
            raise ValueError("explicit channels disagrees with source frames")
        if engine == "native":
            self._batch = _NativeChannelBatch(self._channels, model)
        else:
            self._batch = StreamBatch(self._channels, model, device)
        self._scalar = self._channels == 1 and (
            self._first is None
            or isinstance(self._first, (int, float, np.floating, np.integer))
        )
        self._latency = int(latency_frames)
        self._exhausted = False
        self._dropped_first = False

    # -- constructor aliases mirroring the reference -----------------------
    @classmethod
    def new(cls, source, **kwargs) -> "DenoiseSignal":
        return cls(source, **kwargs)

    @classmethod
    def with_model(cls, source, model, **kwargs) -> "DenoiseSignal":
        return cls(source, model, **kwargs)

    from_model = with_model

    def _next_input_frames(self, max_frames: int) -> tuple[Optional[np.ndarray], int]:
        """Pull up to ``max_frames`` whole frames -> ((channels, m, 480) in
        i16 range, n_real_samples); the last frame is zero-padded at source
        exhaustion but only ``n_real_samples`` of the pulled samples are
        real.  Returns (None, 0) when the source is already empty."""
        buf = np.zeros((self._channels, max_frames * FRAME_SIZE), np.float32)
        n = 0
        while n < max_frames * FRAME_SIZE:
            if self._first is not None:
                s = self._first
                self._first = None
            else:
                s = next(self._source, None)
            if s is None:
                self._exhausted = True
                break
            if self._scalar:
                buf[0, n] = float(s) * 32768.0
            else:
                buf[:, n] = np.asarray(s, np.float32) * 32768.0
            n += 1
        if n == 0:
            return None, 0
        m = -(-n // FRAME_SIZE)  # frames, zero-padded tail
        return buf[:, : m * FRAME_SIZE].reshape(self._channels, m, FRAME_SIZE), n

    def __iter__(self) -> Iterator[Sample]:
        """Yields exactly one output sample per input sample consumed,
        minus the discarded fade-in frame (signal.rs:83-87): a partial
        final frame is zero-padded for the DSP but the pad samples are
        never emitted (the reference adapter, an infinite dasp::Signal,
        likewise never hands real callers synthesized pad output —
        signal.rs:116-137)."""
        while True:
            frames, n_real = self._next_input_frames(self._latency)
            if frames is None:
                return
            out, _vad = self._batch.process(frames)  # (C, m, 480)
            start = 0
            if not self._dropped_first:
                self._dropped_first = True
                start = 1  # fade-in frame (signal.rs:83-87)
                n_real -= min(n_real, FRAME_SIZE)
                if frames.shape[1] == 1:
                    continue
            flat = out[:, start:, :].reshape(self._channels, -1)
            flat = np.clip(flat / 32768.0, -1.0, 1.0)
            for i in range(min(flat.shape[1], n_real)):
                yield float(flat[0, i]) if self._scalar else tuple(flat[:, i])
