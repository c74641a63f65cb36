"""Audio I/O helpers: WAV/raw reading with the reference's scaling rules,
16-tap windowed-sinc resampling, and i16 writing.  A copy of
``nnnoiseless_tpu/audio_io.py`` (numpy and scipy only), so that the port
never loads JAX.

Mirrors the CLI input conventions (src/nnnoiseless.rs:179-228):

* raw input: little-endian i16, interleaved channels;
* integer WAV: samples shifted to the 16-bit range
  (``s << (16-bits)`` below 16 bits, ``s >> (bits-16)`` above);
* float WAV: scaled by 32767;
* all audio is resampled to 48 kHz when needed (the reference uses a 16-tap
  sinc from ``dasp``; we implement an equivalent-quality Hann-windowed sinc,
  vectorized — resampling quality is not covered by the bit-parity oracle).
"""

from __future__ import annotations

import wave
from typing import Tuple

import numpy as np


def read_wav(path) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (samples (n, channels) f32 in i16 range, rate).

    Supports PCM (8/16/24/32-bit) and IEEE float via scipy.
    """
    from scipy.io import wavfile

    rate, data = wavfile.read(path)
    if data.ndim == 1:
        data = data[:, None]
    if data.dtype == np.int16:
        out = data.astype(np.float32)
    elif data.dtype == np.int32:
        # scipy widens 24/32-bit PCM to int32 at full scale; shift to 16-bit.
        out = (data >> 16).astype(np.float32)
    elif data.dtype == np.uint8:
        out = ((data.astype(np.int32) - 128) << 8).astype(np.float32)
    elif data.dtype in (np.float32, np.float64):
        out = (data * 32767.0).astype(np.float32)
    else:
        raise ValueError(f"unsupported wav dtype {data.dtype}")
    return out, int(rate)


def read_raw(path, channels: int = 1) -> np.ndarray:
    """Little-endian interleaved i16 -> (n, channels) f32."""
    data = np.fromfile(path, dtype="<i2")
    n = len(data) // channels
    return data[: n * channels].astype(np.float32).reshape(n, channels)


def write_wav(path, samples: np.ndarray, rate: int = 48_000) -> None:
    """Write (n, channels) f32 (i16 range) as 16-bit PCM WAV."""
    if samples.ndim == 1:
        samples = samples[:, None]
    i16 = np.clip(np.round(samples), -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(samples.shape[1])
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(i16.tobytes())


def write_raw(path, samples: np.ndarray) -> None:
    """Write (n, channels) f32 as interleaved little-endian i16."""
    i16 = np.clip(np.round(samples), -32768, 32767).astype("<i2")
    i16.tofile(path)


def resample_to_48k(samples: np.ndarray, rate: int, taps: int = 16) -> np.ndarray:
    """Windowed-sinc resampling of (n, channels) audio to 48 kHz.

    Vectorized over output samples and channels: each output gathers `taps`
    neighbors around its fractional input position, weighted by a
    Hann-windowed sinc.
    """
    if rate == 48_000:
        return samples
    n, ch = samples.shape
    ratio = rate / 48_000.0
    n_out = int(n / ratio)
    # fractional input position of every output sample
    t = (np.arange(1, n_out + 1, dtype=np.float64)) * ratio
    base = np.floor(t).astype(np.int64)
    frac = t - base
    half = taps // 2
    offsets = np.arange(-half + 1, half + 1)
    idx = np.clip(base[:, None] + offsets[None, :], 0, n - 1)  # (n_out, taps)
    d = frac[:, None] - offsets[None, :]  # distance to each tap
    w = np.sinc(d) * (0.5 + 0.5 * np.cos(np.pi * d / half)) * (np.abs(d) < half)
    out = np.einsum("ot,otc->oc", w, samples[idx].astype(np.float64))
    return out.astype(np.float32)
