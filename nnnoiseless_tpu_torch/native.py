"""ctypes binding to the native (C++) denoise engine.

A copy of ``nnnoiseless_tpu/native.py`` that imports this package's
constants, so that the port never loads JAX.  The native engine
(native/denoise_engine.cc) is a from-scratch C++ implementation of the
full pipeline behind the RNNoise-compatible C ABI (native/rnnoise.h;
reference surface src/capi.rs): the single-stream engine for work where a
device round trip is not worth it, and an independent oracle against the
CUDA engine.

The shared library is built on demand with ``make`` (g++) the first time it
is needed; set ``NNT_NATIVE_LIB`` to point at a prebuilt
``libnnt_denoise.so`` to skip that.

    >>> from nnnoiseless_tpu_torch.native import NativeDenoiseState
    >>> st = NativeDenoiseState()
    >>> out, vad = st.process_frame(frame480)
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import pathlib
import subprocess
from typing import Optional

import numpy as np

from .constants import FRAME_SIZE

_NATIVE_DIR = pathlib.Path(__file__).parent.parent / "native"
_LIB: Optional[ctypes.CDLL] = None


def _build_library() -> pathlib.Path:
    # Always invoke make: its dependency rules make this a cheap no-op when
    # the library is current, and it rebuilds after C++ source edits instead
    # of silently loading a stale binary.  Processes of this package build
    # one at a time (a lock on the Makefile), so none loads a library that
    # another is still writing.
    with open(_NATIVE_DIR / "Makefile", "rb") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run(["make", "-s"], cwd=_NATIVE_DIR, check=True)
    return _NATIVE_DIR / "libnnt_denoise.so"


def load_library() -> ctypes.CDLL:
    """Load (building if necessary) the native engine library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    path = os.environ.get("NNT_NATIVE_LIB")
    lib_path = pathlib.Path(path) if path else _build_library()
    lib = ctypes.CDLL(str(lib_path))

    lib.rnnoise_get_frame_size.restype = ctypes.c_int
    lib.rnnoise_get_size.restype = ctypes.c_size_t
    lib.rnnoise_create.restype = ctypes.c_void_p
    lib.rnnoise_create.argtypes = [ctypes.c_void_p]
    lib.rnnoise_destroy.argtypes = [ctypes.c_void_p]
    lib.rnnoise_process_frame.restype = ctypes.c_float
    lib.rnnoise_process_frame.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.rnnoise_reset.argtypes = [ctypes.c_void_p]
    lib.nnt_process_frames.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.nnt_model_from_bytes.restype = ctypes.c_void_p
    lib.nnt_model_from_bytes.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.rnnoise_model_free.argtypes = [ctypes.c_void_p]
    lib.nnt_get_pitch.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_float),
    ]

    assert lib.rnnoise_get_frame_size() == FRAME_SIZE
    _LIB = lib
    return lib


class NativeModel:
    """A parsed .rnn model owned by the native library."""

    def __init__(self, data: bytes):
        self._lib = load_library()
        self._ptr = self._lib.nnt_model_from_bytes(data, len(data))
        if not self._ptr:
            raise ValueError("malformed model bytes")

    def __del__(self):
        if getattr(self, "_ptr", None) and self._lib:
            self._lib.rnnoise_model_free(self._ptr)
            self._ptr = None


class NativeDenoiseState:
    """Single-stream denoiser backed by the native engine."""

    FRAME_SIZE = FRAME_SIZE

    def __init__(self, model: Optional[NativeModel] = None):
        self._lib = load_library()
        self._model = model  # keep alive: state borrows the model
        self._ptr = self._lib.rnnoise_create(model._ptr if model else None)
        if not self._ptr:
            raise RuntimeError("failed to create native denoise state")

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.rnnoise_destroy(self._ptr)
            self._ptr = None

    def reset(self) -> None:
        self._lib.rnnoise_reset(self._ptr)

    def process_frame(self, frame) -> tuple[np.ndarray, float]:
        frame = np.ascontiguousarray(frame, np.float32)
        if frame.shape != (FRAME_SIZE,):
            raise ValueError(f"expected frame of shape ({FRAME_SIZE},)")
        out = np.empty(FRAME_SIZE, np.float32)
        fp = ctypes.POINTER(ctypes.c_float)
        vad = self._lib.rnnoise_process_frame(
            self._ptr, out.ctypes.data_as(fp), frame.ctypes.data_as(fp)
        )
        return out, float(vad)

    def last_pitch(self) -> tuple[int, float]:
        """(period, gain) after the last processed frame — the
        post-octave-removal pitch state, for lag-exact cross-checks."""
        period = ctypes.c_int(0)
        gain = ctypes.c_float(0.0)
        self._lib.nnt_get_pitch(
            self._ptr, ctypes.byref(period), ctypes.byref(gain)
        )
        return int(period.value), float(gain.value)

    def process_frames(self, frames) -> tuple[np.ndarray, np.ndarray]:
        """(T, 480) frames in one FFI call -> (out (T, 480), vad (T,))."""
        frames = np.ascontiguousarray(frames, np.float32)
        t = frames.shape[0]
        assert frames.shape == (t, FRAME_SIZE)
        out = np.empty_like(frames)
        vad = np.empty(t, np.float32)
        fp = ctypes.POINTER(ctypes.c_float)
        self._lib.nnt_process_frames(
            self._ptr,
            out.ctypes.data_as(fp),
            frames.ctypes.data_as(fp),
            t,
            vad.ctypes.data_as(fp),
        )
        return out, vad


def denoise_audio_native(
    audio, model: Optional[NativeModel] = None, drop_first_frame: bool = True
) -> np.ndarray:
    """Mono (n,) f32 audio (i16 range) through the native engine."""
    audio = np.asarray(audio, np.float32)
    t = len(audio) // FRAME_SIZE
    st = NativeDenoiseState(model)
    out, _ = st.process_frames(audio[: t * FRAME_SIZE].reshape(t, FRAME_SIZE))
    out = out.reshape(-1)
    return out[FRAME_SIZE:] if drop_first_frame else out
