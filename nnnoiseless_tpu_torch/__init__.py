"""nnnoiseless_tpu_torch — the batched streaming denoiser on PyTorch + CUDA.

The port of ``nnnoiseless_tpu`` (JAX/Pallas, kept as the reference) to one
NVIDIA H100: the same RNNoise-lineage suppressor (48 kHz mono streams,
10 ms frames, 22 Bark-band gains from an int8-valued GRU network, pitch
comb filtering, overlap-add resynthesis), with the Pallas kernels of its
paths rewritten as CUDA C++ kernels for ``sm_90a`` (``csrc/``): the
two-phase engine (K1, K2), the scan engine (K1, K5, K6), the per-frame
path (K3, K5, K6) and the tools (K4, K2's stage knob).  The per-frame step
and the scan engine's frame step run as CUDA graphs captured once and
replayed (``programs.py``).  It imports ``torch`` and never ``jax``.

Quick start::

    import nnnoiseless_tpu_torch as nt
    out = nt.denoise_audio(samples, device="cuda")   # (n,) f32, i16 range

    batch = nt.StreamBatch(batch=1024, device="cuda")
    out, vad = batch.process(frames)                 # (1024, T, 480)

    state = nt.DenoiseState(device="cuda")
    out, vad = state.process_frame(frame)            # one 480-sample frame

    for y in nt.DenoiseSignal(samples_pm1, device="cuda"): ...   # [-1, 1] samples

    python -m nnnoiseless_tpu_torch.cli in.wav out.wav --device cuda

Every entry point runs on the card (``device="cuda"``) unless the caller
asks for the CPU: without a card a CUDA device raises, and ``device="cpu"``
runs each kernel's plain PyTorch version instead.
"""

from .constants import FRAME_SIZE, FREQ_SIZE, NB_BANDS, NB_FEATURES
from .denoise import (
    DenoiseState,
    Engine,
    StreamBatch,
    denoise_audio,
    init_batch_carry,
    process_frames,
    scan_chunk,
)
from .model import ModelParseError, RnnModel, convert_rnnoise, params_from_numpy
from .pipeline import DenoiseCarry, FeatureState, FramePre, frame_step, init_carry
from .signal import DenoiseSignal

__all__ = [
    "FRAME_SIZE",
    "FREQ_SIZE",
    "NB_BANDS",
    "NB_FEATURES",
    "DenoiseSignal",
    "DenoiseState",
    "Engine",
    "StreamBatch",
    "denoise_audio",
    "process_frames",
    "scan_chunk",
    "frame_step",
    "init_batch_carry",
    "RnnModel",
    "ModelParseError",
    "convert_rnnoise",
    "params_from_numpy",
    "DenoiseCarry",
    "FeatureState",
    "FramePre",
    "init_carry",
]
