"""Diagnostic traces of the per-frame pitch decisions.

The lag-exact pitch cross-check: the reference's pitch selection is
sequential f32 arithmetic with data-dependent argmax decisions
(src/pitch.rs:372-405), and a +-1 lag flip audibly changes the output, so
the port's decisions are compared frame by frame against the independently
written native C++ engine.  The port's side is its production pitch path:
``chunk.precompute_chunk`` (kernel K1 on a CUDA device) and the octave
removal of ``ops/pitch.py::remove_doubling_from_candidates``, as
``nnnoiseless_tpu/tools/trace.py`` runs the JAX package's.

    python -m nnnoiseless_tpu_torch.tools.trace tests/data/testing.raw --device cuda
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..chunk import precompute_chunk
from ..constants import FRAME_SIZE, PITCH_BUF_SIZE
from ..denoise import check_device
from ..ops.pitch import remove_doubling_from_candidates


def pitch_trace(signal: np.ndarray, device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """Per-frame (period, gain) of the production pitch path from a fresh
    state, on ``device`` (a CUDA device without a card raises).

    ``signal`` is mono f32 in the i16 range; trailing samples beyond a whole
    frame are dropped.  Returns (periods (T,) int32, gains (T,) f32)."""
    device = check_device(device)
    signal = np.asarray(signal, np.float32)
    t = len(signal) // FRAME_SIZE
    frames = torch.as_tensor(signal[: t * FRAME_SIZE].reshape(1, t, FRAME_SIZE), device=device)
    zeros = lambda n: torch.zeros((1, n), dtype=torch.float32, device=device)
    pre, _ = precompute_chunk(zeros(PITCH_BUF_SIZE), zeros(2), frames)
    period = torch.zeros((1,), dtype=torch.int32, device=device)
    gain = torch.zeros((1,), dtype=torch.float32, device=device)
    periods, gains = [], []
    for i in range(t):
        period, gain = remove_doubling_from_candidates(pre.cand[i], period, gain)
        periods.append(period)
        gains.append(gain)
    return torch.cat(periods).cpu().numpy(), torch.cat(gains).cpu().numpy()


def pitch_trace_native(signal: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-frame (period, gain) from the native C++ engine (nnt_get_pitch)."""
    from ..native import NativeDenoiseState

    signal = np.asarray(signal, np.float32)
    t = len(signal) // FRAME_SIZE
    st = NativeDenoiseState()
    periods = np.empty(t, np.int64)
    gains = np.empty(t, np.float64)
    for i in range(t):
        st.process_frame(signal[i * FRAME_SIZE : (i + 1) * FRAME_SIZE])
        periods[i], gains[i] = st.last_pitch()
    return periods, gains


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="per-frame pitch trace against the native engine")
    ap.add_argument("INPUT", help="raw little-endian i16 mono file")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    signal = np.fromfile(args.INPUT, "<i2").astype(np.float32)
    pt, gt = pitch_trace(signal, args.device)
    pn, gn = pitch_trace_native(signal)
    differ = np.nonzero(pt != pn)[0]
    same = pt == pn
    print(f"{len(pt)} frames: periods differ at {len(differ)} "
          f"{[(int(i), int(pt[i]), int(pn[i])) for i in differ]}; gains where they agree: "
          f"max |d| {np.abs(gt[same] - gn[same]).max(initial=0.0):.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
