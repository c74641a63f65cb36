"""Phase 1 of a chunk: every frame-local product the frame loop needs.

For all T frames of a chunk at once: the high-pass biquad (f32 products,
ops/biquad.py), the 2x decimation of the filtered signal with its history,
the window-local lane-0 patch of each frame's decimated window
(pitch.rs:455-458), and kernel K1 (ops/pitch_kernel.py), which turns each
frame's window into the 105 octave-removal candidate lanes.  The lag-0
spectrum and its features are computed inside K2 from the input history
(the JAX package's ``precompute_chunk(..., lag0=False)``).
"""

from __future__ import annotations

import torch

from .constants import FRAME_SIZE
from .ops.biquad import biquad_filter_frames
from .ops.pitch_kernel import pitch_analysis_stream
from .pipeline import FramePre
from .tables import BIQUAD_HP_A, BIQUAD_HP_B


def decimate(full: torch.Tensor, t_count: int) -> tuple[torch.Tensor, torch.Tensor]:
    """[1/4, 1/2, 1/4] decimation of (B, L) ``full`` with x[-1] = 0 ->
    (ds (B, L/2), w0 (T, B)): ``w0[t]`` is lane 0 of frame t's window
    decimated window-locally (its own x[-1] is 0, not the sample before)."""
    b = full.shape[0]
    even = full[:, 0::2]
    odd = full[:, 1::2]
    prev_odd = torch.cat([torch.zeros((b, 1), dtype=full.dtype, device=full.device), odd[:, :-1]], 1)
    ds = ((prev_odd + odd) * 0.5 + even) * 0.5
    starts = FRAME_SIZE * (torch.arange(t_count, device=full.device) + 1)
    w0 = (full[:, starts + 1].T * 0.5 + full[:, starts].T) * 0.5
    return ds, w0.contiguous()


def precompute_chunk(
    input_mem: torch.Tensor, hp_mem: torch.Tensor, frames: torch.Tensor
) -> tuple[FramePre, torch.Tensor]:
    """(B, 1728) history, (B, 2) biquad carry, (B, T, 480) raw frames ->
    (FramePre with time-major (T, B, ...) fields, hp_mem' (B, 2))."""
    b, t, _ = frames.shape
    filtered, hp_out = biquad_filter_frames(
        frames, hp_mem, tuple(BIQUAD_HP_A), tuple(BIQUAD_HP_B)
    )
    # frame t's input history is full[:, 480(t+1) : 480(t+1) + 1728]
    full = torch.cat([input_mem, filtered.reshape(b, t * FRAME_SIZE)], dim=1)
    ds, w0 = decimate(full, t)
    cand, _ = pitch_analysis_stream(ds, w0, t)
    return FramePre(filtered=filtered.transpose(0, 1).contiguous(), cand=cand), hp_out
