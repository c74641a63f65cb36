"""Phase 1 of a chunk: every frame-local product the frame loop needs.

For all T frames of a chunk at once: the high-pass biquad (f32 products,
ops/biquad.py), the 2x decimation of the filtered signal with its history,
the window-local lane-0 patch of each frame's decimated window
(pitch.rs:455-458), and kernel K1 (ops/pitch_kernel.py), which turns each
frame's window into the 105 octave-removal candidate lanes.

With ``lag0=True`` (the scan engine) it also computes each frame's lag-0
spectrum, band energies, silence gate and cepstrum; with ``lag0=False``
(the two-phase engine) kernel K2 computes those from the input history
and the fields stay None.
"""

from __future__ import annotations

import torch

from .constants import FRAME_SIZE, PITCH_BUF_SIZE, WINDOW_SIZE
from .ops.bands import band_energies
from .ops.biquad import biquad_filter_frames
from .ops.fft import dft_bases
from .ops.pitch_kernel import pitch_analysis_stream
from .pipeline import FramePre, cepstrum, log_spectrum
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
    input_mem: torch.Tensor, hp_mem: torch.Tensor, frames: torch.Tensor, lag0: bool = False
) -> tuple[FramePre, torch.Tensor]:
    """(B, 1728) history, (B, 2) biquad carry, (B, T, 480) raw frames ->
    (FramePre with time-major (T, B, ...) fields, hp_mem' (B, 2))."""
    b, t, _ = frames.shape
    filtered, hp_out = biquad_filter_frames(
        frames, hp_mem, tuple(BIQUAD_HP_A), tuple(BIQUAD_HP_B)
    )
    filtered_tm = filtered.transpose(0, 1).contiguous()
    # frame t's input history is full[:, 480(t+1) : 480(t+1) + 1728]
    full = torch.cat([input_mem, filtered.reshape(b, t * FRAME_SIZE)], dim=1)
    ds, w0 = decimate(full, t)
    cand, _ = pitch_analysis_stream(ds, w0, t)
    pre = FramePre(filtered=filtered_tm, cand=cand)
    if lag0:
        # Frame t's lag-0 window is [frame t-1 | frame t] of the filtered
        # signal, so the basis is split in halves and applied to the frame
        # stack and its one-frame-shifted view: no (T, B, 960) stack.
        fwd = dft_bases(frames.device)[0]
        first_prev = input_mem[:, PITCH_BUF_SIZE - WINDOW_SIZE + FRAME_SIZE :]
        fprev = torch.cat([first_prev[None], filtered_tm[:-1]], dim=0)
        x = torch.matmul(fprev, fwd[:FRAME_SIZE]) + torch.matmul(filtered_tm, fwd[FRAME_SIZE:])
        ex = band_energies(x)
        ly, energy = log_spectrum(ex)
        pre = pre._replace(x=x, ex=ex, silence=energy < 0.04, ceps=cepstrum(ly))
    return pre, hp_out
