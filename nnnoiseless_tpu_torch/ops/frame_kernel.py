"""Kernel K2: the whole carry-coupled frame loop of a chunk.

Replaces ``nnnoiseless_tpu/ops/frame_kernel.py::frame_loop_pallas`` (and its
adapter ``run_fused_scan``).  Per frame and stream, in order
(``frame_kernel.py:537-757`` there, reference src/features.rs and
src/denoise.rs:95-116):

1. shift the HP-filtered frame into the 1728-sample input history;
2. lag-0 analysis: windowed DFT of ``mem[768:1728]``, band energies, the
   floored log spectrum, the DCT cepstrum and the silence gate;
3. octave removal from the precomputed candidate lanes and the previous
   period/gain;
4. the window at the pitch lag, ``mem[768 - period + i]``, and its DFT;
5. band correlation and the 42 features (cepstral shift register, deltas,
   spectral variability);
6. silence masking of the features and of every state update;
7. the RNN with table activations;
8. the pitch comb filter and renormalization;
9. the gain hangover ``max(g, 0.6 lastg)`` and interpolation to bins;
10. the inverse DFT and overlap-add with the synthesis memory.

:func:`frame_loop` launches ``csrc/frame_kernel.cu`` for CUDA tensors and
runs :func:`frame_loop_plain` for CPU tensors.  Both return the packed
``(T, B, 512)`` output (frame in lanes 0:480, vad 480, period 481, pitch
gain 482, zeros after) and the new carry arrays.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from ..pipeline import (
    DenoiseCarry, FeatureState, _pitch_filter, cepstrum, frame_features, log_spectrum,
)
from ..constants import CEPS_MEM, FRAME_SIZE, NB_BANDS, PITCH_BUF_SIZE, WINDOW_SIZE
from ..tables import BAND_CORR_MATRIX, BAND_INTERP_MATRIX, DCT_TABLE, TANSIG_TABLE
from .bands import band_energies, interp_band_gain
from .fft import dft_bases
from .pitch import N_CAND, remove_doubling_from_candidates
from .rnn import Rnn, RnnState
from .rnn_kernel import pack_weights

OFF_VAD = 480
OFF_PERIOD = 481
OFF_PGAIN = 482
OUT_LANES = 512
_OFF = PITCH_BUF_SIZE - WINDOW_SIZE  # 768

# Kernel launches since the last reset (the plain version does not count).
launches = 0

# carry arrays, in kernel order, with their per-stream shapes
CARRY_SHAPES = (
    ("mem", (PITCH_BUF_SIZE,)),
    ("synth", (FRAME_SIZE,)),
    ("cmem", (CEPS_MEM * NB_BANDS,)),
    ("hv", (24,)),
    ("hn", (48,)),
    ("hd", (96,)),
    ("lastg", (NB_BANDS,)),
    ("period", ()),
    ("pgain", ()),
)


def frame_loop_plain(rnn: Rnn, carry: tuple, filt: torch.Tensor, cand: torch.Tensor):
    """The plain PyTorch version: a loop over T of batched tensor ops (the
    analysis tail and the comb filter are pipeline.py's)."""
    mem, synth, cmem, hv, hn, hd, lastg, period, pgain = carry
    fwd, inv = dft_bases(filt.device)
    t_count, b, _ = filt.shape
    packed = torch.zeros((t_count, b, OUT_LANES), dtype=torch.float32, device=filt.device)
    cmem = cmem.reshape(b, CEPS_MEM, NB_BANDS)
    lanes960 = torch.arange(WINDOW_SIZE, device=filt.device)
    for t in range(t_count):
        mem = torch.cat([mem[:, FRAME_SIZE:], filt[t]], dim=1)
        x = torch.matmul(mem[:, _OFF:], fwd)  # (B, 962) lag-0 spectrum
        ex = band_energies(x)
        ly, energy = log_spectrum(ex)
        sil = energy < 0.04
        period, pgain = remove_doubling_from_candidates(cand[t], period, pgain)
        idx = (_OFF - period.to(torch.int64))[:, None] + lanes960
        p = torch.matmul(mem.gather(1, idx), fwd)  # spectrum at the pitch lag
        ep = band_energies(p)
        features, exp, cmem = frame_features(cmem, x, p, ex, ep, sil, cepstrum(ly), period)

        st, gains, vad = rnn(RnnState(hv, hn, hd), features)
        s1 = sil[:, None]
        hv, hn, hd = (torch.where(s1, old, new) for old, new in zip((hv, hn, hd), st))
        g2 = torch.maximum(gains, 0.6 * lastg)
        x_comb = _pitch_filter(x, p, ex, ep, exp, gains)
        x_final = torch.where(s1, x, x_comb * interp_band_gain(g2))
        lastg = torch.where(s1, lastg, g2)

        y = torch.matmul(x_final, inv)  # (B, 960)
        packed[t, :, :FRAME_SIZE] = y[:, :FRAME_SIZE] + synth
        synth = y[:, FRAME_SIZE:]
        packed[t, :, OFF_VAD] = torch.where(sil, 0.0, vad)
        packed[t, :, OFF_PERIOD] = period.to(torch.float32)
        packed[t, :, OFF_PGAIN] = pgain
    cmem = cmem.reshape(b, CEPS_MEM * NB_BANDS)
    return packed, (mem, synth, cmem, hv, hn, hd, lastg, period, pgain)


@functools.lru_cache(maxsize=8)
def _tables(device: torch.device):
    """The kernel's constant operands on ``device``: F, IV, the band
    matrix with each band's [first, last) nonzero bin, the interpolation
    matrix, the DCT and the tansig table."""
    fwd, inv = dft_bases(device)
    nz = BAND_CORR_MATRIX != 0
    ranges = np.stack(
        [nz.argmax(1), BAND_CORR_MATRIX.shape[1] - nz[:, ::-1].argmax(1)], axis=1
    ).astype(np.int32)
    t = lambda m: torch.as_tensor(np.ascontiguousarray(m), device=device)
    return (
        fwd, inv, t(BAND_CORR_MATRIX), t(ranges), t(BAND_INTERP_MATRIX),
        t(DCT_TABLE), t(TANSIG_TABLE),
    )


def _check(carry, filt, cand):
    if filt.ndim != 3 or filt.shape[2] != FRAME_SIZE:
        raise ValueError(f"filt must be (T, B, {FRAME_SIZE}), got {tuple(filt.shape)}")
    t_count, b, _ = filt.shape
    if cand.shape != (t_count, b, N_CAND):
        raise ValueError(f"cand must be ({t_count}, {b}, {N_CAND}), got {tuple(cand.shape)}")
    for (name, shape), arr in zip(CARRY_SHAPES, carry):
        if tuple(arr.shape) != (b,) + shape:
            raise ValueError(f"carry {name} must be {(b,) + shape}, got {tuple(arr.shape)}")
        want = torch.int32 if name == "period" else torch.float32
        if arr.dtype != want:
            raise TypeError(f"carry {name} must be {want}, got {arr.dtype}")
        if arr.device != filt.device:
            raise ValueError(f"carry {name} is on {arr.device}, filt on {filt.device}")
    for name, arr in (("filt", filt), ("cand", cand)):
        if arr.dtype != torch.float32 or arr.device != filt.device:
            raise TypeError(f"{name} must be float32 on {filt.device}")


def frame_loop_cuda(rnn: Rnn, weights: tuple, carry: tuple, filt, cand):
    """Launch K2 on the current CUDA stream.  ``weights``:
    ops/rnn_kernel.py::pack_weights."""
    global launches
    _check(carry, filt, cand)
    if not rnn.standard_topology():
        raise ValueError("the frame kernel is built for the standard model topology")
    tensors = (*carry, filt, cand, *weights)
    if not all(a.is_contiguous() for a in tensors):
        raise ValueError("frame kernel operands must be contiguous")
    t_count, b, _ = filt.shape
    packed = torch.empty((t_count, b, OUT_LANES), dtype=torch.float32, device=filt.device)
    out = tuple(torch.empty_like(a) for a in carry)
    if b and t_count:
        tables = _tables(filt.device)
        stream = torch.cuda.current_stream(filt.device).cuda_stream
        ptr = lambda ts: [a.data_ptr() for a in ts]
        err = _build.library().nnt_frame_loop(
            *ptr(tables), *ptr(weights), *ptr(carry), filt.data_ptr(), cand.data_ptr(),
            packed.data_ptr(), *ptr(out), b, t_count, stream,
        )
        _build.check(err, "nnt_frame_loop")
        launches += 1
    else:
        out = tuple(a.clone() for a in carry)
    return packed, out


def frame_loop(rnn: Rnn, carry: tuple, filt: torch.Tensor, cand: torch.Tensor,
               weights: tuple | None = None):
    """Run the frame loop over a chunk: carry arrays (see CARRY_SHAPES),
    time-major ``filt`` (T, B, 480) and ``cand`` (T, B, 105) -> (packed
    (T, B, 512), new carry arrays)."""
    if filt.is_cuda:
        if weights is None:
            weights = pack_weights(rnn, filt.device)
        return frame_loop_cuda(rnn, weights, carry, filt, cand)
    if filt.device.type != "cpu":
        raise ValueError(f"unsupported device {filt.device}")
    _check(carry, filt, cand)
    return frame_loop_plain(rnn, carry, filt, cand)


def carry_arrays(carry) -> tuple:
    """A DenoiseCarry as the kernel's carry tuple (contiguous)."""
    feat = carry.feat
    b = feat.input_mem.shape[0]
    return tuple(
        a.contiguous()
        for a in (
            feat.input_mem, carry.synthesis_mem,
            feat.cepstral_mem.reshape(b, CEPS_MEM * NB_BANDS),
            carry.rnn.vad, carry.rnn.noise, carry.rnn.denoise, carry.lastg,
            feat.pitch_period.to(torch.int32), feat.pitch_gain,
        )
    )


def run_frame_loop(rnn: Rnn, carry, pre, weights: tuple | None = None,
                   return_trace: bool = False):
    """Adapter: DenoiseCarry + FramePre -> (carry', out (B, T, 480),
    vad (B, T)), plus (periods (B, T) int32, gains (B, T)) with
    ``return_trace``.  ``hp_mem`` passes through (the chunk filter owns it)."""
    packed, cf = frame_loop(rnn, carry_arrays(carry), pre.filtered, pre.cand, weights)
    mem, synth, cmem, hv, hn, hd, lastg, per, pg = cf
    b = mem.shape[0]
    new_carry = DenoiseCarry(
        feat=FeatureState(
            input_mem=mem,
            hp_mem=carry.feat.hp_mem,
            cepstral_mem=cmem.reshape(b, CEPS_MEM, NB_BANDS),
            pitch_period=per,
            pitch_gain=pg,
        ),
        synthesis_mem=synth,
        rnn=RnnState(hv, hn, hd),
        lastg=lastg,
    )
    out = packed[:, :, :FRAME_SIZE].transpose(0, 1)
    vad = packed[:, :, OFF_VAD].transpose(0, 1)
    if return_trace:
        trace = (
            packed[:, :, OFF_PERIOD].transpose(0, 1).to(torch.int32),
            packed[:, :, OFF_PGAIN].transpose(0, 1),
        )
        return new_carry, out, vad, trace
    return new_carry, out, vad
