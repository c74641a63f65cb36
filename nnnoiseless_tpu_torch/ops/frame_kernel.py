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
gain 482, zeros after) and the new carry arrays.  ``skip`` stubs out
stages to attribute the kernel's time (``tools/attrib.py``), as the TPU
kernel's knob does (``frame_kernel.py:596-756`` there); see SKIP_STAGES.
The kernel computes its three transforms as FFTs inside the block
(``ops/fft.py``, ``csrc/fft960.cuh``); the plain version keeps the dense
bases.

Kernel K4 replaces ``candidates_pallas`` there: the 105 candidate lanes
of ``ops/pitch.py::doubling_candidates`` from precomputed tables, with the
TPU kernel's rule that a lookup off the table reads 0.  :func:`candidates`
launches ``csrc/candidates_kernel.cu`` for CUDA tensors and runs
:func:`candidates_plain` for CPU tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from ..pipeline import (
    DenoiseCarry, FeatureState, _pitch_filter, cepstrum, frame_features, log_spectrum,
)
from ..constants import CEPS_MEM, FRAME_SIZE, NB_BANDS, PITCH_BUF_SIZE, PITCH_MAX_DS, WINDOW_SIZE
from ..tables import BAND_CORR_MATRIX, BAND_INTERP_MATRIX, DCT_TABLE, TANSIG_TABLE
from .bands import band_energies, interp_band_gain
from .fft import dft_bases, fft960_table_on
from .pitch import N_CAND, N_LAGS, candidate_lanes, remove_doubling_from_candidates
from .rnn import Rnn, RnnState
from .rnn_kernel import check_tiled, pack_tiled

OFF_VAD = 480
OFF_PERIOD = 481
OFF_PGAIN = 482
OUT_LANES = 512
_OFF = PITCH_BUF_SIZE - WINDOW_SIZE  # 768

# Kernel launches since the last reset (the plain versions do not count):
# K2 in ``launches``, K4 in ``cand_launches``.
launches = 0
cand_launches = 0

# Stages the ``skip`` knob stubs out, bit i of the kernel's mask for stage i:
#   rd    octave removal: period max(2 t0, 60), pitch gain 0
#   lag0  lag-0 analysis: x = [filt, filt, filt[:2]], ceps = ex, never silent
#   dft   the pitch-lag window and its DFT: p = x
#   feat  features: [ceps, ceps[:20]], no silence mask
#   rnn   the RNN: gains |f[:22]| 0.01, vad f[0], states unchanged
#   comb  the comb filter: x_comb = x
#   inv   the inverse DFT: out = x_final[:480] + synth, synth unchanged
SKIP_STAGES = ("rd", "lag0", "dft", "feat", "rnn", "comb", "inv")

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


def _skip_mask(skip) -> int:
    unknown = set(skip) - set(SKIP_STAGES)
    if unknown:
        raise ValueError(f"unknown skip stages {sorted(unknown)}; known: {SKIP_STAGES}")
    return sum(1 << SKIP_STAGES.index(name) for name in set(skip))


def frame_loop_plain(rnn: Rnn, carry: tuple, filt: torch.Tensor, cand: torch.Tensor,
                     skip: tuple = ()):
    """The plain PyTorch version: a loop over T of batched tensor ops (the
    analysis tail and the comb filter are pipeline.py's), with the stubs
    of ``skip`` (SKIP_STAGES, any combination)."""
    _skip_mask(skip)
    mem, synth, cmem, hv, hn, hd, lastg, period, pgain = carry
    fwd, inv = dft_bases(filt.device)
    t_count, b, _ = filt.shape
    packed = torch.zeros((t_count, b, OUT_LANES), dtype=torch.float32, device=filt.device)
    cmem = cmem.reshape(b, CEPS_MEM, NB_BANDS)
    lanes960 = torch.arange(WINDOW_SIZE, device=filt.device)
    for t in range(t_count):
        mem = torch.cat([mem[:, FRAME_SIZE:], filt[t]], dim=1)
        if "lag0" in skip:
            x = torch.cat([filt[t], filt[t], filt[t, :, :2]], dim=1)
            ex = band_energies(x)
            sil = torch.zeros((b,), dtype=torch.bool, device=filt.device)
            ceps = ex
        else:
            x = torch.matmul(mem[:, _OFF:], fwd)  # (B, 962) lag-0 spectrum
            ex = band_energies(x)
            ly, energy = log_spectrum(ex)
            sil = energy < 0.04
            ceps = cepstrum(ly)
        if "rd" in skip:
            period = torch.clamp(cand[t, :, 0].to(torch.int32) * 2, min=60)
            pgain = cand[t, :, 1] * 0.0
        else:
            period, pgain = remove_doubling_from_candidates(cand[t], period, pgain)
        if "dft" in skip:
            p = x
        else:
            idx = (_OFF - period.to(torch.int64))[:, None] + lanes960
            p = torch.matmul(mem.gather(1, idx), fwd)  # spectrum at the pitch lag
        ep = band_energies(p)
        features, exp, cmem = frame_features(cmem, x, p, ex, ep, sil, ceps, period)
        if "feat" in skip:
            features = torch.cat([ceps, ceps[:, :20]], dim=1)

        s1 = sil[:, None]
        if "rnn" in skip:
            gains, vad = features[:, :NB_BANDS].abs() * 0.01, features[:, 0]
        else:
            st, gains, vad = rnn(RnnState(hv, hn, hd), features)
            hv, hn, hd = (torch.where(s1, old, new) for old, new in zip((hv, hn, hd), st))
        g2 = torch.maximum(gains, 0.6 * lastg)
        x_comb = x if "comb" in skip else _pitch_filter(x, p, ex, ep, exp, gains)
        x_final = torch.where(s1, x, x_comb * interp_band_gain(g2))
        lastg = torch.where(s1, lastg, g2)

        if "inv" in skip:
            packed[t, :, :FRAME_SIZE] = x_final[:, :FRAME_SIZE] + synth
        else:
            y = torch.matmul(x_final, inv)  # (B, 960)
            packed[t, :, :FRAME_SIZE] = y[:, :FRAME_SIZE] + synth
            synth = y[:, FRAME_SIZE:]
        packed[t, :, OFF_VAD] = torch.where(sil, 0.0, vad)
        packed[t, :, OFF_PERIOD] = period.to(torch.float32)
        packed[t, :, OFF_PGAIN] = pgain
    cmem = cmem.reshape(b, CEPS_MEM * NB_BANDS)
    return packed, (mem, synth, cmem, hv, hn, hd, lastg, period, pgain)


def interp_pairs() -> tuple[np.ndarray, np.ndarray]:
    """BAND_INTERP_MATRIX as each bin's two weights and first band: (481,
    2) f32 ``w`` and (481,) int32 ``band`` with ``row = w[0] e_band +
    w[1] e_(band+1)``; bins above the last band have zero weights."""
    m = BAND_INTERP_MATRIX
    nz = m != 0
    band = np.where(nz.any(1), nz.argmax(1), 0)
    rows = np.arange(m.shape[0])
    w = np.stack([m[rows, band], m[rows, band + 1]], axis=1)
    return w.astype(np.float32), band.astype(np.int32)


@functools.lru_cache(maxsize=8)
def _tables(device: torch.device):
    """The kernel's constant operands on ``device``: the FFT table, the
    band matrix with each band's [first, last) nonzero bin, the
    interpolation pairs, the DCT and the tansig table."""
    nz = BAND_CORR_MATRIX != 0
    ranges = np.stack(
        [nz.argmax(1), BAND_CORR_MATRIX.shape[1] - nz[:, ::-1].argmax(1)], axis=1
    ).astype(np.int32)
    t = lambda m: torch.as_tensor(np.ascontiguousarray(m), device=device)
    iw, ib = interp_pairs()
    return (
        fft960_table_on(device), t(BAND_CORR_MATRIX), t(ranges), t(iw), t(ib),
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


def frame_loop_cuda(rnn: Rnn, weights: tuple, carry: tuple, filt, cand, skip: tuple = ()):
    """Launch K2 on the current CUDA stream.  ``weights``:
    ops/rnn_kernel.py::pack_tiled (another layout raises).  The kernel is
    built for ``skip`` of at most one stage."""
    global launches
    mask = _skip_mask(skip)
    if len(set(skip)) > 1:
        raise ValueError(f"the frame kernel stubs one stage at a time, got {tuple(skip)}")
    _check(carry, filt, cand)
    if not rnn.standard_topology():
        raise ValueError("the frame kernel is built for the standard model topology")
    w, acts = check_tiled(weights, filt.device)
    if not all(a.is_contiguous() for a in (*carry, filt, cand)):
        raise ValueError("frame kernel operands must be contiguous")
    t_count, b, _ = filt.shape
    packed = torch.empty((t_count, b, OUT_LANES), dtype=torch.float32, device=filt.device)
    out = tuple(torch.empty_like(a) for a in carry)
    if b and t_count:
        tables = _tables(filt.device)
        stream = torch.cuda.current_stream(filt.device).cuda_stream
        ptr = lambda ts: [a.data_ptr() for a in ts]
        err = _build.library().nnt_frame_loop(
            *ptr(tables), w.data_ptr(), acts.data_ptr(), w.numel(), *ptr(carry), filt.data_ptr(),
            cand.data_ptr(), packed.data_ptr(), *ptr(out), b, t_count, mask, stream,
        )
        _build.check(err, "nnt_frame_loop")
        launches += 1
    else:
        out = tuple(a.clone() for a in carry)
    return packed, out


def frame_loop(rnn: Rnn, carry: tuple, filt: torch.Tensor, cand: torch.Tensor,
               weights: tuple | None = None, skip: tuple = ()):
    """Run the frame loop over a chunk: carry arrays (see CARRY_SHAPES),
    time-major ``filt`` (T, B, 480) and ``cand`` (T, B, 105) -> (packed
    (T, B, 512), new carry arrays).  ``skip``: stages to stub out
    (SKIP_STAGES), for attribution only."""
    if filt.is_cuda:
        if weights is None:
            weights = pack_tiled(rnn, filt.device)
        return frame_loop_cuda(rnn, weights, carry, filt, cand, skip)
    if filt.device.type != "cpu":
        raise ValueError(f"unsupported device {filt.device}")
    _check(carry, filt, cand)
    return frame_loop_plain(rnn, carry, filt, cand, skip)


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
                   return_trace: bool = False, skip: tuple = ()):
    """Adapter: DenoiseCarry + FramePre -> (carry', out (B, T, 480),
    vad (B, T)), plus (periods (B, T) int32, gains (B, T)) with
    ``return_trace``.  ``hp_mem`` passes through (the chunk filter owns it).
    ``skip``: see :func:`frame_loop`."""
    packed, cf = frame_loop(rnn, carry_arrays(carry), pre.filtered, pre.cand, weights, skip)
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


# ---------------------------------------------------------------------------
# Kernel K4: candidate lanes from precomputed tables
# ---------------------------------------------------------------------------


def candidates_plain(corr: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor,
                     pidx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K4 (``frame_kernel.py:361-402`` of the
    JAX package): ``t0 = min(pidx // 2, 383)``, ``corr_at(t) = corr[384 -
    t]``, ``yy_at(t) = yy[t]``, and a lookup outside [0, 385) reads 0."""

    def lookup(table, i):
        got = table.gather(-1, torch.clamp(i, 0, N_LAGS - 1)[:, None])[:, 0]
        return torch.where((i >= 0) & (i < N_LAGS), got, 0.0)

    return candidate_lanes(
        torch.clamp(pidx.to(torch.int64) // 2, max=PITCH_MAX_DS - 1), xx,
        lambda t: lookup(corr, PITCH_MAX_DS - t), lambda t: lookup(yy, t),
    )


def _check_cand(corr, yy, xx, pidx):
    r = corr.shape[0]
    if corr.ndim != 2 or corr.shape[1] != N_LAGS or yy.shape != corr.shape:
        raise ValueError(f"corr and yy must be (R, {N_LAGS}), got {tuple(corr.shape)}, {tuple(yy.shape)}")
    if xx.shape != (r,) or pidx.shape != (r,):
        raise ValueError(f"xx and pidx must be ({r},), got {tuple(xx.shape)}, {tuple(pidx.shape)}")
    for name, arr in (("corr", corr), ("yy", yy), ("xx", xx)):
        if arr.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {arr.dtype}")
    if pidx.dtype != torch.int32:
        raise TypeError(f"pidx must be int32, got {pidx.dtype}")
    if not all(a.device == corr.device for a in (yy, xx, pidx)):
        raise ValueError("corr, yy, xx and pidx must be on one device")


def candidates_cuda(corr: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor,
                    pidx: torch.Tensor) -> torch.Tensor:
    """Launch K4 on the current CUDA stream; returns (R, 105) f32."""
    global cand_launches
    _check_cand(corr, yy, xx, pidx)
    if not all(a.is_contiguous() for a in (corr, yy, xx, pidx)):
        raise ValueError("candidate kernel operands must be contiguous")
    r = corr.shape[0]
    out = torch.empty((r, N_CAND), dtype=torch.float32, device=corr.device)
    if r:
        stream = torch.cuda.current_stream(corr.device).cuda_stream
        err = _build.library().nnt_candidates(
            corr.data_ptr(), yy.data_ptr(), xx.data_ptr(), pidx.data_ptr(), out.data_ptr(), r, stream
        )
        _build.check(err, "nnt_candidates")
        cand_launches += 1
    return out


def candidates(corr: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor,
               pidx: torch.Tensor) -> torch.Tensor:
    """(R, 385) correlation ``corr`` and energy lookup ``yy``
    (``ops/pitch.py::doubling_tables``), (R,) ``xx``, (R,) int32 ``pidx``
    -> (R, 105) candidate lanes."""
    if corr.is_cuda:
        return candidates_cuda(corr, yy, xx, pidx)
    if corr.device.type != "cpu":
        raise ValueError(f"unsupported device {corr.device}")
    _check_cand(corr, yy, xx, pidx)
    return candidates_plain(corr, yy, xx, pidx)
