"""Pitch analysis on 2x-decimated windows: whitening, two-stage search,
octave-removal candidates and the carry-dependent octave selection.

The plain PyTorch form of ``nnnoiseless_tpu/ops/pitch.py`` (re-deriving the
reference src/pitch.rs:63-221, 448-483).  Every function broadcasts over
leading axes, so a (T, B, 864) window stack is processed in one call.  The
385-lag correlation and the window-energy tables are direct f32 sums
(1-D convolutions).  The pitch kernel (csrc/pitch_kernel.cuh) takes the
correlation as direct f32 sums in another order and the energies as
differences of f64 prefix sums, so the two agree to rounding, and a
decision may flip only at a near-tie.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import (
    MAX_PITCH,
    PITCH_FRAME_DS,
    PITCH_MAX_DS,
    PITCH_MAX_PERIOD,
    PITCH_MIN_DS,
    PITCH_MIN_PERIOD,
)
from ..tables import SECOND_CHECK

N_LAGS = PITCH_MAX_DS + 1  # 385 correlation / energy lags
N_FINE = MAX_PITCH // 2  # 294 fine-search lags
N_COARSE = MAX_PITCH // 4  # 147 coarse lags
LEN4 = PITCH_FRAME_DS // 2  # 240: coarse kernel length
N_CAND = 105  # candidate lanes (doubling_candidates layout)

# 0.9, 0.9^2, ... with sequential f32 multiplies like the reference
# (pitch.rs:470-474).
LPC_TAPER = np.empty(4, dtype=np.float32)
_t = np.float32(1.0)
for _i in range(4):
    _t = np.float32(_t * np.float32(0.9))
    LPC_TAPER[_i] = _t
# ac[i] -= ac[i] * (0.008 i)^2, the lag window's f32 constants
LAG_WINDOW = [float(np.float32((0.008 * i) * (0.008 * i))) for i in range(5)]

# Rows per grouped-convolution call: bounds the temporaries at production
# batch (T*B ~ 4e5 windows).
_ROW_CHUNK = 1 << 16


def downsample_2x(x: torch.Tensor) -> torch.Tensor:
    """[1/4, 1/2, 1/4] decimation by 2: (..., 1728) -> (..., 864), with
    x[-1] = 0 (pitch.rs:455-458)."""
    even = x[..., 0::2]
    odd = x[..., 1::2]
    prev_odd = F.pad(odd[..., :-1], (1, 0))
    return ((prev_odd + odd) * 0.5 + even) * 0.5


def lpc4(ac: list) -> list:
    """Order-4 Levinson-Durbin with the reference's early-exit semantics
    (pitch.rs:257-292): zeros when ac[0] == 0, and every update frozen once
    the prediction error drops below 0.001 * ac[0].  ``ac``: five (...)
    tensors; returns four."""
    lpc = [torch.zeros_like(ac[0])] * 4
    error = ac[0]
    done = ac[0] == 0.0
    thresh = 0.001 * ac[0]
    for i in range(4):
        rr = ac[i + 1]
        for j in range(i):
            rr = rr + lpc[j] * ac[i - j]
        r = -rr / torch.where(done, torch.ones_like(error), error)
        new = list(lpc)
        new[i] = r
        for j in range((i + 1) // 2):
            tmp1, tmp2 = new[j], new[i - 1 - j]
            new[j] = tmp1 + r * tmp2
            new[i - 1 - j] = tmp2 + r * tmp1
        lpc = [torch.where(done, o, n) for o, n in zip(lpc, new)]
        error = torch.where(done, error, error - r * r * error)
        done = done | (error < thresh)
    return lpc


def whiten(x: torch.Tensor) -> torch.Tensor:
    """LPC whitening of (..., 864) decimated windows (pitch.rs:448-483):
    5-lag autocorrelation with the lag window, order-4 Levinson, 0.9 taper,
    and a 6-tap zero-history FIR with the 0.8 zero folded in."""
    n = x.shape[-1]
    ac = [(x * x).sum(-1)] + [(x[..., : n - k] * x[..., k:]).sum(-1) for k in range(1, 5)]
    ac[0] = ac[0] * float(np.float32(1.0001))
    for i in range(1, 5):
        ac[i] = ac[i] - ac[i] * LAG_WINDOW[i]
    c = [v * float(LPC_TAPER[i]) for i, v in enumerate(lpc4(ac))]
    taps = [
        c[0] + 0.8,
        c[1] + 0.8 * c[0],
        c[2] + 0.8 * c[1],
        c[3] + 0.8 * c[2],
        0.8 * c[3],
    ]
    y = x
    for j in range(1, 6):
        shifted = F.pad(x[..., : n - j], (j, 0))
        y = y + taps[j - 1][..., None] * shifted
    return y


def _by_rows(fn, *arrays):
    """Apply ``fn`` to (R, ...) row blocks of at most _ROW_CHUNK rows."""
    r = arrays[0].shape[0]
    if r <= _ROW_CHUNK:
        return fn(*arrays)
    return torch.cat(
        [fn(*(a[i : i + _ROW_CHUNK] for a in arrays)) for i in range(0, r, _ROW_CHUNK)]
    )


def window_energies(y: torch.Tensor, length: int, n_lags: int) -> torch.Tensor:
    """||y[k : k+length]||^2 for k in [0, n_lags), over leading axes."""
    lead = y.shape[:-1]
    y2 = (y * y).reshape(-1, 1, y.shape[-1])
    ones = torch.ones((1, 1, length), dtype=y.dtype, device=y.device)
    out = _by_rows(lambda v: F.conv1d(v, ones)[:, 0, :n_lags], y2)
    return out.reshape(lead + (n_lags,))


def sliding_dot(kernel: torch.Tensor, y: torch.Tensor, n_lags: int) -> torch.Tensor:
    """corr[s] = dot(kernel, y[s : s+len(kernel)]) for s in [0, n_lags),
    one kernel per row, over leading axes."""
    lead = y.shape[:-1]
    k2 = kernel.reshape(-1, kernel.shape[-1])
    y2 = y.reshape(-1, y.shape[-1])

    def rows(kk, yy):
        r = kk.shape[0]
        out = F.conv1d(yy[None], kk[:, None, :], groups=r)[0]
        return out[:, :n_lags]

    return _by_rows(rows, k2, y2).reshape(lead + (n_lags,))


def find_best_pitch(xcorr: torch.Tensor, energies: torch.Tensor):
    """Top-2 lags maximizing xcorr^2 / max(1 + energy, 1) over xcorr > 0
    (pitch.rs:372-405); the earlier lag wins ties.  With fewer than two
    qualified lags, ``second`` takes the reference's sentinels: 0 when one
    lag qualified, 1 when none did.  Returns int64 (...) tensors."""
    u = torch.clamp(1.0 + energies, min=1.0)
    qualified = xcorr > 0.0
    neg = torch.full_like(xcorr, float("-inf"))
    ratio = torch.where(qualified, (xcorr * xcorr) / u, neg)
    best = torch.argmax(ratio, dim=-1)  # first maximal index
    lanes = torch.arange(xcorr.shape[-1], device=xcorr.device)
    ratio2 = torch.where(lanes == best[..., None], neg, ratio)
    has_second = (ratio2 > float("-inf")).any(-1)
    fallback = torch.where(qualified.any(-1), 0, 1)
    second = torch.where(has_second, torch.argmax(ratio2, dim=-1), fallback)
    return best, second


def pitch_search(y: torch.Tensor, corr: torch.Tensor, energies: torch.Tensor,
                 coarse: bool = True):
    """Coarse/fine search on whitened (..., 864) windows (pitch.rs:63-115).

    ``corr`` / ``energies``: the shared (..., 385) correlation
    dot(y[384:864], y[s:s+480]) and forward window-energy tables.  Returns
    ``2*best - offset`` (int64), so the pitch index is 768 minus it.
    ``coarse=False`` stubs the coarse search (both picks 0), for the pitch
    kernel's ``skip`` knob."""
    if coarse:
        x4 = y[..., PITCH_MAX_DS::2][..., :LEN4]  # (..., 240)
        y4 = y[..., 0::2][..., : LEN4 + N_COARSE]  # (..., 387)
        xcorr4 = sliding_dot(x4, y4, N_COARSE)
        w4 = window_energies(y4, LEN4, N_COARSE)
        best4, second4 = find_best_pitch(xcorr4, w4)
    else:
        best4 = second4 = torch.zeros(y.shape[:-1], dtype=torch.int64, device=y.device)

    lags = torch.arange(N_FINE, device=y.device)
    near = ((lags - 2 * best4[..., None]).abs() <= 2) | (
        (lags - 2 * second4[..., None]).abs() <= 2
    )
    xcorr2 = torch.where(
        near, torch.clamp(corr[..., :N_FINE], min=-1.0), torch.zeros_like(corr[..., :N_FINE])
    )
    best2, _ = find_best_pitch(xcorr2, energies[..., :N_FINE])

    at = lambda i: xcorr2.gather(-1, i[..., None])[..., 0]
    a = at(torch.clamp(best2 - 1, 0, N_FINE - 1))
    b = at(best2)
    c = at(torch.clamp(best2 + 1, 0, N_FINE - 1))
    offset = torch.where(
        c - a > 0.7 * (b - a), 1, torch.where(a - c > 0.7 * (b - c), -1, 0)
    )
    interior = (best2 > 0) & (best2 < N_FINE - 1)
    return 2 * best2 - torch.where(interior, offset, 0)


def doubling_tables(y: torch.Tensor, corr: torch.Tensor | None = None,
                    energies: torch.Tensor | None = None):
    """Frame-local tables of octave removal for whitened (..., 864) windows:
    (corr_full, yy_lookup, xx), as the JAX package's ``doubling_tables``.

    ``corr_full`` (..., 385) is ``dot(y[384:864], y[s:s+480])``;
    ``yy_lookup[k] = max(energies[384 - k], 0)``, the reference's running
    energy table (pitch.rs:137-142) as a flip of the forward window
    energies; ``xx = yy_lookup[..., 0]``.  Shared ``corr``/``energies``
    tables are used as given."""
    if corr is None:
        corr = sliding_dot(y[..., PITCH_MAX_DS:], y, N_LAGS)
    if energies is None:
        energies = window_energies(y, PITCH_FRAME_DS, N_LAGS)
    yy_lookup = torch.clamp(energies.flip(-1), min=0.0)
    return corr, yy_lookup, yy_lookup[..., 0]


def candidate_lanes(t0: torch.Tensor, xx: torch.Tensor, corr_at, yy_at) -> torch.Tensor:
    """The 105 octave-removal lanes for (...) int64 ``t0``, with the
    caller's lookups ``corr_at(t)`` and ``yy_at(t)`` (the CUDA kernels
    share the same walk, csrc/candidate_lanes.cuh).  Layout::

        [0] t0  [1] g0  [2] xy0  [3] yy0
        [4:18] t1 (k = 2..15)  [18:32] xy_k  [32:46] yy_k  [46:60] g1_k
        [60:75] corr_at(c - 1)  [75:90] corr_at(c)  [90:105] corr_at(c + 1)
        for c in [t0, t1_2 .. t1_15]
    """
    maxp = PITCH_MAX_DS

    def pitch_gain(xy, yy):
        return xy / torch.sqrt(1.0 + xx * yy)

    xy0, yy0 = corr_at(t0), yy_at(t0)
    t1s, xys, yys, g1s = [], [], [], []
    for k in range(2, 16):
        t1 = (2 * t0 + k) // (2 * k)
        if k == 2:
            t1b = torch.where(t1 + t0 > maxp, t0, t0 + t1)
        else:
            t1b = (2 * SECOND_CHECK[k] * t0 + k) // (2 * k)
        xy = (corr_at(t1) + corr_at(t1b)) * 0.5
        yy = (yy_at(t1) + yy_at(t1b)) * 0.5
        t1s.append(t1)
        xys.append(xy)
        yys.append(yy)
        g1s.append(pitch_gain(xy, yy))
    cands = [t0] + t1s
    f = lambda vs: [v.to(torch.float32) for v in vs]
    lanes = (
        f([t0]) + [pitch_gain(xy0, yy0), xy0, yy0] + f(t1s) + xys + yys + g1s
        + [corr_at(t - 1) for t in cands]
        + [corr_at(t) for t in cands]
        + [corr_at(t + 1) for t in cands]
    )
    return torch.stack(lanes, dim=-1)


def doubling_candidates(
    corr: torch.Tensor, energies: torch.Tensor, pitch_idx: torch.Tensor
) -> torch.Tensor:
    """The frame-local candidate lanes of octave removal (pitch.rs:118-221):
    the JAX package's ``doubling_tables`` and ``doubling_candidates`` in one,
    (..., 105) f32 in the layout of :func:`candidate_lanes`.

    ``corr_at(t) = corr[384 - t]``; the reference's running energy table is
    ``yy(t) = max(energies[384 - t], 0)`` and ``xx = yy(0)``.  A lookup
    outside [0, 385) takes the nearest end of the table, as XLA's gather
    does: ``corr_at(-1)``, reached for pitch indices below 16, reads
    ``corr[384]``.
    """
    maxp = PITCH_MAX_DS

    def at(table, t):
        return table.gather(-1, torch.clamp(maxp - t, 0, maxp)[..., None])[..., 0]

    return candidate_lanes(
        torch.clamp(pitch_idx // 2, max=maxp - 1),
        torch.clamp(energies[..., maxp], min=0.0),
        lambda t: at(corr, t),
        lambda t: torch.clamp(at(energies, t), min=0.0),
    )


def remove_doubling_from_candidates(
    cand: torch.Tensor, last_period: torch.Tensor, last_gain: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The carry-dependent half of octave removal (pitch.rs:173-221): the
    sequential k = 2..15 threshold/select chain with the previous frame's
    continuity bonus, on (..., 105) candidate lanes.  Returns (period int32,
    gain f32)."""
    minp = float(PITCH_MIN_DS)
    t0, g0, xy0, yy0 = cand[..., 0], cand[..., 1], cand[..., 2], cand[..., 3]
    prev_period = torch.floor(last_period.to(torch.float32) * 0.5)
    best_xy, best_yy, t, g = xy0, yy0, t0, g0
    bidx = torch.zeros_like(t0)
    stopped = torch.zeros_like(t0, dtype=torch.bool)
    zero = torch.zeros_like(t0)
    for k in range(2, 16):
        t1 = cand[..., 4 + k - 2]
        active = ~stopped & (t1 >= minp)
        stopped = stopped | (t1 < minp)
        xy, yy, g1 = cand[..., 18 + k - 2], cand[..., 32 + k - 2], cand[..., 46 + k - 2]
        adiff = (t1 - prev_period).abs()
        cont = torch.where(
            adiff <= 1,
            last_gain,
            torch.where((adiff <= 2) & (5.0 * k * k < t0), last_gain * 0.5, zero),
        )
        # the middle branch is shadowed by the first, as in the reference
        thresh = torch.where(
            t1 < 3 * minp,
            torch.clamp(0.85 * g0 - cont, min=0.4),
            torch.where(
                t1 < 2 * minp,
                torch.clamp(0.9 * g0 - cont, min=0.5),
                torch.clamp(0.7 * g0 - cont, min=0.3),
            ),
        )
        upd = active & (g1 > thresh)
        best_xy = torch.where(upd, xy, best_xy)
        best_yy = torch.where(upd, yy, best_yy)
        t = torch.where(upd, t1, t)
        g = torch.where(upd, g1, g)
        bidx = torch.where(upd, float(k - 1), bidx)

    best_xy = torch.clamp(best_xy, min=0.0)
    pg = torch.where(best_yy <= best_xy, torch.ones_like(g), best_xy / (best_yy + 1.0))
    pick = lambda off: cand.gather(-1, (off + bidx.to(torch.int64))[..., None])[..., 0]
    c0, c1, c2 = pick(60), pick(75), pick(90)
    offset = torch.where(
        c2 - c0 > 0.7 * (c1 - c0),
        1.0,
        torch.where(c0 - c2 > 0.7 * (c1 - c2), -1.0, 0.0),
    )
    pg = torch.minimum(pg, g)
    period = torch.clamp(2 * t + offset, min=float(PITCH_MIN_PERIOD))
    return period.to(torch.int32), pg


def pitch_chain(windows: torch.Tensor, skip: tuple = ()) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw (..., 864) decimated windows -> ((..., 105) candidate lanes,
    (...) int32 pitch index): whiten, the shared 385-lag tables, the
    search and the candidate lanes.  ``skip`` stubs stages as the pitch
    kernel's knob does (ops/pitch_kernel.py::SKIP_STAGES): whiten y = x,
    etab and corr zeros, coarse both picks 0, cand every lane xx."""
    y = windows if "whiten" in skip else whiten(windows)
    zeros = lambda: torch.zeros(y.shape[:-1] + (N_LAGS,), dtype=y.dtype, device=y.device)
    corr = zeros() if "corr" in skip else sliding_dot(y[..., PITCH_MAX_DS:], y, N_LAGS)
    energies = zeros() if "etab" in skip else window_energies(y, PITCH_FRAME_DS, N_LAGS)
    pidx = PITCH_MAX_PERIOD - pitch_search(y, corr, energies, coarse="coarse" not in skip)
    if "cand" in skip:
        xx = torch.clamp(energies[..., PITCH_MAX_DS], min=0.0)
        cand = xx[..., None].expand(xx.shape + (N_CAND,)).contiguous()
    else:
        cand = doubling_candidates(corr, energies, pidx)
    return cand, pidx.to(torch.int32)


def pitch_process(
    input_mem: torch.Tensor, last_period: torch.Tensor, last_gain: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-frame pitch analysis of (B, 1728) input histories (reference
    PitchFinder::process): decimation, the window's analysis (kernel K3 on
    CUDA tensors, :func:`pitch_chain` on CPU ones) and octave removal with
    the previous (period, gain).  Returns (period (B,) int32, gain (B,))."""
    from .pitch_kernel import pitch_analysis_stacked

    cand, _ = pitch_analysis_stacked(downsample_2x(input_mem))
    return remove_doubling_from_candidates(cand, last_period, last_gain)
