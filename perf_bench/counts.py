"""The work each measured function needs, from its shapes alone: operations
(an FMA counts two) by the reference algorithm (nnnoiseless src/pitch.rs,
src/features.rs, src/rnn.rs), bytes as each input read once and each output
written once.  Nothing here depends on how the program computes; a kernel
that skips redundant work reads closer to its bound, never above it.

Peaks: NVIDIA's published H100 SXM figures, FP32 outside the tensor cores
(the program runs FP32 with TF32 off) and HBM3 bandwidth.
"""

from __future__ import annotations

import numpy as np

from .reference import tables as tb

PEAK_FLOPS = 67e12  # FP32, H100 SXM
PEAK_BYTES = 3.35e12  # B/s, H100 SXM HBM3
F32 = 4


def bound_s(n_bytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the two times."""
    return max(n_bytes / PEAK_BYTES, flops / PEAK_FLOPS)


def rnn_macs(f=42, d=24, v=24, n=48, h=96, g=22) -> int:
    """MACs of the RNN a stream-frame: dense f->d, GRUs of v, n, h with the
    reset gate applied before the recurrent product, heads h->g and v->1."""
    return f * d + 3 * v * (d + v) + 3 * n * (d + v + f + n) + 3 * h * (v + n + f + h) + h * g + v


def band_nnz() -> int:
    """Nonzeros of the (22, 481) band matrix."""
    return int(np.count_nonzero(tb.band_matrices()[0]))


def fft960_flops() -> int:
    """Flops of a windowed 960-point real FFT, forward or inverse: 960 window
    products, a 480-point complex FFT as 32 15-point DFTs (3 x 5 prime
    factors), the non-trivial twiddles, 15 radix-2 32-point DFTs, and the
    real split (one complex product and 8 adds a bin pair), no product by
    a twiddle of 1, -1, i or -i."""
    dft3 = 2 + 4 + 4 + 2 + 4
    dft5 = 8 + 16 + 12 + 4 + 8
    pfa15 = 5 * dft3 + 3 * dft5
    twiddles = sum(1 for n2 in range(32) for k1 in range(15) if n2 * k1 % 120)
    stage_twiddles = sum((1 << s) * sum(1 for j in range(16 >> s) if 4 * j % (32 >> s)) for s in range(5))
    radix32 = 5 * 16 * 4 + 6 * stage_twiddles
    split = 239 * (4 + 6 + 4) + 2
    return 960 + 32 * pfa15 + 6 * twiddles + 15 * radix32 + split


def pitch_window_macs() -> int:
    """MACs a decimated 864-sample window needs in the reference's pitch
    analysis up to the octave-removal candidates (pitch.rs:63-172,
    448-483): the 5-lag autocorrelation and the 5-tap FIR of the whitening;
    the coarse search's 147 x 240 correlation and its 240-sample energy
    with two updates a lag; the fine search's correlations at the five lags
    around each of the two coarse picks (10 x 480) and its energy (480 plus
    two updates over 294 lags); the candidates' running energy table (480
    plus two updates over 384 lags) and the 59 distinct correlations of 480
    that the 15 candidates' lanes hold (t0, t1 and t1b of k = 2..15, and
    c - 1, c + 1 of each candidate)."""
    whiten = 5 * 864 + 5 * 864
    coarse = tb.N_COARSE * tb.LEN4 + tb.LEN4 + 2 * tb.N_COARSE
    fine = 10 * tb.FRAME_DS + tb.FRAME_DS + 2 * tb.N_FINE
    lanes = tb.FRAME_DS + 2 * tb.MAX_DS + 59 * tb.FRAME_DS
    return whiten + coarse + fine + lanes


def k1_work(b: int, t: int) -> tuple[float, float]:
    """K1 on B streams x T frames: (bytes, flops).  It reads the decimated
    signal (864 + 240 T a stream) and the T window-local lane-0 values, and
    writes 105 lanes and a pitch index a window."""
    windows = b * t
    n_bytes = F32 * (b * (864 + 240 * t) + windows * (1 + 105 + 1))
    return n_bytes, 2.0 * pitch_window_macs() * windows


CARRY_FLOATS = 1728 + 480 + 8 * 22 + 24 + 48 + 96 + 22 + 2


def k2_work(b: int, t: int) -> tuple[float, float]:
    """K2 on B streams x T frames: (bytes, flops).  A stream-frame reads its
    480 filtered samples and 105 candidate lanes and writes a 512-float
    row; the carry is read and written once.  Per stream-frame: three
    FFTs, the RNN, four band-sum passes over the band matrix's nonzeros (re
    and im), the comb filter and gains over 962 lanes (13 flops a lane),
    two 22 x 22 DCTs and the 64 cepstral distances."""
    windows = b * t
    per = (3 * fft960_flops() + 2 * rnn_macs() + 4 * 6 * band_nnz() + 13 * 962
           + 2 * 2 * 22 * 22 + 64 * 22 * 2)
    return F32 * (windows * (480 + 105 + 512) + 2 * b * CARRY_FLOATS), float(per) * windows


def frame_flops() -> float:
    """Flops of the reference's whole frame a stream: the HP biquad (8 a
    sample), the 2x decimation (4 a sample of 864), the pitch analysis to
    the candidates, the octave choice (about 30 a k), K2's per-frame work
    (see :func:`k2_work`) and the overlap-add (480)."""
    k2 = k2_work(1, 1)[1]
    return 8 * 480 + 4 * 864 + 2.0 * pitch_window_macs() + 30 * 14 + k2 + 480


def train_step_flops(batch: int, frames: int) -> float:
    """A train step: 3 x (2 x forward MACs) a frame (forward, and a
    backward of twice the forward), over batch x frames frames."""
    return 3.0 * 2.0 * rnn_macs() * batch * frames
