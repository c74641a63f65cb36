"""Constants, tables and the ``.rnn`` reader of the plain reference.

A frozen copy of the geometry and tables of the RNNoise lineage
(nnnoiseless src/lib.rs:36-148, src/util.rs:3-71, src/rnn.rs:75-222),
built here from their definitions in float64 and rounded to float32 as the
reference does.  Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np

FRAME = 480  # 10 ms at 48 kHz
WINDOW = 960
FREQ = 481
PITCH_BUF = 1728  # PITCH_MAX_PERIOD + PITCH_FRAME_SIZE
LAG0 = PITCH_BUF - WINDOW  # 768: start of the lag-0 window in the history
PITCH_MIN_PERIOD = 60
PITCH_MAX_PERIOD = 768
MAX_DS = PITCH_MAX_PERIOD // 2  # 384
MIN_DS = PITCH_MIN_PERIOD // 2  # 30
FRAME_DS = 480  # PITCH_FRAME_SIZE / 2
N_LAGS = MAX_DS + 1  # 385
MAX_PITCH = PITCH_MAX_PERIOD - 3 * PITCH_MIN_PERIOD  # 588
N_FINE = MAX_PITCH // 2  # 294
N_COARSE = MAX_PITCH // 4  # 147
LEN4 = FRAME_DS // 2  # 240
NB_BANDS = 22
CEPS_MEM = 8
NB_DELTA = 6
NB_FEATURES = 42
EBAND_5MS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 34, 40, 48, 60, 78, 100)
SECOND_CHECK = (0, 0, 3, 2, 3, 2, 5, 2, 3, 2, 3, 2, 5, 2, 3, 2)
BIQUAD_A = (float(np.float32(-1.99599)), float(np.float32(0.99600)))
BIQUAD_B = (-2.0, 1.0)
WEIGHTS_SCALE = 1.0 / 256.0
TANH, SIGMOID, RELU = 0, 1, 2
LAYERS = ("input_dense", "vad_gru", "noise_gru", "denoise_gru", "denoise_output", "vad_output")
GRUS = ("vad_gru", "noise_gru", "denoise_gru")


def vorbis_window() -> tuple[np.ndarray, float]:
    """The power-complementary window and 1 / its f32 sum of squares."""
    i = np.arange(FRAME, dtype=np.float64)
    s = np.sin(0.5 * np.pi * (i + 0.5) / FRAME)
    half = np.sin(0.5 * np.pi * s * s).astype(np.float32)
    window = np.concatenate([half, half[::-1]])
    acc = np.float32(0.0)
    for w in window:
        acc = np.float32(acc + np.float32(w * w))
    return window, float(np.float32(1.0) / acc)


def dct_table() -> np.ndarray:
    """(22, 22): out[i] = sum_j x[j] table[j, i], column 0 scaled by sqrt(1/2)."""
    i = np.arange(NB_BANDS, dtype=np.float64)[:, None]
    j = np.arange(NB_BANDS, dtype=np.float64)[None, :]
    table = np.cos((i + 0.5) * j * np.pi / NB_BANDS).astype(np.float32)
    table[:, 0] *= np.float32(np.sqrt(0.5))
    return table


DCT_SCALE = float(np.float32(np.sqrt(2.0 / NB_BANDS)))


def band_matrices() -> tuple[np.ndarray, np.ndarray]:
    """(22, 481) band sums of a power spectrum (first and last band doubled)
    and (481, 22) per-bin interpolation of band values (zero from bin 400)."""
    corr = np.zeros((NB_BANDS, FREQ))
    interp = np.zeros((FREQ, NB_BANDS))
    for b in range(NB_BANDS - 1):
        size = (EBAND_5MS[b + 1] - EBAND_5MS[b]) * 4
        for j in range(size):
            frac = j / size
            idx = EBAND_5MS[b] * 4 + j
            corr[b, idx] += 1.0 - frac
            corr[b + 1, idx] += frac
            interp[idx, b] = 1.0 - frac
            interp[idx, b + 1] = frac
    corr[0] *= 2.0
    corr[-1] *= 2.0
    return corr.astype(np.float32), interp.astype(np.float32)


def tansig_table() -> np.ndarray:
    """float32(tanh(0.04 i)) printed with 6 decimals, i = 0..200 (util.rs:3-27)."""
    return np.asarray([float("%.6f" % np.float32(np.tanh(0.04 * i))) for i in range(201)], np.float32)


def lpc_taper() -> list:
    """0.9, 0.9^2, ... by sequential f32 products (pitch.rs:470-474)."""
    out, t = [], np.float32(1.0)
    for _ in range(4):
        t = np.float32(t * np.float32(0.9))
        out.append(float(t))
    return out


LAG_WINDOW = [float(np.float32((0.008 * i) * (0.008 * i))) for i in range(5)]


def dft_bases() -> tuple[np.ndarray, np.ndarray]:
    """Dense windowed DFTs, built in float64: F (960, 962) maps a window to
    ``rfft(x * w) * wnorm`` packed [re | im]; IV (962, 960) maps a packed
    spectrum to the hermitian inverse DFT / 2 times the window."""
    window, wnorm = vorbis_window()
    w = window.astype(np.float64)
    n = np.arange(WINDOW)[:, None]
    k = np.arange(FREQ)[None, :]
    theta = 2.0 * np.pi * n * k / WINDOW
    fwd = np.concatenate([w[:, None] * wnorm * np.cos(theta), -w[:, None] * wnorm * np.sin(theta)], axis=1)
    ck = np.full(FREQ, 2.0)
    ck[0] = ck[-1] = 1.0
    sk = np.full(FREQ, -2.0)
    sk[0] = sk[-1] = 0.0
    half = 0.5 * w[None, :]
    inv = np.concatenate([half * ck[:, None] * np.cos(theta.T), half * sk[:, None] * np.sin(theta.T)], axis=0)
    return fwd.astype(np.float32), inv.astype(np.float32)


def biquad_block(n: int) -> tuple[np.ndarray, ...]:
    """The HP biquad over an n-sample block as products, built in float64:
    y = x + x @ W + mem @ P, mem' = x @ H + mem @ Q."""
    a0, a1 = BIQUAD_A
    b0, b1 = BIQUAD_B
    A = np.array([[-a0, 1.0], [-a1, 0.0]])
    c = np.array([b0 - a0, b1 - a1])
    powers = np.empty((n + 1, 2, 2))
    powers[0] = np.eye(2)
    for j in range(1, n + 1):
        powers[j] = A @ powers[j - 1]
    g = powers[:, 0, :] @ c
    W = np.zeros((n, n))
    for t in range(1, n):
        W[:t, t] = g[t - 1 :: -1][:t]
    P = powers[:n, 0, :].T
    H = powers[n - 1 :: -1, :, :] @ c
    Q = powers[n].T
    return tuple(np.ascontiguousarray(m, np.float32) for m in (W, P, H, Q))


def read_rnn(path) -> tuple[dict, dict]:
    """A ``.rnn`` file (int8 values: per layer nb_inputs, nb_neurons,
    activation, then input-major weights and biases) -> ({layer: {name:
    float32 array}}, {layer: (nb_inputs, nb_neurons, activation)})."""
    data = np.fromfile(path, np.int8).astype(np.int64)
    pos = 0

    def take(n):
        nonlocal pos
        if pos + n > data.size:
            raise ValueError(f"{path}: truncated model file")
        pos += n
        return data[pos - n : pos].astype(np.float32)

    params, meta = {}, {}
    for layer in LAYERS:
        n_in, n, act = (int(v) for v in take(3))
        meta[layer] = (n_in, n, act)
        if layer in GRUS:
            params[layer] = {"wi": take(n_in * 3 * n).reshape(n_in, 3 * n),
                             "wr": take(n * 3 * n).reshape(n, 3 * n), "b": take(3 * n)}
        else:
            params[layer] = {"w": take(n_in * n).reshape(n_in, n), "b": take(n)}
    if pos != data.size:
        raise ValueError(f"{path}: trailing bytes after the model")
    return params, meta
