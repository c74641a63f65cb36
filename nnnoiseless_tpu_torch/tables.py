"""Precomputed constant tables (NumPy, computed once at import).

The reference builds these lazily in f64 and casts to f32
(nnnoiseless src/lib.rs:99-148, src/util.rs:3-27).  Output parity with the
reference requires the same tables bit-for-bit, so everything here is
computed in float64 and rounded to float32 exactly as the reference does.

The band aggregation / interpolation loops of the reference are
re-expressed as dense (22,481) and (481,22) matrices.  A copy of
``nnnoiseless_tpu/tables.py`` (importing that package would load JAX);
tests/test_torch_tables.py holds the two bit-identical.
"""

from __future__ import annotations

import numpy as np

from .constants import (
    CEPS_MEM,
    EBAND_5MS,
    FRAME_SIZE,
    FRAME_SIZE_SHIFT,
    FREQ_SIZE,
    NB_BANDS,
    WINDOW_SIZE,
)


def _build_window() -> tuple[np.ndarray, np.float32]:
    """Vorbis power-complementary window + its inverse squared-norm.

    w[i] = sin(pi/2 * sin^2(pi/2 * (i+0.5)/FRAME_SIZE)), mirrored
    (reference lib.rs:110-116).
    """
    i = np.arange(FRAME_SIZE, dtype=np.float64)
    s = np.sin(0.5 * np.pi * (i + 0.5) / FRAME_SIZE)
    half = np.sin(0.5 * np.pi * s * s).astype(np.float32)
    window = np.concatenate([half, half[::-1]])
    # The reference sums the f32 squares sequentially in f32; replicate that
    # accumulation order to get the identical wnorm constant.
    acc = np.float32(0.0)
    for w in window:
        acc = np.float32(acc + np.float32(w * w))
    wnorm = np.float32(1.0) / acc
    return window, wnorm


def _build_dct_table() -> np.ndarray:
    """22x22 DCT-II basis, laid out [i, j] like the reference's i*NB+j.

    dct_table[i, j] = cos((i+0.5) * j * pi / 22), with the j==0 column scaled
    by sqrt(1/2) (reference lib.rs:118-127).  The forward DCT used by the
    pipeline is out[i] = (sum_j x[j] * table[j, i]) * sqrt(2/22).
    """
    i = np.arange(NB_BANDS, dtype=np.float64)[:, None]
    j = np.arange(NB_BANDS, dtype=np.float64)[None, :]
    table = np.cos((i + 0.5) * j * np.pi / NB_BANDS).astype(np.float32)
    table[:, 0] *= np.float32(np.sqrt(0.5))
    return table


def _build_band_matrices() -> tuple[np.ndarray, np.ndarray]:
    """Dense matrices replacing the reference's triangular band loops.

    ``corr`` is (NB_BANDS, FREQ_SIZE): band_energies = corr @ power_spectrum,
    including the x2 on the first and last band (reference lib.rs:65-82).

    ``interp`` is (FREQ_SIZE, NB_BANDS): per-bin gains = interp @ band_gains.
    Bins >= 400 get zero rows, matching the reference's zero-fill
    (lib.rs:84-97 zeroes `out` then only writes bins below EBAND[21]<<2).
    """
    corr = np.zeros((NB_BANDS, FREQ_SIZE), dtype=np.float64)
    interp = np.zeros((FREQ_SIZE, NB_BANDS), dtype=np.float64)
    for b in range(NB_BANDS - 1):
        band_size = (EBAND_5MS[b + 1] - EBAND_5MS[b]) << FRAME_SIZE_SHIFT
        for j in range(band_size):
            frac = j / band_size
            idx = (EBAND_5MS[b] << FRAME_SIZE_SHIFT) + j
            corr[b, idx] += 1.0 - frac
            corr[b + 1, idx] += frac
            interp[idx, b] = 1.0 - frac
            interp[idx, b + 1] = frac
    corr[0] *= 2.0
    corr[NB_BANDS - 1] *= 2.0
    return corr.astype(np.float32), interp.astype(np.float32)


def _build_tansig_table() -> np.ndarray:
    """201-entry tanh lookup on a 0.04 grid, rounded to 6 decimals.

    The reference hardcodes the table (util.rs:3-27); its entries are
    float32(tanh(0.04*i)) printed with C's "%f" (6 decimals, round half away
    from zero).  Regenerating with the same rule reproduces every constant
    exactly, verified in tests/test_tables.py.
    """
    vals = [float("%.6f" % np.float32(np.tanh(0.04 * i))) for i in range(201)]
    return np.asarray(vals, dtype=np.float32)


VORBIS_WINDOW, WNORM = _build_window()
DCT_TABLE = _build_dct_table()
# f32(f64(sum) * sqrt(2/22)): the reference scales the f32 dot product by the
# f64 constant; a single f32 multiply by the rounded constant matches to 1 ulp.
DCT_SCALE = np.float32(np.sqrt(2.0 / NB_BANDS))
BAND_CORR_MATRIX, BAND_INTERP_MATRIX = _build_band_matrices()
TANSIG_TABLE = _build_tansig_table()

# High-pass biquad applied to all input audio (reference util.rs:67-71).
BIQUAD_HP_A = np.array([-1.99599, 0.99600], dtype=np.float32)
BIQUAD_HP_B = np.array([-2.0, 1.0], dtype=np.float32)

# remove_doubling's secondary-period check table (reference pitch.rs:489).
SECOND_CHECK = (0, 0, 3, 2, 3, 2, 5, 2, 3, 2, 3, 2, 5, 2, 3, 2)

__all__ = [
    "VORBIS_WINDOW",
    "WNORM",
    "DCT_TABLE",
    "DCT_SCALE",
    "BAND_CORR_MATRIX",
    "BAND_INTERP_MATRIX",
    "TANSIG_TABLE",
    "BIQUAD_HP_A",
    "BIQUAD_HP_B",
    "SECOND_CHECK",
    "CEPS_MEM",
]
