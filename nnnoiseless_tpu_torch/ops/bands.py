"""Band aggregation / interpolation / DCT as dense products.

The reference's triangular band loops (src/lib.rs:65-97) and 22-point DCT
(lib.rs:139-148) as products against the (22,481)/(481,22)/(22,22) tables.
Spectra are packed ``[re(481) | im(481)]`` on the last axis (962 lanes);
every function broadcasts over leading axes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..tables import BAND_CORR_MATRIX, BAND_INTERP_MATRIX, DCT_SCALE, DCT_TABLE


@functools.lru_cache(maxsize=8)
def _consts(device: torch.device):
    corr2 = np.concatenate([BAND_CORR_MATRIX.T, BAND_CORR_MATRIX.T], axis=0)
    interp2 = np.concatenate([BAND_INTERP_MATRIX.T, BAND_INTERP_MATRIX.T], axis=1)
    t = lambda m: torch.as_tensor(np.ascontiguousarray(m, np.float32), device=device)
    return t(corr2), t(interp2), t(DCT_TABLE)


def band_corr(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Per-band correlation of two packed (..., 962) spectra -> (..., 22),
    including the x2 weighting of the first and last band (lib.rs:65-82)."""
    return torch.matmul(x * p, _consts(x.device)[0])


def band_energies(x: torch.Tensor) -> torch.Tensor:
    """Band energies of a packed (..., 962) spectrum: band_corr(x, x)."""
    return band_corr(x, x)


def interp_band_gain(band_vals: torch.Tensor) -> torch.Tensor:
    """22 band values -> packed (..., 962) per-bin gains (the same gain on
    the re and im halves); bins >= 400 are zero (lib.rs:84-97)."""
    return torch.matmul(band_vals, _consts(band_vals.device)[1])


def dct22(x: torch.Tensor) -> torch.Tensor:
    """Forward 22-point DCT-II: out[i] = (sum_j x[j] * T[j,i]) * sqrt(2/22)."""
    return torch.matmul(x, _consts(x.device)[2]) * float(DCT_SCALE)
