"""Windowed real DFT analysis / synthesis as dense bases.

The reference runs an unnormalized 960-point real FFT, scales the forward
transform by ``wnorm = 1/sum(w^2)`` and divides the inverse by 2
(src/features.rs:281-298, 263-275).  Here the window, ``wnorm``, the
hermitian unfold and the /2 are folded into three dense f32 bases built in
f64, the same construction as ``nnnoiseless_tpu/ops/fft.py``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import FREQ_SIZE, WINDOW_SIZE
from ..tables import VORBIS_WINDOW, WNORM


@functools.lru_cache(maxsize=1)
def dense_dft_bases():
    """Single-product DFT bases with the window/normalization chain folded in.

    Returns numpy f32 arrays (computed in f64):
      F   (960, 962): spec = w960 @ F  ==  window -> rfft -> *wnorm,
                      packed columns [re(481) | im(481)];
      IV1 (962, 480), IV2 (962, 480): y = x @ [IV1 | IV2]  ==  unnormalized
                      hermitian inverse DFT / 2 * window, split at sample 480
                      (the overlap-add head and tail).
    """
    n = np.arange(WINDOW_SIZE)[:, None]
    k = np.arange(FREQ_SIZE)[None, :]
    theta = 2.0 * np.pi * n * k / WINDOW_SIZE
    win = np.asarray(VORBIS_WINDOW, np.float64)[:, None]
    fwd = np.concatenate(
        [win * WNORM * np.cos(theta), -win * WNORM * np.sin(theta)], axis=1
    )  # (960, 962)

    # inverse: y[n] = 0.5*win[n] * (re0 + re480*(-1)^n
    #                 + sum_{k=1..479} 2*(re_k cos - im_k sin))
    ck = np.full(FREQ_SIZE, 2.0)
    ck[0] = ck[-1] = 1.0
    sk = np.full(FREQ_SIZE, -2.0)
    sk[0] = sk[-1] = 0.0
    theta_kn = (
        2.0
        * np.pi
        * np.arange(FREQ_SIZE)[:, None]
        * np.arange(WINDOW_SIZE)[None, :]
        / WINDOW_SIZE
    )
    winr = 0.5 * np.asarray(VORBIS_WINDOW, np.float64)[None, :]
    inv = np.concatenate(
        [winr * ck[:, None] * np.cos(theta_kn), winr * sk[:, None] * np.sin(theta_kn)],
        axis=0,
    )  # (962, 960)
    f32 = lambda m: np.ascontiguousarray(m, np.float32)
    return (
        f32(fwd),
        f32(inv[:, : WINDOW_SIZE // 2]),
        f32(inv[:, WINDOW_SIZE // 2 :]),
    )


@functools.lru_cache(maxsize=8)
def dft_bases(device: torch.device):
    """(F (960,962), IV (962,960) = [IV1 | IV2]) as tensors on ``device``."""
    fwd, iv1, iv2 = dense_dft_bases()
    return (
        torch.as_tensor(fwd, device=device),
        torch.as_tensor(np.concatenate([iv1, iv2], axis=1), device=device),
    )


def forward_transform(frame: torch.Tensor) -> torch.Tensor:
    """Window a (..., 960) frame -> packed (..., 962) spectrum [re | im],
    ``rfft(frame * window) * wnorm`` as one f32 product with F."""
    return torch.matmul(frame, dft_bases(frame.device)[0])


def inverse_transform(spectrum: torch.Tensor) -> torch.Tensor:
    """Packed (..., 962) spectrum -> windowed (..., 960) frame: the
    hermitian inverse DFT / 2 times the window, one f32 product with IV."""
    return torch.matmul(spectrum, dft_bases(spectrum.device)[1])
