"""Training losses (train/rnn_train.py:33-46), the counterpart of
``nnnoiseless_tpu/training/losses.py``.

* gains: ``mycost`` — masked quartic+quadratic error in the sqrt-gain domain
  plus a small BCE term.  The mask ``min(y_true+1, 1)`` zeroes bands whose
  target is the -1 "no data" sentinel; sqrt() inputs are clamped at 0 so the
  sentinel does not poison the masked lanes with NaNs.
* vad: ``my_crossentropy`` — BCE weighted by 2*|y_true-0.5| (confidence).
* combined: loss_weights [10, 0.5] (rnn_train.py:81).
"""

from __future__ import annotations

import torch

_EPS = 1e-7
GRU_L2 = 1e-6  # Keras l2(1e-6) on the three GRUs (rnn_train.py:68-73)


def _bce(y_true, y_pred):
    p = torch.clamp(y_pred, _EPS, 1.0 - _EPS)
    t = torch.clamp(y_true, 0.0, 1.0)
    return -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))


def _mask(y_true):
    return torch.clamp(y_true + 1.0, max=1.0)


def _sqrt_diff(y_true, y_pred):
    return torch.sqrt(torch.clamp(y_pred, min=0.0)) - torch.sqrt(torch.clamp(y_true, min=0.0))


def gain_loss(y_true, y_pred):
    """mycost: mean over bands of mask * (10 d^4 + d^2 + 0.01 bce),
    d = sqrt(pred) - sqrt(true)."""
    d2 = _sqrt_diff(y_true, y_pred) ** 2
    per_band = _mask(y_true) * (10.0 * (d2 * d2) + d2 + 0.01 * _bce(y_true, y_pred))
    return per_band.mean(-1)


def vad_loss(y_true, y_pred):
    """my_crossentropy: mean of 2|y_true - 0.5| * bce."""
    return (2.0 * torch.abs(y_true - 0.5) * _bce(y_true, y_pred)).mean(-1)


def msse(y_true, y_pred):
    """Metric: masked squared error in the sqrt domain (rnn_train.py:38-39)."""
    return (_mask(y_true) * _sqrt_diff(y_true, y_pred) ** 2).mean(-1)


def l2_regularization(model) -> torch.Tensor:
    """Keras kernel/recurrent l2(1e-6) regularizers on the three GRUs
    (reference train/rnn_train.py:68-73; the dense layers carry none)."""
    reg = sum((getattr(model, name)[k] ** 2).sum()
              for name in ("vad_gru", "noise_gru", "denoise_gru") for k in ("wi", "wr"))
    return GRU_L2 * reg


def total_loss(gains_true, gains_pred, vad_true, vad_pred, sample_weight=None, weight_total=None):
    """10 * mycost + 0.5 * my_crossentropy, averaged over batch and time
    (weighted by ``sample_weight`` (B, T) when given).

    ``weight_total``: where this batch is one rank's part of a global
    batch, the sum of the global batch's weights, so that the ranks' losses
    add up to the global weighted mean (``sample_weight.sum()`` otherwise).
    """
    per_step = 10.0 * gain_loss(gains_true, gains_pred) + 0.5 * vad_loss(vad_true, vad_pred)
    if sample_weight is not None:
        total = sample_weight.sum() if weight_total is None else weight_total
        return (per_step * sample_weight).sum() / torch.clamp(total, min=1e-6)
    return per_step.mean()
