"""Carry containers and the frame-local analysis helpers of the engine.

The reference's mutable per-stream state (src/denoise.rs:95-116,
src/features.rs) is one :class:`DenoiseCarry` of tensors whose leading
axis is the stream; the field names are those of
``nnnoiseless_tpu/pipeline.py`` so a carry means the same in both packages.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .constants import CEPS_MEM, FRAME_SIZE, NB_BANDS, PITCH_BUF_SIZE
from .model import ModelMeta
from .ops.rnn import RnnState


class FeatureState(NamedTuple):
    """Recurrent state of the analysis half, batch axis leading.

    The cepstral history is a shift register with the newest frame at row 0.
    """

    input_mem: torch.Tensor  # (B, 1728) rolling HP-filtered input history
    hp_mem: torch.Tensor  # (B, 2) biquad high-pass state
    cepstral_mem: torch.Tensor  # (B, 8, 22) cepstrum shift register
    pitch_period: torch.Tensor  # (B,) int32
    pitch_gain: torch.Tensor  # (B,) f32


class DenoiseCarry(NamedTuple):
    """All recurrent state of a batch of streams (~9.6 KB per stream)."""

    feat: FeatureState
    synthesis_mem: torch.Tensor  # (B, 480) overlap-add tail
    rnn: RnnState  # GRU hidden states
    lastg: torch.Tensor  # (B, 22) previous gains (hangover)


class FramePre(NamedTuple):
    """Frame-local products of the chunk precompute (chunk.py), TIME-MAJOR.

    Only the fields the frame kernel consumes exist here: it computes the
    lag-0 analysis itself from the input history.
    """

    filtered: torch.Tensor  # (T, B, 480) HP-filtered frames
    cand: torch.Tensor  # (T, B, 105) octave-removal candidate lanes


def init_carry(meta: ModelMeta, batch: int, device) -> DenoiseCarry:
    """A zeroed carry for ``batch`` streams on ``device``."""
    z = lambda *shape: torch.zeros((batch,) + shape, dtype=torch.float32, device=device)
    return DenoiseCarry(
        feat=FeatureState(
            input_mem=z(PITCH_BUF_SIZE),
            hp_mem=z(2),
            cepstral_mem=z(CEPS_MEM, NB_BANDS),
            pitch_period=torch.zeros((batch,), dtype=torch.int32, device=device),
            pitch_gain=z(),
        ),
        synthesis_mem=z(FRAME_SIZE),
        rnn=RnnState(
            z(meta.vad_gru.nb_neurons),
            z(meta.noise_gru.nb_neurons),
            z(meta.denoise_gru.nb_neurons),
        ),
        lastg=z(NB_BANDS),
    )


def log_spectrum(ex: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Floored/followed log band energies (features.rs:147-158).

    ``ex`` (..., 22) -> (ly (..., 22), total energy (...)); the floor chain
    is sequential over the 22 bands.
    """
    raw = torch.log10(0.01 + ex)
    log_max = torch.full_like(raw[..., 0], -2.0)
    follow = torch.full_like(raw[..., 0], -2.0)
    ly = []
    for i in range(NB_BANDS):
        v = torch.maximum(torch.maximum(raw[..., i], log_max - 7.0), follow - 1.5)
        log_max = torch.maximum(log_max, v)
        follow = torch.maximum(follow - 1.5, v)
        ly.append(v)
    return torch.stack(ly, dim=-1), ex.sum(-1)
