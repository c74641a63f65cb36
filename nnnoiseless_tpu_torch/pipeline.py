"""The per-frame denoise step over a batch of streams, and its carry.

The reference's mutable per-stream state (src/denoise.rs:95-116,
src/features.rs) is one :class:`DenoiseCarry` of tensors whose leading
axis is the stream; the field and function names are those of
``nnnoiseless_tpu/pipeline.py`` so a carry means the same in both packages.
Where the JAX package writes one stream and maps it over the batch, every
function here takes the (B, ...) batch directly; spectra are packed
``[re(481) | im(481)]`` on the last axis (962 lanes).

* :func:`frame_step` is the reference's frame: the HP biquad, the input
  shift, the pitch analysis (kernel K3 on CUDA tensors), the spectra at
  lag 0 and at the pitch lag (kernel K6), the 42 features, the RNN
  (kernel K5) and the synthesis.
* :func:`frame_step_hoisted` is the scan engine's body: the frame-local
  products arrive in a :class:`FramePre` from ``chunk.precompute_chunk``
  and only the carry-coupled remainder runs here.

Silence-gate semantics (features.rs:160-166, denoise.rs:101-112): when the
total band energy is below 0.04 the cepstral register, the GRU states and
the gain memory keep their values and the unfiltered spectrum is
synthesized.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .constants import CEPS_MEM, FRAME_SIZE, NB_BANDS, NB_DELTA_CEPS, PITCH_BUF_SIZE, WINDOW_SIZE
from .model import ModelMeta
from .ops.bands import band_corr, band_energies, dct22, interp_band_gain
from .ops.biquad import biquad_filter_dense
from .ops.fft import forward_transform, inverse_transform
from .ops.pitch import pitch_process, remove_doubling_from_candidates
from .ops.rnn import Rnn, RnnState, rnn_step
from .ops.window import window_at_lag
from .tables import BIQUAD_HP_A, BIQUAD_HP_B

_OFF = PITCH_BUF_SIZE - WINDOW_SIZE  # 768: start of the lag-0 window


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


class Analysis(NamedTuple):
    """Per-frame analysis products consumed by the denoising tail."""

    features: torch.Tensor  # (B, 42) the RNN input, zero when silent
    x: torch.Tensor  # (B, 962) packed spectrum of the frame
    p: torch.Tensor  # (B, 962) packed spectrum at the pitch lag
    ex: torch.Tensor  # (B, 22) band energies of x
    ep: torch.Tensor  # (B, 22) band energies of p
    exp: torch.Tensor  # (B, 22) normalized band correlation of x and p
    silence: torch.Tensor  # (B,) bool
    period: torch.Tensor  # (B,) int32 pitch period


class FramePre(NamedTuple):
    """Frame-local products of the chunk precompute (chunk.py), TIME-MAJOR
    (T, B, ...); one frame's slice, (B, ...), is what
    :func:`frame_step_hoisted` takes.

    The lag-0 fields are None when the precompute runs with ``lag0=False``
    (the two-phase engine: kernel K2 computes them from the history).
    """

    filtered: torch.Tensor  # (T, B, 480) HP-filtered frames
    cand: torch.Tensor  # (T, B, 105) octave-removal candidate lanes
    x: Optional[torch.Tensor] = None  # (T, B, 962) packed lag-0 spectrum
    ex: Optional[torch.Tensor] = None  # (T, B, 22) band energies of x
    silence: Optional[torch.Tensor] = None  # (T, B) bool, energy < 0.04
    ceps: Optional[torch.Tensor] = None  # (T, B, 22) cepstrum, offsets applied


def init_feature_state(batch: int, device) -> FeatureState:
    """A zeroed analysis state for ``batch`` streams on ``device``."""
    z = lambda *shape: torch.zeros((batch,) + shape, dtype=torch.float32, device=device)
    return FeatureState(
        input_mem=z(PITCH_BUF_SIZE),
        hp_mem=z(2),
        cepstral_mem=z(CEPS_MEM, NB_BANDS),
        pitch_period=torch.zeros((batch,), dtype=torch.int32, device=device),
        pitch_gain=z(),
    )


def init_carry(meta: ModelMeta, batch: int, device) -> DenoiseCarry:
    """A zeroed carry for ``batch`` streams on ``device``."""
    z = lambda *shape: torch.zeros((batch,) + shape, dtype=torch.float32, device=device)
    return DenoiseCarry(
        feat=init_feature_state(batch, device),
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


def cepstrum(ly: torch.Tensor) -> torch.Tensor:
    """The DCT cepstrum of a log spectrum with the reference's offsets on
    its first two lanes (features.rs:167-169)."""
    ceps = dct22(ly)
    ceps[..., 0] += -12.0
    ceps[..., 1] += -4.0
    return ceps


def _spectral_variability(cepstral_mem: torch.Tensor) -> torch.Tensor:
    """(B, 8, 22) -> (B,): the sum over rows of the least squared distance
    to another row (features.rs:196-216)."""
    diff = cepstral_mem[:, :, None, :] - cepstral_mem[:, None, :, :]
    eye = torch.eye(CEPS_MEM, device=cepstral_mem.device) * 1e15  # excludes j == i
    dist = (diff * diff).sum(-1) + eye
    return dist.min(dim=2).values.sum(-1) / float(CEPS_MEM) - 2.1


def analyze_frame(state: FeatureState, frame: torch.Tensor) -> tuple[FeatureState, Analysis]:
    """HP filter, input shift and the 42 features of (B, 480) frames
    (features.rs:97-219)."""
    filtered, hp_mem = biquad_filter_dense(frame, state.hp_mem, BIQUAD_HP_A, BIQUAD_HP_B)
    return analyze_frame_prefiltered(state, filtered, hp_mem)


def analyze_frame_prefiltered(
    state: FeatureState, filtered: torch.Tensor, hp_mem: torch.Tensor
) -> tuple[FeatureState, Analysis]:
    """Analysis of already HP-filtered (B, 480) frames; ``hp_mem`` is
    stored as is."""
    input_mem = torch.cat([state.input_mem[:, FRAME_SIZE:], filtered], dim=1)
    # pitch state updates are unconditional (pitch.rs:45-54)
    period, pgain = pitch_process(input_mem, state.pitch_period, state.pitch_gain)
    # the spectra at lag 0 and at the pitch lag in one product
    spec2 = forward_transform(torch.stack([input_mem[:, _OFF:], window_at_lag(input_mem, period)]))
    e2 = band_energies(spec2)
    ly, energy = log_spectrum(e2[0])
    return _finish_analysis(
        state, input_mem, hp_mem, spec2[0], spec2[1], e2[0], e2[1], energy < 0.04,
        cepstrum(ly), period, pgain,
    )


def frame_features(cepstral_mem, x, p, ex, ep, silence, ceps, period):
    """The analysis tail shared by every path: pitch-correlation features,
    the cepstral shift register with its deltas and variability, the
    feature vector, and silence masking (features.rs:139-216).  Returns
    (features (B, 42), exp (B, 22), cepstral_mem')."""
    exp = band_corr(x, p) / torch.sqrt(0.001 + ex * ep)
    dly = NB_DELTA_CEPS
    f_pitch = dct22(exp)[:, :dly]
    f_pitch[:, 0] += -1.3
    f_pitch[:, 1] += -0.9
    f_period = 0.01 * (period.to(torch.float32) - 300.0)
    new_cm = torch.cat([ceps[:, None], cepstral_mem[:, :-1]], dim=1)
    c0, c1, c2 = ceps[:, :dly], new_cm[:, 1, :dly], new_cm[:, 2, :dly]
    features = torch.cat(
        [c0 + c1 + c2, ceps[:, dly:], c0 - c2, c0 - 2.0 * c1 + c2, f_pitch,
         f_period[:, None], _spectral_variability(new_cm)[:, None]],
        dim=1,
    )
    features = torch.where(silence[:, None], 0.0, features)
    return features, exp, torch.where(silence[:, None, None], cepstral_mem, new_cm)


def _finish_analysis(state, input_mem, hp_mem, x, p, ex, ep, silence, ceps, period, pgain):
    """:func:`frame_features` with the new feature state and the
    :class:`Analysis` of the frame."""
    features, exp, cepstral_mem = frame_features(state.cepstral_mem, x, p, ex, ep, silence, ceps, period)
    new_state = FeatureState(
        input_mem=input_mem,
        hp_mem=hp_mem,
        cepstral_mem=cepstral_mem,
        pitch_period=period,
        pitch_gain=pgain,
    )
    return new_state, Analysis(features, x, p, ex, ep, exp, silence, period)


def _pitch_filter(x, p, ex, ep, exp, gains):
    """Pitch comb filter and renormalization (features.rs:223-257)."""
    g_sq, exp_sq = gains * gains, exp * exp
    r = torch.where(exp > gains, 1.0, exp_sq * (1.0 - g_sq) / (0.001 + g_sq * (1.0 - exp_sq)))
    r = torch.sqrt(torch.clamp(r, 0.0, 1.0)) * torch.sqrt(ex / (1e-8 + ep))
    x1 = x + p * interp_band_gain(r)
    norm = torch.sqrt(ex / (1e-8 + band_energies(x1)))
    return x1 * interp_band_gain(norm)


def frame_step(rnn: Rnn, carry: DenoiseCarry, frame: torch.Tensor, weights: tuple | None = None):
    """One 480-sample frame of each of B streams: (carry', out (B, 480),
    vad (B,)).  Samples are f32 in the i16 range.  ``weights``: the
    model's ``ops/rnn_kernel.py::pack_tiled`` for kernel K5 (packed per
    call when None)."""
    feat_state, an = analyze_frame(carry.feat, frame)
    return _denoise_tail(rnn, carry, feat_state, an, weights)


def analyze_frame_hoisted(state: FeatureState, pre: FramePre) -> tuple[FeatureState, Analysis]:
    """The carry-dependent remainder of the analysis, given one frame's
    precompute (a :class:`FramePre` of (B, ...) slices with the lag-0
    fields): octave removal with the previous period and gain, the spectrum
    at the pitch lag, the cepstral register.  ``hp_mem`` passes through
    (the chunk filter owns it)."""
    input_mem = torch.cat([state.input_mem[:, FRAME_SIZE:], pre.filtered], dim=1)
    period, pgain = remove_doubling_from_candidates(pre.cand, state.pitch_period, state.pitch_gain)
    p = forward_transform(window_at_lag(input_mem, period))
    return _finish_analysis(
        state, input_mem, state.hp_mem, pre.x, p, pre.ex, band_energies(p), pre.silence,
        pre.ceps, period, pgain,
    )


def frame_step_hoisted(rnn: Rnn, carry: DenoiseCarry, pre: FramePre, weights: tuple | None = None):
    """The scan engine's body for one frame: :func:`analyze_frame_hoisted`
    and the denoising tail."""
    feat_state, an = analyze_frame_hoisted(carry.feat, pre)
    return _denoise_tail(rnn, carry, feat_state, an, weights)


def _denoise_tail(rnn, carry, feat_state, an, weights):
    """The RNN (states kept on silence), the comb filter, the gain
    hangover and the synthesis with overlap-add (features.rs:223-275)."""
    sil = an.silence[:, None]
    rnn_new, gains, vad = rnn_step(rnn, carry.rnn, an.features, weights)
    rnn_next = RnnState(*(torch.where(sil, old, new) for new, old in zip(rnn_new, carry.rnn)))
    x_combed = _pitch_filter(an.x, an.p, an.ex, an.ep, an.exp, gains)
    g2 = torch.maximum(gains, 0.6 * carry.lastg)
    x_final = torch.where(sil, an.x, x_combed * interp_band_gain(g2))
    y = inverse_transform(x_final)  # (B, 960)
    new_carry = DenoiseCarry(
        feat=feat_state,
        synthesis_mem=y[:, FRAME_SIZE:],
        rnn=rnn_next,
        lastg=torch.where(sil, carry.lastg, g2),
    )
    return new_carry, y[:, :FRAME_SIZE] + carry.synthesis_mem, torch.where(an.silence, 0.0, vad)
