"""The one generator of the benchmark's inputs: audio streams and training
rows, made on a device from a seed and the parameters of a traffic file.

Audio is float32 PCM in the i16 range at 48 kHz.  Even streams are slices
of ``perf_bench/data/testing.raw`` (the golden clip of nnnoiseless, 1 s of
speech in noise) at seeded offsets and gains, wrapped around, plus seeded
noise; odd streams are harmonic tones (five partials, f0 in 80-400 Hz) in
noise.  A seeded share of streams carries one muted stretch of exact zeros.
Every draw comes from one ``torch.Generator`` on the device, so the same
seed gives the same inputs.
"""

from __future__ import annotations

import math
import pathlib

import numpy as np
import torch

DATA = pathlib.Path(__file__).resolve().parent / "data"
RATE = 48000


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def load_clip(device) -> torch.Tensor:
    return torch.as_tensor(np.fromfile(DATA / "testing.raw", "<i2").astype(np.float32), device=device)


class AudioMaker:
    """Per-stream parameters of ``n_streams`` streams of ``n_samples``,
    drawn once; :meth:`block` makes the samples of a range of streams."""

    def __init__(self, n_streams: int, n_samples: int, seed: int, device, traffic: dict):
        dev = torch.device(device)
        g = _generator(seed, dev)
        u = lambda lo, hi, *shape: lo + (hi - lo) * torch.rand((n_streams,) + shape, generator=g, device=dev)
        self.n, self.device, self.clip = n_samples, dev, load_clip(dev)
        self.offset = (u(0.0, 1.0) * self.clip.numel()).long()
        self.gain = u(0.25, 2.0)
        self.f0 = u(80.0, 400.0).double()
        self.phase = u(0.0, 6.0, 5).double()
        self.amp = u(100.0, 6000.0)
        self.noise = torch.where(torch.arange(n_streams, device=dev) % 2 == 0, u(5.0, 300.0), u(10.0, 800.0))
        lo, hi = traffic["mute_seconds"]
        self.muted = u(0.0, 1.0) < traffic["mute_share"]
        self.mute_len = (u(lo, hi) * RATE).long().clamp(max=n_samples)
        self.mute_at = (u(0.0, 1.0) * (n_samples - self.mute_len + 1)).long()
        self.g = g

    def block(self, s0: int, s1: int) -> torch.Tensor:
        """(s1 - s0, n_samples) float32 samples of streams s0..s1-1."""
        dev, n = self.device, self.n
        pos = torch.arange(n, device=dev)
        ids = torch.arange(s0, s1, device=dev)
        speech = self.clip[(self.offset[s0:s1, None] + pos) % self.clip.numel()] * self.gain[s0:s1, None]
        t = pos.double() / RATE
        tone = torch.zeros((s1 - s0, n), dtype=torch.float64, device=dev)
        for h in range(1, 6):
            tone += torch.sin(2.0 * math.pi * h * self.f0[s0:s1, None] * t + self.phase[s0:s1, h - 1, None]) / h
        tone = tone.float() * self.amp[s0:s1, None]
        noise = torch.randn((s1 - s0, n), generator=self.g, device=dev) * self.noise[s0:s1, None]
        out = torch.where((ids % 2 == 0)[:, None], speech, tone) + noise
        out = out.clamp(-32768.0, 32767.0)
        mute = self.muted[s0:s1, None] & (pos >= self.mute_at[s0:s1, None]) \
            & (pos < (self.mute_at + self.mute_len)[s0:s1, None])
        return torch.where(mute, 0.0, out)


def make_audio(n_streams: int, n_samples: int, seed: int, device, traffic: dict, block: int = 128) -> torch.Tensor:
    """(n_streams, n_samples) float32 audio on ``device``."""
    maker = AudioMaker(n_streams, n_samples, seed, device, traffic)
    out = torch.empty((n_streams, n_samples), device=device)
    for s0 in range(0, n_streams, block):
        s1 = min(s0 + block, n_streams)
        out[s0:s1] = maker.block(s0, s1)
    return out


def make_train_rows(n_seq: int, frames: int, seed: int, device, unknown_share: float, vad_switch: float) -> dict:
    """{features (N, T, 42), gains (N, T, 22), vad (N, T, 1)} float32 on
    ``device``: standard Gaussian features; gains u^e in [0, 1] with a
    per-sequence exponent e = exp(N(0, 1)), so sequences' mean gains spread
    over the three tertiles that set the sample weights, and a share at -1
    (an unknown band, as the generator marks it); VAD 0 or 1 in runs whose
    ends come with probability ``vad_switch`` a frame."""
    dev = torch.device(device)
    g = _generator(seed, dev)
    feats = torch.randn((n_seq, frames, 42), generator=g, device=dev)
    expo = torch.exp(torch.randn((n_seq, 1, 1), generator=g, device=dev))
    gains = torch.rand((n_seq, frames, 22), generator=g, device=dev) ** expo
    unknown = torch.rand((n_seq, frames, 22), generator=g, device=dev) < unknown_share
    gains = torch.where(unknown, -1.0, gains)
    flips = (torch.rand((n_seq, frames), generator=g, device=dev) < vad_switch).long()
    start = torch.randint(0, 2, (n_seq, 1), generator=g, device=dev)
    vad = ((flips.cumsum(1) + start) % 2).float()[..., None]
    return {"features": feats, "gains": gains, "vad": vad}


def sample_weights(gains: torch.Tensor) -> torch.Tensor:
    """Tertile reweighting by each sequence's mean known gain
    (xiph/rnnoise training/rnn_train.py:108-118), on the device: (N,)."""
    y = gains.reshape(gains.shape[0], -1)
    known = y != -1.0
    count = known.sum(1)
    means = torch.where(known, y, 0.0).sum(1) / count.clamp(min=1)
    valid = count > 0
    hi, lo = valid & (means > 2 / 3), valid & (means < 1 / 3)
    med = valid & ~hi & ~lo
    total = valid.sum()
    w = torch.zeros_like(means)
    for m in (hi, med, lo):
        w = w + m * (total / m.sum().clamp(min=1))
    return (w / 3.0).float()


def init_params(shapes: dict, seed: int, device) -> dict:
    """Glorot-uniform kernels (limit sqrt(6 / (fan_in + fan_out))) and zero
    biases, from one draw on the device."""
    g = _generator(seed, device)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.rand(total, generator=g, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, shape in shapes.items():
        size = math.prod(shape)
        if len(shape) == 1:
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = flat[at : at + size].reshape(shape) * math.sqrt(6.0 / (shape[0] + shape[1]))
        at += size
    return out
