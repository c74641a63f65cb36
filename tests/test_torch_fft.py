"""Kernel K2's FFT on the CPU: ops/fft.py's plain mirror of the kernel's
stages (``rfft960_staged`` / ``irfft960_staged``, the same 15 x 32
decomposition and the same f32 twiddle table the kernel takes) against the
JAX package's ``forward_transform`` / ``inverse_transform`` and numpy's f64
FFT, on seeded windows: i16-scale noise, silence, an impulse, and tones on
a bin.

Bar: max abs difference <= 1e-5 x the row's max |value| (both sides are
f32; the dense product's own rounding is ~sqrt(960) eps of the scale, the
FFT's ~log2(960) eps), so silence must come out exactly 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnnoiseless_tpu.ops.fft import forward_transform as jax_forward
from nnnoiseless_tpu.ops.fft import inverse_transform as jax_inverse

from nnnoiseless_tpu_torch.ops import fft
from nnnoiseless_tpu_torch.tables import VORBIS_WINDOW, WNORM

ROWS = 4
BAR = 1e-5


def _windows(kind: str) -> np.ndarray:
    """(ROWS, 960) f32 raw windows in the i16 range."""
    rng = np.random.RandomState(["noise", "silence", "impulse", "tone"].index(kind))
    n = np.arange(960)
    if kind == "noise":
        return np.clip(rng.randn(ROWS, 960) * 6000, -32768, 32767).astype(np.float32)
    if kind == "silence":
        return np.zeros((ROWS, 960), np.float32)
    if kind == "impulse":
        x = np.zeros((ROWS, 960), np.float32)
        x[np.arange(ROWS), rng.randint(1, 959, ROWS)] = 32767.0
        return x
    bins = rng.randint(1, 480, ROWS)
    phase = rng.rand(ROWS, 1) * 2 * np.pi
    return (20000 * np.cos(2 * np.pi * bins[:, None] * n / 960 + phase)).astype(np.float32)


def _rfft64(x: np.ndarray) -> np.ndarray:
    """Packed (R, 962) rfft(x * window) * wnorm in f64."""
    spec = np.fft.rfft(x.astype(np.float64) * np.asarray(VORBIS_WINDOW, np.float64)) * float(WNORM)
    return np.concatenate([spec.real, spec.imag], axis=1)


def _irfft64(packed: np.ndarray) -> np.ndarray:
    """(R, 960) hermitian inverse DFT / 2 x window in f64 (the imaginary
    parts of bins 0 and 480 read as 0)."""
    spec = packed[:, :481].astype(np.float64) + 1j * packed[:, 481:]
    spec[:, 0] = spec[:, 0].real
    spec[:, 480] = spec[:, 480].real
    return np.fft.irfft(spec, 960) * 960 * 0.5 * np.asarray(VORBIS_WINDOW, np.float64)


def _assert_rows_close(got, want, what):
    scale = np.abs(want).max(axis=1, keepdims=True)
    err = np.abs(np.asarray(got, np.float64) - want)
    assert (err <= BAR * scale).all(), f"{what}: worst {float((err / np.maximum(scale, 1e-30)).max()):.3g}"


KINDS = ["noise", "silence", "impulse", "tone"]


@pytest.mark.parametrize("kind", KINDS)
def test_staged_forward_matches_jax(kind):
    x = _windows(kind)
    staged = fft.rfft960_staged(torch.from_numpy(x)).numpy()
    jax_out = np.asarray(jax_forward(jnp.asarray(x))).reshape(ROWS, 962)
    _assert_rows_close(staged, jax_out, "staged against JAX")
    want = _rfft64(x)
    _assert_rows_close(staged, want, "staged against f64")
    _assert_rows_close(jax_out, want, "JAX against f64")


@pytest.mark.parametrize("kind", KINDS)
def test_staged_inverse_matches_jax(kind):
    spec = _rfft64(_windows(kind)).astype(np.float32)  # the windows' spectra
    staged = fft.irfft960_staged(torch.from_numpy(spec)).numpy()
    jax_out = np.asarray(jax_inverse(jnp.asarray(spec.reshape(ROWS, 2, 481))))
    _assert_rows_close(staged, jax_out, "staged against JAX")
    want = _irfft64(spec)
    _assert_rows_close(staged, want, "staged against f64")
    _assert_rows_close(jax_out, want, "JAX against f64")


def test_inverse_reads_no_imaginary_part_at_dc_and_nyquist():
    """IV ignores im[0] and im[480]; the staged inverse does too."""
    spec = _rfft64(_windows("noise")).astype(np.float32)
    poked = spec.copy()
    poked[:, 481] = 1e4
    poked[:, 961] = -1e4
    a = fft.irfft960_staged(torch.from_numpy(spec)).numpy()
    b = fft.irfft960_staged(torch.from_numpy(poked)).numpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        fft.inverse_transform(torch.from_numpy(spec)).numpy(),
        fft.inverse_transform(torch.from_numpy(poked)).numpy(),
    )


def test_twiddle_table_is_the_f32_rounding_of_f64():
    """Every table entry is its f64 value rounded to f32 once, and the f64
    values are the twiddles by an independent route (complex exponentials)."""
    t64 = fft.fft960_table_f64()
    flat = np.concatenate([t64[k].reshape(-1) for k in ("win", "w480", "w32", "split", "const")])
    np.testing.assert_array_equal(fft.fft960_table(), flat.astype(np.float32))
    lanes, k1 = np.arange(32), np.arange(15)[:, None]
    ref = np.exp(-2j * np.pi * k1 * lanes / 480)
    np.testing.assert_allclose(t64["w480"][..., 0] + 1j * t64["w480"][..., 1], ref, atol=1e-15)
    ref = np.exp(-2j * np.pi * (k1 + 15 * fft.bitrev5(lanes)) / 960)
    np.testing.assert_allclose(t64["split"][..., 0] + 1j * t64["split"][..., 1], ref, atol=1e-15)
    for s, d in enumerate(fft.STAGES):
        ref = np.where(lanes & d, np.exp(-2j * np.pi * (lanes & (d - 1)) / (2 * d)), 1.0)
        np.testing.assert_allclose(t64["w32"][s, :, 0] + 1j * t64["w32"][s, :, 1], ref, atol=1e-15)
    np.testing.assert_array_equal(t64["win"].astype(np.float32), VORBIS_WINDOW)
    assert np.float32(t64["const"][5]) == np.float32(0.5) * WNORM


def test_probe_on_cpu_runs_the_dense_plain_versions():
    x = torch.from_numpy(_windows("noise"))
    before = fft.launches
    spec = fft.rfft960(x)
    assert torch.equal(spec, fft.forward_transform(x))
    assert torch.equal(fft.irfft960(spec), fft.inverse_transform(spec))
    assert fft.launches == before
    with pytest.raises(ValueError):
        fft.rfft960(x[:, :959])
    with pytest.raises(TypeError):
        fft.irfft960(spec.double())
    with pytest.raises(ValueError):
        fft.rfft960(torch.zeros((2, 960), device="meta"))
