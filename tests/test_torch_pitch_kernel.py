"""K1's and K3's plain versions (ops/pitch_kernel.py::pitch_analysis_plain
and pitch_analysis_stacked on CPU tensors, both the ops/pitch.py chain)
against the JAX pitch chain and the Pallas stream and stacked kernels in
interpret mode, on the same rows.

Bars of tests/test_pitch_kernel.py: pitch index and candidate t-lanes
exact, gain lanes < 1e-3, every lane within 5e-3 of its row's scale (the
whitening LPC solve amplifies f32 reduction-order differences, see there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnnoiseless_tpu.ops.pitch_kernel import pitch_analysis_pallas
from nnnoiseless_tpu.ops.pitch_kernel import pitch_analysis_stream as jax_stream
from test_pitch_kernel import G_LANES, T_LANES, _windows_from_signal, _xla_chain

from nnnoiseless_tpu_torch.ops import pitch_kernel as pk
from nnnoiseless_tpu_torch.ops.pitch import pitch_chain


def _assert_matches(cand, pidx, cand_ref, pidx_ref):
    c, cr = np.asarray(cand).reshape(-1, 105), np.asarray(cand_ref).reshape(-1, 105)
    np.testing.assert_array_equal(np.asarray(pidx).ravel(), np.asarray(pidx_ref).ravel())
    np.testing.assert_array_equal(c[:, T_LANES], cr[:, T_LANES])
    assert np.abs(c[:, G_LANES] - cr[:, G_LANES]).max() < 1e-3
    rowscale = np.abs(cr).max(axis=1, keepdims=True) + 1.0
    assert (np.abs(c - cr) / rowscale).max() < 5e-3


@pytest.fixture(scope="module")
def rows(testing_raw):
    """The 96 synthetic and 96 golden rows of tests/test_pitch_kernel.py."""
    rng = np.random.RandomState(7)
    t = np.arange(864) / 24000.0
    synth = []
    for _ in range(96):
        f0 = rng.uniform(60, 350)
        sig = sum(np.sin(2 * np.pi * f0 * h * t + rng.rand() * 6) / h for h in range(1, 6))
        synth.append(sig * rng.uniform(10, 3000) + rng.randn(864) * rng.uniform(0.1, 300))
    real = _windows_from_signal(testing_raw.astype(np.float64))[:96]
    return {"synthetic": np.stack(synth).astype(np.float32), "golden": real}


@pytest.mark.parametrize("which", ["synthetic", "golden"])
def test_plain_matches_xla_chain(rows, which):
    flat = rows[which]
    cand_ref, pidx_ref = _xla_chain(jnp.asarray(flat))
    cand, pidx = pitch_chain(torch.from_numpy(flat))
    _assert_matches(cand.numpy(), pidx.numpy(), cand_ref, pidx_ref)


@pytest.mark.parametrize("b", [5, 3])
def test_stream_matches_pallas_interpret(b):
    """The wrapper on CPU tensors (the plain version) against the Pallas
    stream kernel on the same decimated signal and lane-0 patches."""
    t = 4
    rng = np.random.RandomState(11)
    ds = (rng.randn(b, 864 + 240 * t) * 3000).astype(np.float32)
    w0 = (rng.randn(t, b) * 3000).astype(np.float32)
    c_ref, p_ref = jax_stream(jnp.asarray(ds), jnp.asarray(w0), t, interpret=True)
    before = pk.launches
    cand, pidx = pk.pitch_analysis_stream(torch.from_numpy(ds), torch.from_numpy(w0), t)
    assert pk.launches == before  # CPU tensors never reach the kernel
    assert cand.shape == (t, b, 105) and pidx.shape == (t, b) and pidx.dtype == torch.int32
    _assert_matches(cand.numpy(), pidx.numpy(), c_ref, p_ref)


@pytest.mark.parametrize("which", ["synthetic", "golden"])
def test_stacked_matches_pallas_interpret(rows, which):
    """K3's wrapper on 64 stacked CPU rows against pitch_analysis_pallas."""
    flat = rows[which][:64]
    c_ref, p_ref = pitch_analysis_pallas(jnp.asarray(flat), interpret=True)
    before = pk.stacked_launches
    cand, pidx = pk.pitch_analysis_stacked(torch.from_numpy(flat))
    assert pk.stacked_launches == before  # CPU tensors never reach the kernel
    assert cand.shape == (64, 105) and pidx.dtype == torch.int32
    _assert_matches(cand.numpy(), pidx.numpy(), c_ref, p_ref)


def test_window_stack_patch():
    """Frame t's window is ds[:, 240(t+1):][:864] with lane 0 patched, and
    the patch touches only that window."""
    b, t = 2, 3
    ds = torch.arange(b * (864 + 240 * t), dtype=torch.float32).reshape(b, -1)
    w0 = -torch.ones((t, b))
    wins = pk.window_stack(ds, w0, t)
    for k in range(t):
        np.testing.assert_array_equal(wins[k, :, 1:], ds[:, 240 * (k + 1) + 1 : 240 * (k + 1) + 864])
        np.testing.assert_array_equal(wins[k, :, 0], w0[k])
    assert float(ds.min()) == 0.0


# Windows that straddle digital silence (a muted or gated stream): the
# whitening's LPC solve is ill-conditioned there, so f32 is held to the
# same chain in float64.  Golden windows with samples [0, cut) zeroed
# ("head") or the last ``cut`` samples zeroed ("tail").
SILENCE_CUTS = (100, 300, 500, 700, 800, 840)


@pytest.mark.parametrize("side", ["head", "tail"])
@pytest.mark.parametrize("cut", SILENCE_CUTS)
def test_plain_matches_float64_on_silence_straddling_windows(testing_raw, side, cut):
    """The plain chain (K1's and K3's CPU version) in f32 against itself in
    float64: pidx and the t-lanes exact, no NaN lane."""
    k = SILENCE_CUTS.index(cut)
    w = _windows_from_signal(testing_raw.astype(np.float64))[(20 if side == "head" else 40) + 7 * k].copy()
    if side == "head":
        w[:cut] = 0.0
    else:
        w[864 - cut :] = 0.0
    cand, pidx = pitch_chain(torch.from_numpy(w[None].astype(np.float32)))
    cand64, pidx64 = pitch_chain(torch.from_numpy(w[None]))
    assert int(pidx[0]) == int(pidx64[0])
    np.testing.assert_array_equal(cand[0, T_LANES].numpy(), cand64[0, T_LANES].float().numpy())
    assert not bool(torch.isnan(cand).any())


def test_jax_chain_parts_from_float64_after_silence():
    """A recorded finding on the JAX side, not a fault of the port: with
    samples 0-799 of a window zero and 800-863 seeded noise at 3000, the
    port's f32 chain gives pidx 768 as the chain in float64 does, and the
    JAX XLA chain (tests/test_pitch_kernel.py::_xla_chain) does not: 762
    for this window alone, 763 when it runs in a batch of eight such
    windows (seeds 0-7), so its answer there also depends on the batch."""
    w = np.zeros((1, 864))
    w[0, 800:] = np.random.RandomState(4).randn(64) * 3000
    _, pidx = pitch_chain(torch.from_numpy(w.astype(np.float32)))
    _, pidx64 = pitch_chain(torch.from_numpy(w))
    _, pidx_j = _xla_chain(jnp.asarray(w.astype(np.float32)))
    assert int(pidx[0]) == int(pidx64[0]) == 768
    assert int(np.asarray(pidx_j)[0]) in (762, 763)
