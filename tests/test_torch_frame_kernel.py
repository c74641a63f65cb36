"""K2's plain version (ops/frame_kernel.py::frame_loop_plain, through the
run_frame_loop adapter) against the Pallas frame kernel in interpret mode
and against the JAX scan path, fed the same JAX precompute (filtered
frames and candidate lanes).

Bars of tests/test_fused_kernel.py on the CPU: output within 0.01 i16
units, vad within 1e-5, periods exact, carries as listed there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnnoiseless_tpu import FRAME_SIZE
from nnnoiseless_tpu import init_batch_carry as jax_init
from nnnoiseless_tpu.chunk import precompute_chunk as jax_precompute
from nnnoiseless_tpu.denoise import _scan_batch
from nnnoiseless_tpu.ops.frame_kernel import run_fused_scan

from nnnoiseless_tpu_torch.ops import frame_kernel as fk
from nnnoiseless_tpu_torch.ops.rnn import Rnn
from nnnoiseless_tpu_torch.pipeline import FramePre, init_carry
from nnnoiseless_tpu_torch.tables import BAND_INTERP_MATRIX


def _frames(testing_raw, b, t):
    return np.stack(
        [testing_raw[i * FRAME_SIZE * t : (i + 1) * FRAME_SIZE * t].reshape(t, FRAME_SIZE)
         for i in range(b)]
    )


def _run(model, frames):
    """(JAX scan path, Pallas interpret, port) results on one chunk."""
    b, t, _ = frames.shape
    params, meta = model.params, model.meta
    carry = jax_init(meta, b)
    ref = _scan_batch(params, meta, carry, jnp.asarray(frames))
    pre, _ = jax_precompute(carry.feat.input_mem, carry.feat.hp_mem, jnp.asarray(frames), lag0=False)
    fused = run_fused_scan(params, meta, carry, pre, interpret=True, block=4, return_trace=True)
    rnn = Rnn.from_params(params, meta, "cpu")
    pre_t = FramePre(
        filtered=torch.from_numpy(np.array(pre.filtered)),
        cand=torch.from_numpy(np.array(pre.cand)),
    )
    before = fk.launches
    port = fk.run_frame_loop(rnn, init_carry(meta, b, "cpu"), pre_t, return_trace=True)
    assert fk.launches == before  # CPU tensors never reach the kernel
    return ref, fused, port


@pytest.fixture(scope="module")
def paths(testing_raw, default_model):
    return _run(default_model, _frames(testing_raw, 4, 8))


@pytest.mark.parametrize("against", ["fused", "scan"])
def test_output_matches(paths, against):
    ref, fused, (_, out, vad, _) = paths
    out_j, vad_j = (fused if against == "fused" else ref)[1:3]
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=0.01, rtol=1e-5)
    np.testing.assert_allclose(vad.numpy(), np.asarray(vad_j), atol=1e-5)


@pytest.mark.parametrize("against", ["fused", "scan"])
def test_carries_match(paths, against):
    ref, fused, (c, _, _, _) = paths
    c_j = (fused if against == "fused" else ref)[0]
    np.testing.assert_array_equal(c.feat.pitch_period.numpy(), np.asarray(c_j.feat.pitch_period))
    np.testing.assert_allclose(c.feat.pitch_gain.numpy(), np.asarray(c_j.feat.pitch_gain), atol=1e-6)
    np.testing.assert_allclose(c.synthesis_mem.numpy(), np.asarray(c_j.synthesis_mem), atol=0.01)
    np.testing.assert_allclose(c.feat.cepstral_mem.numpy(), np.asarray(c_j.feat.cepstral_mem), atol=1e-5)
    np.testing.assert_allclose(c.feat.input_mem.numpy(), np.asarray(c_j.feat.input_mem), atol=0)
    for a, b in zip(c.rnn, c_j.rnn):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    np.testing.assert_allclose(c.lastg.numpy(), np.asarray(c_j.lastg), atol=1e-4)


def test_trace_lanes(paths):
    """The per-frame period and pitch-gain trace lanes match the Pallas
    kernel's, and their last frame is the final carry."""
    _, fused, (c, _, _, (periods, gains)) = paths
    periods_j, gains_j = fused[3]
    np.testing.assert_array_equal(periods.numpy(), np.asarray(periods_j))
    np.testing.assert_allclose(gains.numpy(), np.asarray(gains_j), atol=1e-6)
    np.testing.assert_array_equal(periods[:, -1].numpy(), c.feat.pitch_period.numpy())


def test_padded_batch_matches(testing_raw, default_model):
    """B=3 with the JAX kernel's 4-row block (one pad stream there)."""
    ref, fused, (c, out, vad, _) = _run(default_model, _frames(testing_raw, 3, 4))
    assert out.shape == (3, 4, FRAME_SIZE) and vad.shape == (3, 4)
    for c_j, out_j in (ref[:2], fused[:2]):
        np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=0.01, rtol=1e-5)
        np.testing.assert_array_equal(c.feat.pitch_period.numpy(), np.asarray(c_j.feat.pitch_period))


@pytest.mark.parametrize("skip", [(), ("lag0",), ("rd",), ("dft",), ("feat",), ("rnn",), ("comb",), ("inv",)])
def test_skip_matches_pallas(testing_raw, default_model, skip):
    """The attribution knob: each stage's stub in the plain version against
    the Pallas kernel's (frame_kernel.py:596-756 there), at B=4, T=3.

    The clip is scaled by 1/4096: the lag0 stub feeds the band energies
    to the RNN as cepstra, which at full scale (up to 8e8) drive the relu
    GRU states to ~1e16, where both sides' rounding decides the sign of
    sums that cancel."""
    b, t = 4, 3
    frames = jnp.asarray(_frames(testing_raw, b, t) / 4096.0)
    params, meta = default_model.params, default_model.meta
    carry = jax_init(meta, b)
    pre, _ = jax_precompute(carry.feat.input_mem, carry.feat.hp_mem, frames, lag0=False)
    c_j, out_j, vad_j, (per_j, gain_j) = run_fused_scan(
        params, meta, carry, pre, interpret=True, block=4, skip=skip, return_trace=True
    )
    pre_t = FramePre(
        filtered=torch.from_numpy(np.array(pre.filtered)), cand=torch.from_numpy(np.array(pre.cand))
    )
    rnn = Rnn.from_params(params, meta, "cpu")
    c, out, vad, (per, gain) = fk.run_frame_loop(
        rnn, init_carry(meta, b, "cpu"), pre_t, return_trace=True, skip=skip
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=0.01, rtol=1e-5)
    np.testing.assert_allclose(vad.numpy(), np.asarray(vad_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(per.numpy(), np.asarray(per_j))
    np.testing.assert_allclose(gain.numpy(), np.asarray(gain_j), atol=1e-6)
    np.testing.assert_allclose(c.synthesis_mem.numpy(), np.asarray(c_j.synthesis_mem), atol=0.01, rtol=1e-5)
    np.testing.assert_allclose(c.feat.cepstral_mem.numpy(), np.asarray(c_j.feat.cepstral_mem), atol=1e-5, rtol=1e-5)
    for a, w in zip(c.rnn, c_j.rnn):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(c.lastg.numpy(), np.asarray(c_j.lastg), atol=1e-4)


def test_interp_pairs_rebuild_the_dense_matrix():
    """K2 interpolates each bin from two table weights: the dense matrix
    has at most two nonzeros a row, in adjacent bands, so the kernel's
    fma(w1, v[b + 1], w0 v[b]) takes the dense dot's value."""
    w, band = fk.interp_pairs()
    assert w.shape == (481, 2) and band.shape == (481,) and band.max() + 1 < 22
    dense = np.zeros_like(BAND_INTERP_MATRIX)
    rows = np.arange(481)
    dense[rows, band] = w[:, 0]
    dense[rows, band + 1] += w[:, 1]
    np.testing.assert_array_equal(dense, BAND_INTERP_MATRIX)
