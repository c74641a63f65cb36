"""The port's plain ops against their JAX counterparts on the same inputs
(made with numpy from a seed).  Both sides are f32 on the CPU; only the
summation order of the products differs, so values agree to ~1e-6
relative (bars: 1e-5 relative, with the absolute floor stated per test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnnoiseless_tpu.ops import activations as ja
from nnnoiseless_tpu.ops import bands as jb
from nnnoiseless_tpu.ops.biquad import biquad_filter_frames as jax_biquad
from nnnoiseless_tpu.ops.pitch import remove_doubling_from_candidates as jax_rd
from nnnoiseless_tpu.ops.rnn import RnnState as JaxState, rnn_step
from nnnoiseless_tpu.tables import BIQUAD_HP_A, BIQUAD_HP_B

from nnnoiseless_tpu_torch.ops import activations as ta
from nnnoiseless_tpu_torch.ops import bands as tb
from nnnoiseless_tpu_torch.ops.biquad import biquad_filter_frames
from nnnoiseless_tpu_torch.ops.pitch import remove_doubling_from_candidates
from nnnoiseless_tpu_torch.ops.rnn import Rnn, RnnState

RNG_SEED = 1234


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _activation_inputs():
    rng = np.random.RandomState(RNG_SEED)
    edges = [np.nan, 8.0, -8.0, 7.99, -7.99, 7.999, np.inf, -np.inf, 0.0, -0.0, 0.02, -0.02]
    return np.concatenate([rng.uniform(-10, 10, 4000), edges]).astype(np.float32)


@pytest.mark.parametrize("name", ["tansig_approx", "sigmoid_approx", "relu"])
def test_activations(name):
    x = _activation_inputs()
    got = getattr(ta, name)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(ja, name)(jnp.asarray(x)))
    # same table, same f32 arithmetic: equal to 1 ulp
    _close(got, want, rtol=1e-6, atol=1e-7)
    if name == "tansig_approx":
        assert got[-12] == 1.0  # NaN -> 1
        np.testing.assert_array_equal(got[-11:-9], [1.0, -1.0])


def test_bands_and_dct():
    rng = np.random.RandomState(RNG_SEED)
    x = (rng.randn(7, 962) * 300).astype(np.float32)
    p = (rng.randn(7, 962) * 300).astype(np.float32)
    v = rng.rand(7, 22).astype(np.float32)
    xt, pt = torch.from_numpy(x), torch.from_numpy(p)
    split = lambda a: jnp.asarray(a.reshape(7, 2, 481))
    rel = 1e-5
    _close(tb.band_corr(xt, pt), jb.band_corr(split(x), split(p)), rel, 1e-2)
    _close(tb.band_energies(xt), jb.band_energies_flat(jnp.asarray(x)), rel, 1e-2)
    gains = tb.interp_band_gain(torch.from_numpy(v)).numpy()
    want = np.asarray(jb.interp_band_gain(jnp.asarray(v)))
    _close(gains[:, :481], want, rel, 1e-7)
    _close(gains[:, 481:], want, rel, 1e-7)
    _close(tb.dct22(torch.from_numpy(v)), jb.dct22(jnp.asarray(v)), rel, 1e-6)


def test_biquad_filter_frames():
    """B=3, T=5 with a non-zero carry: the chunk filter and its final carry."""
    rng = np.random.RandomState(RNG_SEED)
    frames = (rng.randn(3, 5, 480) * 8000).astype(np.float32)
    mem = (rng.randn(3, 2) * 500).astype(np.float32)
    y, m = biquad_filter_frames(
        torch.from_numpy(frames), torch.from_numpy(mem), tuple(BIQUAD_HP_A), tuple(BIQUAD_HP_B)
    )
    yj, mj = jax_biquad(jnp.asarray(frames), jnp.asarray(mem), tuple(BIQUAD_HP_A), tuple(BIQUAD_HP_B))
    # i16-scale signal: 1e-5 relative or 0.01 units absolute
    _close(y, yj, 1e-5, 1e-2)
    _close(m, mj, 1e-5, 1e-2)


def test_rnn_step(default_model):
    params, meta = default_model.params, default_model.meta
    rng = np.random.RandomState(RNG_SEED)
    b = 6
    feats = (rng.randn(b, 42) * 2).astype(np.float32)
    h = [rng.uniform(-1, 1, (b, n)).astype(np.float32) for n in (24, 48, 96)]
    rnn = Rnn.from_params(params, meta, "cpu")
    st, gains, vad = rnn(RnnState(*map(torch.from_numpy, h)), torch.from_numpy(feats))
    stj, gj, vj = rnn_step(params, meta, JaxState(*map(jnp.asarray, h)), jnp.asarray(feats))
    for a, w in zip(st, stj):
        _close(a, w, 1e-5, 1e-6)
    _close(gains, gj, 1e-5, 1e-6)
    _close(vad, vj, 1e-5, 1e-6)


def test_remove_doubling_from_candidates():
    """The carry-dependent octave selection on candidate lanes built from
    seeded integer-valued t-lanes and random correlation lanes."""
    rng = np.random.RandomState(RNG_SEED)
    r = 500
    t0 = rng.randint(90, 384, r)
    cand = rng.uniform(-1, 1, (r, 105)).astype(np.float32) * 3
    cand[:, 0] = t0
    for k in range(2, 16):
        cand[:, 4 + k - 2] = (2 * t0 + k) // (2 * k)
    last_p = rng.randint(60, 769, r).astype(np.int32)
    last_g = rng.uniform(0, 1, r).astype(np.float32)
    per, pg = remove_doubling_from_candidates(
        torch.from_numpy(cand), torch.from_numpy(last_p), torch.from_numpy(last_g)
    )
    perj, pgj = jax.vmap(jax_rd)(jnp.asarray(cand), jnp.asarray(last_p), jnp.asarray(last_g))
    np.testing.assert_array_equal(per.numpy(), np.asarray(perj))
    _close(pg, pgj, 1e-6, 1e-7)
