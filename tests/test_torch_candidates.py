"""Kernel K4 and the octave-removal tables against the JAX package.

* K4's plain version (ops/frame_kernel.py::candidates_plain) against the
  Pallas ``candidates_pallas`` in interpret mode, on seeded R=256 tables,
  with pitch indices the search can give ([181, 768)) and any ([0, 768),
  whose small indices send lookups off the tables, where K4 reads 0);
* ``ops/pitch.py::doubling_candidates`` against the JAX package's
  ``vmap(doubling_candidates)`` for every pitch index in [0, 768) (a lookup
  off the table takes its nearest end, as XLA's gather does);
* ``doubling_tables`` against JAX's;
* the tools' old chain (tools/attrib.py::old_chain, ending in K4) against
  the same chain in JAX on the golden clip's windows.

Bars: lanes holding lags ([0], [4:18]) and pitch indices exact; values
within 1e-5 (identical arithmetic, f32), the tables within 1e-4 of their
scale (sums in another order), the old chain's lanes within 5e-3 of their
row's scale (tests/test_pitch_kernel.py's bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnnoiseless_tpu.constants import FRAME_SIZE, PITCH_BUF_SIZE, PITCH_FRAME_DS, PITCH_MAX_DS, PITCH_MAX_PERIOD
from nnnoiseless_tpu.ops import pitch as jp
from nnnoiseless_tpu.ops.biquad import biquad_filter_frames as jax_biquad_frames
from nnnoiseless_tpu.ops.fft import xcorr_dft
from nnnoiseless_tpu.ops.frame_kernel import candidates_pallas
from nnnoiseless_tpu.tables import BIQUAD_HP_A, BIQUAD_HP_B

from nnnoiseless_tpu_torch.ops import frame_kernel as fk
from nnnoiseless_tpu_torch.ops import pitch as tp
from nnnoiseless_tpu_torch.tools import attrib

T_LANES = [0] + list(range(4, 18))


def _tables(seed: int, r: int):
    rng = np.random.RandomState(seed)
    corr = (rng.randn(r, 385) * 1e3).astype(np.float32)
    yy = np.abs(rng.randn(r, 385) * 1e4).astype(np.float32)
    xx = np.abs(rng.randn(r) * 1e4).astype(np.float32)
    return corr, yy, xx, rng


@pytest.mark.parametrize("low", [181, 0])
def test_k4_plain_matches_pallas(low):
    corr, yy, xx, rng = _tables(1, 256)
    pidx = rng.randint(low, 768, size=256).astype(np.int32)
    if low == 0:
        pidx[:16] = np.arange(16)  # every index whose lookups leave the table
    want = np.asarray(candidates_pallas(*map(jnp.asarray, (corr, yy, xx, pidx)), interpret=True))
    before = fk.cand_launches
    got = fk.candidates(*map(torch.from_numpy, (corr, yy, xx, pidx))).numpy()
    assert fk.cand_launches == before  # CPU tensors never reach the kernel
    np.testing.assert_array_equal(got[:, T_LANES], want[:, T_LANES])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_doubling_candidates_matches_jax_every_pidx():
    r = 768
    rng = np.random.RandomState(2)
    corr = (rng.randn(r, 385) * 1e3).astype(np.float32)
    energies = (rng.randn(r, 385) * 1e4 + 5e3).astype(np.float32)  # some negative: clamped
    pidx = np.arange(r, dtype=np.int32)
    y = jnp.zeros((r, 864), jnp.float32)  # unused: the tables are given
    c, yl, xx = jax.vmap(jp.doubling_tables)(y, jnp.asarray(corr), jnp.asarray(energies))
    want = np.asarray(jax.vmap(jp.doubling_candidates)(c, yl, xx, jnp.asarray(pidx)))
    got = tp.doubling_candidates(*map(torch.from_numpy, (corr, energies, pidx))).numpy()
    np.testing.assert_array_equal(got[:, T_LANES], want[:, T_LANES])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def golden(testing_raw):
    """(JAX windows, port windows) of the golden clip: HP-filtered, one
    per frame hop, each decimated with its own lane 0."""
    nfr = len(testing_raw) // FRAME_SIZE
    fr = jnp.asarray(testing_raw[: nfr * FRAME_SIZE].reshape(1, nfr, FRAME_SIZE))
    filt, _ = jax_biquad_frames(fr, jnp.zeros((1, 2), jnp.float32), tuple(BIQUAD_HP_A), tuple(BIQUAD_HP_B))
    sig = np.asarray(filt).reshape(-1)
    wins = np.stack([sig[s : s + PITCH_BUF_SIZE] for s in range(0, len(sig) - PITCH_BUF_SIZE, FRAME_SIZE)])
    ds = wins[:, 0::2].copy()
    odd = wins[:, 1::2]
    ds[:, 1:] = ((odd[:, :-1] + odd[:, 1:]) * 0.5 + wins[:, 2::2]) * 0.5
    ds[:, 0] = (odd[:, 0] * 0.5 + wins[:, 0]) * 0.5
    return ds.astype(np.float32), attrib.golden_windows(testing_raw, "cpu").numpy()


@pytest.mark.parametrize("shared", [True, False])
def test_doubling_tables_match_jax(golden, shared):
    y = jax.vmap(jp.whiten)(jnp.asarray(golden[0]))
    if shared:
        corr = xcorr_dft(y[:, PITCH_MAX_DS:], y, PITCH_MAX_DS + 1)
        en = jp.window_energies(y, PITCH_FRAME_DS, PITCH_MAX_DS + 1)
        want = jax.vmap(jp.doubling_tables)(y, corr, en)
        got = tp.doubling_tables(*(torch.from_numpy(np.array(a)) for a in (y, corr, en)))
        for g, w in zip(got, want):  # the tables as given, flipped and clamped
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        return
    want = jax.vmap(jp.doubling_tables)(y)
    got = tp.doubling_tables(torch.from_numpy(np.array(y)))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())  # sums in another order


def test_old_chain_matches_jax(golden):
    """tools/attrib.py::old_chain (whiten, tables, search, doubling_tables,
    K4) against the JAX package's attrib chain on the golden windows."""
    ds_j, ds_t = golden
    np.testing.assert_allclose(ds_t, ds_j, rtol=1e-6, atol=1e-3)
    x_lp = jax.vmap(jp.whiten)(jnp.asarray(ds_j))
    corr = xcorr_dft(x_lp[:, PITCH_MAX_DS:], x_lp, PITCH_MAX_DS + 1)
    en = jp.window_energies(x_lp, PITCH_FRAME_DS, PITCH_MAX_DS + 1)
    pidx_j = PITCH_MAX_PERIOD - jax.vmap(jp.pitch_search)(x_lp, corr, en)
    cf, yl, xx = jax.vmap(jp.doubling_tables)(x_lp, corr, en)
    cand_j = np.asarray(candidates_pallas(cf, yl, xx, pidx_j, interpret=True))
    cand_t, pidx_t = attrib.old_chain(torch.from_numpy(ds_j))
    np.testing.assert_array_equal(pidx_t.numpy(), np.asarray(pidx_j))
    np.testing.assert_array_equal(cand_t.numpy()[:, T_LANES], cand_j[:, T_LANES])
    rowscale = np.abs(cand_j).max(axis=1, keepdims=True) + 1.0
    # the bar of tests/test_pitch_kernel.py: JAX's correlation there is an
    # FFT product, the port's a direct sum
    assert (np.abs(cand_t.numpy() - cand_j) / rowscale).max() < 5e-3
