"""K1's ``skip`` knob: the plain version with each stage stubbed against the
JAX Pallas stream kernel with the same stub (interpret mode), on the same
seeded decimated signal; ``skip=()`` is the production call; one stage at
a time.  Bars of tests/test_torch_pitch_kernel.py::_assert_matches, except
where a stub changes what a lane holds: with the energy table stubbed the
gain lanes are xy / sqrt(1 + 0), raw correlations of ~1e8, so their 1e-3
bar is taken of the row scale; with the walk stubbed every lane is the
energy xx, so the t-lanes hold no lag and take the row-scale bar.

The kernel's stubs against the plain ones run on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnnoiseless_tpu.ops.pitch_kernel import pitch_analysis_stream as jax_stream
from test_pitch_kernel import G_LANES, T_LANES
from test_torch_pitch_kernel import _assert_matches

from nnnoiseless_tpu_torch.ops import pitch_kernel as pk

B, T = 3, 2


def _signal():
    """(B, 864 + 240T) decimated signal and (T, B) lane-0 patches: harmonic
    tones in noise at i16 scale, one stream of noise alone."""
    rng = np.random.RandomState(21)
    n = 864 + 240 * T
    t = np.arange(n) / 24000.0
    ds = np.empty((B, n), np.float32)
    for b in range(B):
        f0 = rng.uniform(80, 300)
        tone = sum(np.sin(2 * np.pi * f0 * h * t + rng.rand() * 6) / h for h in range(1, 6))
        ds[b] = tone * rng.uniform(500, 4000) * (b != 2) + rng.randn(n) * rng.uniform(30, 600)
    w0 = (rng.randn(T, B) * 1000).astype(np.float32)
    return ds, w0


@pytest.mark.parametrize("stage", pk.SKIP_STAGES)
def test_plain_stub_matches_pallas_interpret(stage):
    ds, w0 = _signal()
    c_ref, p_ref = jax_stream(jnp.asarray(ds), jnp.asarray(w0), T, interpret=True, block=8,
                              skip=(stage,))
    before = pk.launches
    cand, pidx = pk.pitch_analysis_stream(torch.from_numpy(ds), torch.from_numpy(w0), T, skip=(stage,))
    assert pk.launches == before  # CPU tensors never reach the kernel
    assert cand.shape == (T, B, 105) and pidx.shape == (T, B) and pidx.dtype == torch.int32
    if stage not in ("etab", "cand"):
        _assert_matches(cand.numpy(), pidx.numpy(), c_ref, p_ref)
        return
    c, cr = cand.numpy().reshape(-1, 105), np.asarray(c_ref).reshape(-1, 105)
    np.testing.assert_array_equal(pidx.numpy().ravel(), np.asarray(p_ref).ravel())
    rowscale = np.abs(cr).max(axis=1, keepdims=True) + 1.0
    if stage == "etab":
        np.testing.assert_array_equal(c[:, T_LANES], cr[:, T_LANES])
        assert (np.abs(c[:, G_LANES] - cr[:, G_LANES]) / rowscale).max() < 1e-3
    else:
        assert (cr == cr[:, :1]).all() and (c == c[:, :1]).all()  # every lane xx
    assert (np.abs(c - cr) / rowscale).max() < 5e-3


def test_skip_none_is_production():
    ds, w0 = (torch.from_numpy(a) for a in _signal())
    prod = pk.pitch_analysis_stream(ds, w0, T)
    none = pk.pitch_analysis_stream(ds, w0, T, skip=())
    assert all(torch.equal(a, b) for a, b in zip(prod, none))
    stub = pk.pitch_analysis_plain(ds, w0, T, skip=("corr",))
    assert not torch.equal(prod[0], stub[0])


@pytest.mark.parametrize("skip", [("bogus",), ("corrinv",), ("whiten", "corr"), ("etab", "etab")])
def test_skip_refuses_unknown_or_several_stages(skip):
    ds, w0 = (torch.from_numpy(a) for a in _signal())
    for fn in (pk.pitch_analysis_stream, pk.pitch_analysis_plain, pk.pitch_analysis_cuda):
        with pytest.raises(ValueError):
            fn(ds, w0, T, skip=skip)
