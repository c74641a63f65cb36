"""K5's plain version (ops/rnn.py::rnn_step on CPU tensors, which is
Rnn.forward) against the Pallas RNN kernel in interpret mode and against
the JAX rnn_step, on states and features made by numpy from a seed; and the
weight packing K2 and K5 share.

Bar: 2e-5 absolute on every output, the loosest class of
tests/test_ops.py::test_rnn_pallas_kernel_matches_xla.  Both sides sum the
same f32 products in another order: a pre-activation accumulates up to 210
products of int8 weights with partial sums near 1e4, where one f32 ulp is
~1e-3, ~4e-6 after the 1/256 scale (measured: 8.6e-6 on the denoise state
against the Pallas kernel).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnnoiseless_tpu.ops import rnn_pallas as rp
from nnnoiseless_tpu.ops.rnn import RnnState as JaxState, rnn_step as jax_rnn_step

from nnnoiseless_tpu_torch.model import RnnModel
from nnnoiseless_tpu_torch.ops import rnn_kernel as rk
from nnnoiseless_tpu_torch.ops.rnn import Rnn, RnnState, rnn_step

B = rp._BLOCK  # 512, one Pallas block
ATOL = 2e-5
OUTPUTS = ("vad", "noise", "denoise", "gains", "vad_prob")


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(13)
    state = (
        (rng.randn(B, 24) * 0.5).astype(np.float32),
        np.maximum(rng.randn(B, 48), 0).astype(np.float32),
        (rng.randn(B, 96) * 0.5).astype(np.float32),
    )
    feats = (rng.randn(B, 42) * 2).astype(np.float32)
    return state, feats


@pytest.fixture(scope="module")
def port(inputs, default_model):
    state, feats = inputs
    rnn = Rnn.from_params(default_model.params, default_model.meta, "cpu")
    before = rk.launches
    st, gains, vad = rnn_step(rnn, RnnState(*map(torch.from_numpy, state)), torch.from_numpy(feats))
    assert rk.launches == before  # CPU tensors never reach the kernel
    return (*(a.numpy() for a in st), gains.numpy(), vad.numpy())


@pytest.mark.parametrize("against", ["pallas", "jax"])
def test_rnn_step_matches(inputs, port, default_model, against):
    state, feats = inputs
    m = default_model
    if against == "pallas":
        want = rp._rnn_pallas(
            rp._flatten_params(m.params), *map(jnp.asarray, state), jnp.asarray(feats),
            rp.meta_acts(m.meta), interpret=True,
        )
        want = (*want[:4], want[4][:, 0])
    else:
        st, gains, vad = jax_rnn_step(
            m.params, m.meta, JaxState(*map(jnp.asarray, state)), jnp.asarray(feats)
        )
        want = (*st, gains, vad)
    for name, got, ref in zip(OUTPUTS, port, want):
        np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL, rtol=0, err_msg=name)


def test_pack_weights_layout():
    """The int8 buffer holds every weight in kernel order at its offset,
    exactly; a weight that is not an int8 value raises."""
    model = RnnModel.default()
    rnn = Rnn.from_params(model.params, model.meta, "cpu")
    w, woff, acts = rk.pack_weights(rnn, torch.device("cpu"))
    assert w.dtype == torch.int8 and w.numel() == 87503
    assert acts.tolist() == list(model.meta.acts())
    for (layer, name), off in zip(rk._WEIGHT_ORDER, woff.tolist()):
        ref = model.params[layer][name].reshape(-1)
        np.testing.assert_array_equal(w[off : off + ref.size].numpy().astype(np.float32), ref)
    rnn.vad_gru.b[0] = 0.5
    with pytest.raises(ValueError):
        rk.pack_weights(rnn, torch.device("cpu"))
