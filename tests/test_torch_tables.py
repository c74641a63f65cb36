"""The port's copied constants, tables, DFT bases and model parser must be
identical to the JAX package's; its torch module state must round-trip the
numpy params exactly."""

import dataclasses

import numpy as np
import pytest

import nnnoiseless_tpu.constants as jc
import nnnoiseless_tpu.tables as jt
from nnnoiseless_tpu.model import RnnModel as JaxModel
from nnnoiseless_tpu.ops.fft import dense_dft_bases as jax_bases

import nnnoiseless_tpu_torch.constants as tc
import nnnoiseless_tpu_torch.tables as tt
from nnnoiseless_tpu_torch.model import RnnModel, params_from_numpy
from nnnoiseless_tpu_torch.ops.fft import dense_dft_bases
from nnnoiseless_tpu_torch.ops.rnn import Rnn

from conftest import DATA_DIR


def test_constants_identical():
    names = [n for n in dir(jc) if n.isupper()]
    assert names and names == [n for n in dir(tc) if n.isupper()]
    for n in names:
        assert getattr(tc, n) == getattr(jc, n), n


@pytest.mark.parametrize("name", jt.__all__ + ["BIQUAD_HP_A", "SECOND_CHECK"])
def test_tables_bit_identical(name):
    a, b = getattr(tt, name), getattr(jt, name)
    if isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    else:
        assert type(a) is type(b) and a == b


def test_dense_dft_bases_identical():
    for a, b in zip(dense_dft_bases(), jax_bases()):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("path", ["default", "synthetic_demo.rnn"])
def test_parse_identical_and_roundtrip(path):
    if path == "default":
        ours, theirs = RnnModel.default(), JaxModel.default()
    else:
        ours = RnnModel.from_file(DATA_DIR / path)
        theirs = JaxModel.from_file(DATA_DIR / path)
    assert dataclasses.asdict(ours.meta) == dataclasses.asdict(theirs.meta)
    state = params_from_numpy(theirs.params, "cpu")
    rnn = Rnn.from_params(theirs.params, ours.meta, "cpu")
    assert set(rnn.state_dict()) == set(state)
    n = 0
    for layer, arrays in theirs.params.items():
        for key, arr in arrays.items():
            np.testing.assert_array_equal(ours.params[layer][key], arr)
            np.testing.assert_array_equal(state[f"{layer}.{key}"].numpy(), arr)
            np.testing.assert_array_equal(rnn.state_dict()[f"{layer}.{key}"].numpy(), arr)
            n += arr.size
    assert n == sum(t.numel() for t in rnn.state_dict().values())
