"""The port's model I/O against the JAX package's: serialization, the
rnnoise-nu text converter and the Option-style parser."""

import numpy as np
import pytest

from conftest import DATA_DIR

import nnnoiseless_tpu_torch as nt
from nnnoiseless_tpu_torch.model import DEFAULT_WEIGHTS, ModelParseError, RnnModel, convert_rnnoise


def test_to_bytes_roundtrips_default_model():
    data = DEFAULT_WEIGHTS.read_bytes()
    assert len(data) == 87521
    assert RnnModel.default().to_bytes() == data
    assert RnnModel.from_static_bytes(data).to_bytes() == data


def test_to_bytes_matches_jax_and_rejects_non_int8(default_model):
    port = RnnModel(default_model.params, default_model.meta)
    assert port.to_bytes() == default_model.to_bytes()
    bad = RnnModel({k: dict(v) for k, v in default_model.params.items()}, default_model.meta)
    bad.params["vad_output"]["b"] = bad.params["vad_output"]["b"] + 0.5
    with pytest.raises(ValueError):
        bad.to_bytes()


def test_convert_rnnoise_matches_jax():
    from nnnoiseless_tpu.model import convert_rnnoise as jax_convert

    text = (DATA_DIR / "sh.rnnn").read_text()
    data = convert_rnnoise(text)
    assert data == jax_convert(text)
    assert nt.convert_rnnoise is convert_rnnoise
    m = RnnModel.from_bytes(data)
    assert m.meta.input_dense.nb_inputs == 42 and m.meta.denoise_output.nb_neurons == 22
    assert m.to_bytes() == data
    with pytest.raises(ModelParseError):
        convert_rnnoise("not a model\n1 2 3")


def test_try_from_bytes_returns_none_on_bad_bytes():
    assert RnnModel.try_from_bytes(b"") is None
    assert RnnModel.try_from_bytes(b"\x01\x02") is None
    assert RnnModel.try_from_bytes(bytes([42, 24, 0, 1, 2, 3])) is None  # truncated
    assert RnnModel.try_from_bytes(bytes([42, 24, 7]) + b"\x00" * 2000) is None  # activation
    good = DEFAULT_WEIGHTS.read_bytes()
    assert RnnModel.try_from_bytes(good + b"\x00") is None  # trailing bytes
    assert RnnModel.try_from_bytes(good).meta == RnnModel.default().meta
    with pytest.raises(ModelParseError):
        RnnModel.from_bytes(b"junk")


def test_native_state_takes_a_custom_model(testing_raw):
    """DenoiseState(engine="native") hands a custom model to the C++ engine
    as its .rnn bytes: the converted sh.rnnn model changes the output, and
    the default model run that way matches the built-in one."""
    frames = testing_raw[: 4 * 480].reshape(4, 480)
    sh = RnnModel.from_bytes(convert_rnnoise((DATA_DIR / "sh.rnnn").read_text()))
    builtin, _ = nt.DenoiseState(engine="native").process_chunk(frames)
    default, _ = nt.DenoiseState.from_model(RnnModel.default(), engine="native").process_chunk(frames)
    custom, _ = nt.DenoiseState.with_model(sh, engine="native").process_chunk(frames)
    np.testing.assert_array_equal(default, builtin)
    assert np.abs(custom - builtin).max() > 1.0
    torch_out, _ = nt.DenoiseState.new(device="cpu").process_chunk(frames)
    np.testing.assert_allclose(builtin[1:], torch_out[1:], atol=2.0)
