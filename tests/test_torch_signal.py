"""The port's streaming iterator adapter (reference src/signal.rs), the
cases of tests/test_signal.py on the CPU, plus the native engine and one
comparison with the JAX package's adapter."""

import numpy as np
import pytest

import nnnoiseless_tpu_torch as nt
from nnnoiseless_tpu_torch import FRAME_SIZE, DenoiseSignal, denoise_audio


@pytest.fixture(scope="module")
def model():
    return nt.RnnModel.default()


def test_mono_equivalence(testing_raw, model):
    n = 6 * FRAME_SIZE
    src = (testing_raw[:n] / 32768.0).tolist()
    got = np.asarray(list(DenoiseSignal(src, model, device="cpu")), np.float32)
    want = denoise_audio(testing_raw[:n], model, drop_first_frame=True, device="cpu")
    want = np.clip(want / 32768.0, -1.0, 1.0)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_signal_full_golden(testing_raw, reference_output):
    src = testing_raw / 32768.0
    out = np.fromiter(iter(DenoiseSignal(src, device="cpu")), np.float64) * 32768.0
    n = min(len(out), len(reference_output))
    assert n == len(reference_output)
    o = out[:n].astype(np.int16).astype(np.float64)
    ref = reference_output[:n].astype(np.float64)
    assert np.sum((ref - o) ** 2) / np.sum(o**2) < 1e-4


def test_multichannel_tuples(model):
    rng = np.random.RandomState(0)
    n = 3 * FRAME_SIZE
    stereo = (rng.randn(n, 2) * 0.05).astype(np.float32)
    out = list(DenoiseSignal([tuple(s) for s in stereo], model, device="cpu"))
    assert len(out) == n - FRAME_SIZE
    assert all(len(s) == 2 for s in out)
    assert np.all(np.abs(np.asarray(out)) <= 1.0)


def test_chunked_dispatch(model, monkeypatch):
    """One engine call covers up to ``latency_frames`` frames."""
    calls = []
    orig = nt.StreamBatch.process

    def spy(self, frames):
        calls.append(frames.shape)
        return orig(self, frames)

    monkeypatch.setattr(nt.StreamBatch, "process", spy)
    n = 7 * FRAME_SIZE
    out = list(DenoiseSignal(np.zeros(n, np.float32), model, latency_frames=4, device="cpu"))
    assert [c[1] for c in calls] == [4, 3]
    assert len(out) == n - FRAME_SIZE


def test_latency_one_matches_chunked(testing_raw, model):
    n = 5 * FRAME_SIZE
    src = (testing_raw[:n] / 32768.0).astype(np.float64)
    a = np.asarray(list(DenoiseSignal(src, model, latency_frames=1, device="cpu")))
    b = np.asarray(list(DenoiseSignal(src, model, latency_frames=50, device="cpu")))
    np.testing.assert_allclose(a, b, atol=1e-4)


def test_partial_tail_exact_length():
    out = list(DenoiseSignal([0.0] * (FRAME_SIZE + 10), device="cpu"))
    assert len(out) == 10
    np.testing.assert_allclose(out, 0.0, atol=1e-4)
    assert len(list(DenoiseSignal([0.0] * (3 * FRAME_SIZE + 7), device="cpu"))) == 2 * FRAME_SIZE + 7


def test_empty_source():
    assert list(DenoiseSignal([], device="cpu")) == []


def test_constructor_aliases(model):
    a = DenoiseSignal.new([0.0] * FRAME_SIZE, device="cpu")
    b = DenoiseSignal.with_model([0.0] * FRAME_SIZE, model, device="cpu")
    c = DenoiseSignal.from_model([0.0] * FRAME_SIZE, model, device="cpu")
    for sig in (a, b, c):
        assert list(sig) == []
    with pytest.raises(ValueError):
        DenoiseSignal([0.0], engine="tpu")


def test_native_engine_golden_and_against_torch(testing_raw, reference_output, model):
    src = testing_raw / 32768.0
    out = np.fromiter(iter(DenoiseSignal(src, engine="native", latency_frames=1)), np.float64)
    o = (out * 32768.0)[: len(reference_output)].astype(np.int16).astype(np.float64)
    ref = reference_output.astype(np.float64)
    assert np.sum((ref - o) ** 2) / np.sum(o**2) < 1e-4
    torch_out = np.asarray(list(DenoiseSignal(src[: 6 * FRAME_SIZE], model, device="cpu")))
    native_out = np.asarray(list(DenoiseSignal(src[: 6 * FRAME_SIZE], model, engine="native")))
    np.testing.assert_allclose(native_out, torch_out, atol=2e-4)


def test_matches_jax_adapter(testing_raw):
    from nnnoiseless_tpu import DenoiseSignal as JaxDenoiseSignal

    src = (testing_raw[: 6 * FRAME_SIZE] / 32768.0).astype(np.float64)
    got = np.asarray(list(DenoiseSignal(src, device="cpu")))
    want = np.asarray(list(JaxDenoiseSignal(src)))
    np.testing.assert_allclose(got, want, atol=1e-5)
