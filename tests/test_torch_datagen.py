"""The port's training-data generator (nnnoiseless_tpu_torch/training/
data.py) against the JAX package's on the CPU: the numpy host half bit for
bit, the 87-column rows of ``generate`` within stated bars, parallel
worlds, the HDF5 schema and the generator benchmark.

The corpus fixture is the one of tests/test_training.py.
"""

import json
import wave

import numpy as np
import pytest

import nnnoiseless_tpu.training.data as JD
import nnnoiseless_tpu_torch.training.data as TD
from nnnoiseless_tpu_torch.constants import NB_BANDS, NB_FEATURES

F, G = NB_FEATURES, NB_FEATURES + NB_BANDS  # column starts of gains and noise levels


def _write_wav(path, samples_f32):
    i16 = np.clip(np.round(samples_f32), -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(48_000)
        w.writeframes(i16.tobytes())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two tiny 'speech' files (tones) and two noise files."""
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(0)
    n = 48_000  # 1 s each
    t = np.arange(n) / 48_000.0
    _write_wav(d / "sig1.wav", np.sin(2 * np.pi * 220 * t) * 6000)
    _write_wav(d / "sig2.wav", np.sin(2 * np.pi * 550 * t) * 9000 * (t % 0.5 < 0.25))
    _write_wav(d / "noise1.wav", rng.randn(n) * 2000)
    _write_wav(d / "noise2.wav", rng.randn(n) * 500)
    return d


def _paths(corpus):
    return ([str(corpus / "sig1.wav"), str(corpus / "sig2.wav")],
            [str(corpus / "noise1.wav"), str(corpus / "noise2.wav")])


@pytest.fixture(scope="module")
def rows(corpus):
    """(port, JAX) rows of ``generate`` at seed 1, 300 rows, chunks of 128."""
    sig, noise = _paths(corpus)
    got = TD.generate(sig, noise, 300, seed=1, chunk=128, device="cpu")
    want = JD.generate(sig, noise, 300, seed=1, chunk=128)
    return got, want


def _sim(module, corpus, seed):
    sig, noise = _paths(corpus)
    rng = np.random.RandomState(seed)
    return module.NoiseSimulator(module.SignalReader(sig, 600, rng), module.SignalReader(noise, 600, rng), rng)


def test_next_frames_bit_identical_to_scalar_path(corpus, monkeypatch):
    """The batched simulator reproduces the per-frame path bit for bit
    across randomization boundaries (GAIN_CHANGE_COUNT shortened so that a
    batch spans several)."""
    monkeypatch.setattr(TD, "GAIN_CHANGE_COUNT", 37)
    a, b = _sim(TD, corpus, 7), _sim(TD, corpus, 7)
    for n in (1, 36, 37, 38, 200):
        want = [b.next_frame() for _ in range(n)]
        sig, noise, comb, cut, vad = a.next_frames(n)
        for t in range(n):
            np.testing.assert_array_equal(sig[t], want[t][0])
            np.testing.assert_array_equal(noise[t], want[t][1])
            np.testing.assert_array_equal(comb[t], want[t][2])
            assert cut[t] == want[t][3]
            assert vad[t] == want[t][4]
    np.testing.assert_array_equal(a.sig_mem, b.sig_mem)
    np.testing.assert_array_equal(a.noise_mem, b.noise_mem)
    assert a.rng.randint(1 << 30) == b.rng.randint(1 << 30)


def test_simulator_bit_identical_to_jax(corpus):
    """The port's host half is a numpy copy: the same seed gives the same
    frames, cutoffs and VAD labels, bit for bit, over three gain changes."""
    a, b = _sim(TD, corpus, 11), _sim(JD, corpus, 11)
    for n in (500, 3000, 5000):
        for x, y in zip(a.next_frames(n), b.next_frames(n)):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.sig_mem, b.sig_mem)
    assert a.rng.randint(1 << 30) == b.rng.randint(1 << 30)


def test_native_augmentation_biquad_matches_python(monkeypatch):
    rng = np.random.RandomState(4)
    x = (rng.randn(960) * 5000).astype(np.float32)
    a = np.array([0.3, -0.2], np.float32)
    b = np.array([-0.1, 0.25], np.float32)
    monkeypatch.setattr(TD, "_NATIVE_BIQUAD", False)  # the Python loop
    mem_py = np.zeros(2, np.float32)
    want = TD._biquad_np(x, mem_py, a, b)
    monkeypatch.setattr(TD, "_NATIVE_BIQUAD", None)  # resolve the native one
    mem_nat = np.zeros(2, np.float32)
    got = TD._biquad_np(x, mem_nat, a, b)
    assert TD._NATIVE_BIQUAD is not False, "the native engine did not build"
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(mem_nat, mem_py, rtol=1e-6, atol=1e-3)


def test_generate_vad_and_sentinels_match_jax(rows):
    got, want = rows
    assert got.shape == want.shape == (300, NB_FEATURES + 2 * NB_BANDS + 1)
    np.testing.assert_array_equal(got[:, -1], want[:, -1])
    np.testing.assert_array_equal(got[:, F:G] == -1.0, want[:, F:G] == -1.0)


def test_generate_gains_and_noise_levels_match_jax(rows):
    got, want = rows
    # A band's gain is the square root of a ratio of band energies.  Where
    # the clean energy is ~1e-3 of the mix, f32 rounding of the spectra
    # (relative to the frame's strongest bins) moves that ratio by up to
    # ~1e-3 of itself: measured 9.9e-6 absolute, 6.9e-4 relative, at a gain
    # of 0.014 (row 158, band 0), hence rtol 1e-3 beside atol 1e-5.
    np.testing.assert_allclose(got[:, F:G], want[:, F:G], atol=1e-5, rtol=1e-3)
    # measured 1.7e-6
    np.testing.assert_allclose(got[:, G:-1], want[:, G:-1], atol=1e-5, rtol=0)


def test_generate_features_match_jax(rows):
    got, want = rows
    # measured 1.7e-5
    np.testing.assert_allclose(got[:, :F], want[:, :F], atol=1e-4, rtol=0)


def test_generate_pitch_periods_match_jax(rows):
    """Feature 40 is 0.01 (period - 300) (zero on silent frames): no frame's
    period differs."""
    got, want = rows
    np.testing.assert_array_equal(np.rint(got[:, 40] * 100), np.rint(want[:, 40] * 100))


def test_generate_parallel_worlds(corpus):
    """workers > 1 batches 3W feature pipelines per chunk; rows stay
    world-contiguous and schema-valid, and world 0 is the single-world
    stream of the same seed."""
    sig, noise = _paths(corpus)
    data = TD.generate(sig, noise, 120, seed=3, chunk=32, workers=4, device="cpu")
    assert data.shape == (120, NB_FEATURES + 2 * NB_BANDS + 1)
    assert np.all(np.isfinite(data))
    assert np.all((data[:, F:G] >= -1.0) & (data[:, F:G] <= 1.0))
    solo = TD.generate(sig, noise, 30, seed=3, chunk=32, workers=1, device="cpu")
    # not bit-equal: the products run at another batch size, and round
    # differently; measured 9.5e-7
    np.testing.assert_allclose(data[:30], solo, atol=1e-4, rtol=1e-4)


def test_generate_schema_and_h5_roundtrip(rows, tmp_path):
    h5py = pytest.importorskip("h5py")
    from nnnoiseless_tpu_torch.training.network import load_h5

    data, _ = rows
    assert np.all(np.isfinite(data))
    assert np.all((data[:, F:G] >= -1.0) & (data[:, F:G] <= 1.0))
    assert set(np.unique(data[:, -1])).issubset({0.0, 0.5, 1.0})
    with h5py.File(tmp_path / "train.h5", "w") as f:
        f.create_dataset("data", data=data)
    feats, g, v = load_h5(str(tmp_path / "train.h5"), window=100)
    assert feats.shape == (3, 100, NB_FEATURES) and g.shape == (3, 100, NB_BANDS) and v.shape == (3, 100, 1)
    np.testing.assert_array_equal(feats.reshape(-1, NB_FEATURES), data[:, :F])


def test_datagen_bench_prints_json(corpus, tmp_path, capsys, monkeypatch):
    """The tool at a tiny size: its 30-file corpus is swapped for the
    fixture's four files."""
    from nnnoiseless_tpu_torch.tools import datagen_bench

    monkeypatch.setattr(datagen_bench, "build_corpus", lambda workdir: _paths(corpus))
    datagen_bench.main(["--rows", "90", "--workers", "2", "--chunk", "20", "--workdir", str(tmp_path),
                        "--device", "cpu"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["rows"] == 90 and result["device"] == "cpu"
    assert result["rows_per_s"] > 0 and result["device_s"] > 0 and result["host_s"] > 0
