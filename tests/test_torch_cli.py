"""The port's CLI on the CPU: the cases of tests/test_cli.py with
``--device cpu``, its output on testing.raw against the JAX package's CLI,
and the clean error for ``--device cuda`` without a card."""

import wave

import numpy as np
import pytest
import torch

from conftest import DATA_DIR

from nnnoiseless_tpu_torch.cli import main as port_main
from nnnoiseless_tpu_torch.tools.corr import main as corr_main


def cli_main(argv):
    return port_main(list(argv) + ["--device", "cpu"])


def test_basic_usage_raw(tmp_path):
    inp = tmp_path / "in.raw"
    out = tmp_path / "out.raw"
    inp.write_bytes(b"\x00" * 4800)
    assert cli_main([str(inp), str(out)]) == 0
    got = np.fromfile(out, dtype="<i2")
    assert len(got) == 4 * 480  # 5 frames, the first dropped
    np.testing.assert_array_equal(got, 0)


def test_invalid_wav_rejected(tmp_path, capsys):
    inp = tmp_path / "in.wav"
    out = tmp_path / "out.raw"
    inp.write_bytes(b"this is not really a wav file")
    assert cli_main([str(inp), str(out)]) != 0
    assert "failed to read" in capsys.readouterr().err
    inp2 = tmp_path / "in.bin"
    inp2.write_bytes(b"this is not really a wav file")
    assert cli_main([str(inp2), str(out), "--wav-in"]) != 0


@pytest.mark.parametrize("name", ["mono.wav", "mono-float.wav", "stereo.wav"])
def test_wav_inputs(tmp_path, name):
    out = tmp_path / "out.wav"
    assert cli_main([str(DATA_DIR / name), str(out)]) == 0
    with wave.open(str(out), "rb") as w:
        assert w.getframerate() == 48_000
        assert w.getsampwidth() == 2
        assert w.getnchannels() == (2 if name == "stereo.wav" else 1)
        assert w.getnframes() > 0


def test_float_wav_matches_int_wav(tmp_path):
    out_i = tmp_path / "int.raw"
    out_f = tmp_path / "float.raw"
    assert cli_main([str(DATA_DIR / "mono.wav"), str(out_i)]) == 0
    assert cli_main([str(DATA_DIR / "mono-float.wav"), str(out_f)]) == 0
    a = np.fromfile(out_i, dtype="<i2").astype(np.float64)
    b = np.fromfile(out_f, dtype="<i2").astype(np.float64)
    n = min(len(a), len(b))
    corr = np.sum(a[:n] * b[:n]) / np.sqrt(np.sum(a[:n] ** 2) * np.sum(b[:n] ** 2))
    assert corr > 1 - 1e-4


def test_resampled_input(tmp_path):
    rate = 24_000
    t = np.arange(rate) / rate
    sig = (np.sin(2 * np.pi * 440 * t) * 8000).astype("<i2")
    inp = tmp_path / "in24k.wav"
    with wave.open(str(inp), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(sig.tobytes())
    out = tmp_path / "out.wav"
    assert cli_main([str(inp), str(out)]) == 0
    with wave.open(str(out), "rb") as w:
        assert w.getframerate() == 48_000
        assert abs(w.getnframes() - 99 * 480) <= 480


def test_custom_model_from_converted_rnnoise(tmp_path):
    from nnnoiseless_tpu_torch.model import convert_rnnoise

    model_path = tmp_path / "sh.rnn"
    model_path.write_bytes(convert_rnnoise((DATA_DIR / "sh.rnnn").read_text()))
    inp = tmp_path / "in.raw"
    out = tmp_path / "out.raw"
    (np.random.RandomState(0).randn(2400) * 1000).astype("<i2").tofile(inp)
    assert cli_main([str(inp), str(out), "--model", str(model_path)]) == 0
    assert out.exists() and out.stat().st_size == 4 * 480 * 2


def test_corr_tool(tmp_path):
    a = tmp_path / "a.raw"
    b = tmp_path / "b.raw"
    sig = (np.random.RandomState(0).randn(1000) * 1000).astype("<i2")
    sig.tofile(a)
    sig.tofile(b)
    assert corr_main([str(a), str(b)]) == 0
    sig[::-1].copy().tofile(b)
    assert corr_main([str(a), str(b)]) == 1


def test_profile_sine_bench_smoke():
    from nnnoiseless_tpu_torch.tools.profile import sine_bench, sine_signal

    sig = sine_signal(0.2)
    assert sig.shape == (9600,) and np.max(np.abs(sig)) <= 16000
    stats = sine_bench(batch=2, seconds=0.2, device="cpu")
    assert stats["batch"] == 2 and stats["frames"] == 20
    assert stats["frames_per_sec"] > 0 and stats["realtime_factor"] > 0


def test_native_engine_cli(tmp_path):
    out = tmp_path / "out.raw"
    assert cli_main([str(DATA_DIR / "testing.raw"), str(out), "--engine", "native"]) == 0
    got = np.fromfile(out, dtype="<i2").astype(np.float64)
    ref = np.fromfile(DATA_DIR / "reference_output.raw", dtype="<i2").astype(np.float64)
    n = min(len(got), len(ref))
    assert np.sum((ref[:n] - got[:n]) ** 2) / np.sum(got[:n] ** 2) < 1e-4


def test_bad_model_clean_error(tmp_path, capsys):
    out = tmp_path / "out.raw"
    inp = tmp_path / "in.raw"
    inp.write_bytes(b"\x00" * 4800)
    bad = tmp_path / "bad.rnn"
    bad.write_bytes(b"not a model at all")
    assert cli_main([str(inp), str(out), "--model", str(bad)]) == 1
    assert "failed to load model" in capsys.readouterr().err
    assert cli_main([str(inp), str(out), "--model", str(bad), "--engine", "native"]) == 1


def test_matches_jax_cli(tmp_path):
    """The port's output on testing.raw is the JAX package's CLI output
    within 1 i16 unit per sample, and meets the golden bars."""
    from nnnoiseless_tpu.cli import main as jax_main

    ours, theirs = tmp_path / "port.raw", tmp_path / "jax.raw"
    assert cli_main([str(DATA_DIR / "testing.raw"), str(ours)]) == 0
    assert jax_main([str(DATA_DIR / "testing.raw"), str(theirs)]) == 0
    a = np.fromfile(ours, dtype="<i2").astype(np.int32)
    b = np.fromfile(theirs, dtype="<i2").astype(np.int32)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1
    ref = np.fromfile(DATA_DIR / "reference_output.raw", dtype="<i2").astype(np.float64)
    assert np.sum((ref - a) ** 2) / np.sum(a.astype(np.float64) ** 2) < 1e-4
    assert np.abs(ref - a).max() <= 2


def test_cuda_device_without_card_fails_cleanly(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    out = tmp_path / "out.raw"
    assert port_main([str(DATA_DIR / "testing.raw"), str(out), "--device", "cuda"]) == 1
    assert port_main([str(DATA_DIR / "testing.raw"), str(out)]) == 1  # cuda is the default
    err = capsys.readouterr().err
    assert err.startswith("error:") and "CUDA" in err
    assert not out.exists()
