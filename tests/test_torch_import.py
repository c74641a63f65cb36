"""The port stands alone: importing and running it never loads JAX, CPU
tensors never reach a kernel, and chip_smoke.py refuses to run without a
card."""

import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

import nnnoiseless_tpu_torch as nt

from nnnoiseless_tpu_torch.ops import frame_kernel as fk
from nnnoiseless_tpu_torch.ops import pitch_kernel as pk
from nnnoiseless_tpu_torch.ops import window
from nnnoiseless_tpu_torch.ops.rnn import RnnState, rnn_step

ROOT = pathlib.Path(__file__).resolve().parent.parent

_PROBE = """
import contextlib
import io
import sys
import numpy as np
import nnnoiseless_tpu_torch as nt
from nnnoiseless_tpu_torch import audio_io, chunk, cli, flags, native, pipeline, signal
from nnnoiseless_tpu_torch.ops import frame_kernel as fk, pitch_kernel as pk, rnn_kernel as rk, window
from nnnoiseless_tpu_torch.tools import attrib, corr, datagen_bench, profile, trace
from nnnoiseless_tpu_torch.training import data, losses, network, train
assert "jax" not in sys.modules, "importing the port loaded jax"
raw = np.fromfile("tests/data/testing.raw", "<i2").astype(np.float32)[: 6 * 480]
for fused in (True, False):
    engine = nt.Engine(nt.RnnModel.default(), "cpu", fused=fused)
    out = nt.denoise_audio(raw, engine, device="cpu")
    assert out.shape == (5 * 480,) and np.isfinite(out).all()
out, vad = nt.DenoiseState(device="cpu").process_frame(raw[:480])
assert out.shape == (480,) and np.isfinite(out).all()
assert len(list(nt.DenoiseSignal(raw / 32768.0, latency_frames=2, device="cpu"))) == 5 * 480
assert cli.main(["tests/data/testing.raw", "/dev/null", "--device", "cpu"]) == 0
feats = np.random.RandomState(0).randn(2, 6, 42).astype(np.float32)
with contextlib.redirect_stdout(io.StringIO()):  # fit logs its first step
    params = train.fit(feats, np.full((2, 6, 22), 0.5, np.float32), np.ones((2, 6, 1), np.float32), epochs=1,
                       batch_size=2, device="cpu")
assert len(network.export_model(params).to_bytes()) == 87521
counts =(pk.launches, pk.stacked_launches, fk.launches, fk.cand_launches, rk.launches, window.launches)
assert counts == (0,) * 6, counts
assert "jax" not in sys.modules, "running the port loaded jax"
print("ok")
"""


def test_import_and_cpu_run_without_jax():
    res = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


_PARALLEL_PROBE = """
import sys
import numpy as np
import nnnoiseless_tpu_torch as nt
from nnnoiseless_tpu_torch import parallel
from nnnoiseless_tpu_torch.parallel import dryrun, mesh
m = parallel.make_mesh(["cpu", "cpu"])
model = nt.RnnModel.default()
frames = np.random.RandomState(0).randn(2, 2, 480).astype(np.float32) * 1000
carry, out, vad = parallel.sharded_process_frames(model, nt.init_batch_carry(model.meta, 2, "cpu"), frames, m)
assert out.shape == (2, 2, 480) and len(carry) == 2
loaded = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "nnnoiseless_tpu"))
assert not loaded, loaded
print("ok")
"""


def test_parallel_imports_neither_jax_nor_the_jax_package():
    """The split and the dry run import no jax and no module of
    nnnoiseless_tpu, and the split runs without them."""
    res = subprocess.run(
        [sys.executable, "-c", _PARALLEL_PROBE], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_wrappers_take_only_cpu_or_cuda():
    ds = torch.zeros((2, 864 + 240), device="meta")
    w0 = torch.zeros((1, 2), device="meta")
    with pytest.raises(ValueError):
        pk.pitch_analysis_stream(ds, w0, 1)
    carry = tuple(
        torch.zeros((2,) + shape, dtype=torch.int32 if n == "period" else torch.float32)
        for n, shape in fk.CARRY_SHAPES
    )
    with pytest.raises(ValueError):
        fk.frame_loop(None, carry, torch.zeros((1, 2, 480), device="meta"), torch.zeros((1, 2, 105), device="meta"))
    with pytest.raises(ValueError):
        pk.pitch_analysis_stacked(torch.zeros((2, 864), device="meta"))
    t385 = torch.zeros((2, 385), device="meta")
    with pytest.raises(ValueError):
        fk.candidates(t385, t385, torch.zeros(2, device="meta"), torch.zeros(2, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        window.window_at_lag(torch.zeros((2, 1728), device="meta"), torch.zeros(2, dtype=torch.int32, device="meta"))
    rnn = nt.Engine(nt.RnnModel.default(), "cpu").rnn
    state = RnnState(*(torch.zeros((2, n), device="meta") for n in (24, 48, 96)))
    with pytest.raises(ValueError):
        rnn_step(rnn, state, torch.zeros((2, 42), device="meta"))


def test_wrappers_check_shapes():
    with pytest.raises(ValueError):
        pk.pitch_analysis_stream(torch.zeros((2, 864)), torch.zeros((1, 2)), 1)  # too short
    with pytest.raises(ValueError):
        pk.pitch_analysis_stacked(torch.zeros((2, 863)))
    carry = tuple(torch.zeros((2,) + shape) for _, shape in fk.CARRY_SHAPES)
    with pytest.raises(TypeError):  # period must be int32
        fk.frame_loop(None, carry, torch.zeros((1, 2, 480)), torch.zeros((1, 2, 105)))
    with pytest.raises(ValueError):  # an unknown stage
        fk.frame_loop_plain(None, carry, torch.zeros((1, 2, 480)), torch.zeros((1, 2, 105)), skip=("bogus",))
    t385, r2 = torch.zeros((2, 385)), torch.zeros(2)
    with pytest.raises(ValueError):
        fk.candidates(t385, t385[:, :384], r2, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(TypeError):  # pidx must be int32
        fk.candidates(t385, t385, r2, torch.zeros(2, dtype=torch.int64))


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card(tmp_path, alone):
    """No CUDA device here: the script exits non-zero and prints no result;
    in a directory without the package it fails as well."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    script = ROOT / "chip_smoke.py"
    if alone:
        script = pathlib.Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    res = subprocess.run(
        [sys.executable, str(script)], cwd=script.parent, capture_output=True, text=True, timeout=300
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
