"""The CUDA kernels against their plain versions on a card.

Marked ``cuda``; each test skips without a CUDA device.  On a machine with
a card (and without JAX) run::

    NNT_TEST_PLATFORM=cuda python -m pytest tests/test_torch_cuda.py -q

Bars: those of chip_smoke.py (pitch decisions may flip on near-ties, the
sums run in another order than cuDNN's; waveforms as tests/conftest.py's
accelerator bars).
"""

import numpy as np
import pytest
import torch

import nnnoiseless_tpu_torch as nt
from nnnoiseless_tpu_torch.chunk import decimate, precompute_chunk
from nnnoiseless_tpu_torch.ops import frame_kernel as fk
from nnnoiseless_tpu_torch.ops import pitch_kernel as pk

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def engine(device):
    return nt.Engine(nt.RnnModel.default(), device)


def _frames(b, t, seed):
    raw = np.fromfile("tests/data/testing.raw", "<i2").astype(np.float32)
    rng = np.random.RandomState(seed)
    starts = rng.randint(0, len(raw) - t * 480, b)
    gains = rng.uniform(0.3, 2.0, b).astype(np.float32)
    return np.stack([raw[s : s + t * 480] * g for s, g in zip(starts, gains)]).reshape(b, t, 480)


def test_pitch_kernel_matches_plain(device):
    b, t = 37, 6
    x = torch.as_tensor(_frames(b, t, 1), device=device).reshape(b, -1)
    full = torch.cat([torch.zeros((b, 1728), device=device), x], 1)
    ds, w0 = decimate(full, t)
    cand_k, pidx_k = pk.pitch_analysis_cuda(ds, w0, t)
    cand_p, pidx_p = pk.pitch_analysis_plain(ds, w0, t)
    torch.cuda.synchronize()
    differ = (pidx_k != pidx_p) | (cand_k[..., 0] != cand_p[..., 0])
    assert int(differ.sum()) <= max(1, differ.numel() // 100)
    assert int((pidx_k - pidx_p).abs().max()) <= 2
    rowscale = cand_p.abs().amax(-1, keepdim=True) + 1.0
    assert float(((cand_k - cand_p).abs() / rowscale)[~differ].max()) < 5e-3


def test_frame_kernel_matches_plain(device, engine):
    b, t = 13, 6  # a ragged second tile of streams
    frames = torch.as_tensor(_frames(b, t, 2), device=device)
    carry = nt.init_batch_carry(engine.model.meta, b, device)
    pre, _ = precompute_chunk(carry.feat.input_mem, carry.feat.hp_mem, frames)
    ca = fk.carry_arrays(carry)
    packed_k, carry_k = fk.frame_loop_cuda(engine.rnn, engine.weights, ca, pre.filtered, pre.cand)
    packed_p, carry_p = fk.frame_loop_plain(engine.rnn, ca, pre.filtered, pre.cand)
    d = (packed_k[..., :480] - packed_p[..., :480]).double().abs()
    assert float((d**2).sum() / (packed_p[..., :480].double() ** 2).sum()) < 1e-3
    assert float(d.max()) <= 64 and float((d > 16).double().mean()) <= 0.05
    assert float((packed_k[..., 481] == packed_p[..., 481]).double().mean()) >= 0.98
    assert bool((packed_k[..., 483:] == 0).all())
    torch.testing.assert_close(carry_k[0], carry_p[0], rtol=0, atol=0)  # history


def test_engine_golden_and_counts(device, engine):
    raw = np.fromfile("tests/data/testing.raw", "<i2").astype(np.float32)
    ref = np.fromfile("tests/data/reference_output.raw", "<i2").astype(np.float64)
    pk.launches = fk.launches = 0
    out = nt.denoise_audio(np.stack([raw, raw]), engine, device=device)
    assert pk.launches > 0 and fk.launches > 0
    for row in out:
        got = np.clip(np.rint(row.astype(np.float64)), -32768, 32767)
        assert np.sum((ref - got) ** 2) / np.sum(got**2) < 1e-4
        assert np.abs(ref - got).max() <= 2


def test_wrappers_refuse_bad_operands(device, engine):
    ds = torch.zeros((2, 864 + 240), device=device, dtype=torch.float64)
    with pytest.raises(TypeError):
        pk.pitch_analysis_stream(ds, torch.zeros((1, 2), device=device), 1)
    carry = fk.carry_arrays(nt.init_batch_carry(engine.model.meta, 2, device))
    filt = torch.zeros((1, 2, 960), device=device)[..., ::2]  # not contiguous
    with pytest.raises(ValueError):
        fk.frame_loop(engine.rnn, carry, filt, torch.zeros((1, 2, 105), device=device))
