"""The CUDA kernels against their plain versions on a card.

Marked ``cuda``; each test skips without a CUDA device.  On a machine with
a card (and without JAX) run::

    NNT_TEST_PLATFORM=cuda python -m pytest tests/test_torch_cuda.py -q

Bars: those of chip_smoke.py (pitch decisions may flip on near-ties, the
sums run in another order than cuDNN's; waveforms as tests/conftest.py's
accelerator bars; the RNN cell within 2e-5, the window bit-exact, denoise_audio's peak
device memory bounded by a chunk; the
candidate lanes' lags exact and their values within 1e-5 relative; K2's
FFT probe within 1e-5 of the row scale of float64 torch.fft).
"""

import numpy as np
import pytest
import torch

import nnnoiseless_tpu_torch as nt
from nnnoiseless_tpu_torch.chunk import decimate, precompute_chunk
from nnnoiseless_tpu_torch.ops import fft
from nnnoiseless_tpu_torch.ops import frame_kernel as fk
from nnnoiseless_tpu_torch.ops import pitch_kernel as pk
from nnnoiseless_tpu_torch.ops import rnn_kernel as rk
from nnnoiseless_tpu_torch.ops import window as wk
from nnnoiseless_tpu_torch.ops.pitch import downsample_2x, pitch_chain
from nnnoiseless_tpu_torch.ops.rnn import RnnState

pytestmark = pytest.mark.cuda

T_LANES = [0] + list(range(4, 18))  # candidate lanes holding lags


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


def _pitch_inputs(device, b, t, seed):
    x = torch.as_tensor(_frames(b, t, seed), device=device).reshape(b, -1)
    return decimate(torch.cat([torch.zeros((b, 1728), device=device), x], 1), t)


def _assert_pitch_bars(kern, plain, lag_lanes=True):
    """chip_smoke.py phase 3's bars: at most 1% of the windows differ in
    pidx or (``lag_lanes``) the t-lanes, no pidx step over 2, the other
    windows within 5e-3 of the row scale."""
    (ck, pk_), (cp, pp) = kern, plain
    ck, cp, pk_, pp = ck.reshape(-1, 105), cp.reshape(-1, 105), pk_.reshape(-1), pp.reshape(-1)
    differ = pk_ != pp
    if lag_lanes:
        differ |= (ck[:, T_LANES] != cp[:, T_LANES]).any(-1)
    assert int(differ.sum()) <= differ.numel() // 100
    assert int((pk_ - pp).abs().max()) <= 2
    rowscale = cp.abs().amax(-1, keepdim=True) + 1.0
    assert float(((ck - cp).abs() / rowscale)[~differ].max()) < 5e-3


def test_pitch_kernel_fills_the_card(device):
    """K1 at B=512, T=20: 10,240 blocks over every SM, several rounds."""
    ds, w0 = _pitch_inputs(device, 512, 20, 9)
    pk.launches = 0
    got = pk.pitch_analysis_stream(ds, w0, 20)
    assert pk.launches == 1
    _assert_pitch_bars(got, pk.pitch_analysis_plain(ds, w0, 20))


def test_pitch_kernel_skip_none_is_production(device):
    ds, w0 = _pitch_inputs(device, 37, 6, 10)
    prod = pk.pitch_analysis_cuda(ds, w0, 6)
    none = pk.pitch_analysis_cuda(ds, w0, 6, skip=())
    assert all(torch.equal(a, b) for a, b in zip(prod, none))


@pytest.mark.parametrize("stage", pk.SKIP_STAGES)
def test_pitch_kernel_skip_matches_plain(device, stage):
    """Each stub of K1 launches and meets phase 3's bars against the plain
    version's stub (with the walk stubbed every lane is xx: no lag lanes)."""
    ds, w0 = _pitch_inputs(device, 37, 6, 10)
    pk.launches = 0
    got = pk.pitch_analysis_stream(ds, w0, 6, skip=(stage,))
    assert pk.launches == 1
    _assert_pitch_bars(got, pk.pitch_analysis_plain(ds, w0, 6, skip=(stage,)), lag_lanes=stage != "cand")


def test_frame_kernel_matches_plain(device, engine):
    b, t = 13, 6  # a ragged second tile of streams
    frames = torch.as_tensor(_frames(b, t, 2), device=device)
    carry = nt.init_batch_carry(engine.model.meta, b, device)
    pre, _ = precompute_chunk(carry.feat.input_mem, carry.feat.hp_mem, frames)
    ca = fk.carry_arrays(carry)
    packed_k, carry_k = fk.frame_loop_cuda(engine.rnn, engine.rnn_weights, ca, pre.filtered, pre.cand)
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


def _golden(out):
    ref = np.fromfile("tests/data/reference_output.raw", "<i2").astype(np.float64)
    got = np.clip(np.rint(out.astype(np.float64)), -32768, 32767)
    assert np.sum((ref - got) ** 2) / np.sum(got**2) < 1e-4
    assert np.abs(ref - got).max() <= 2


def _reset_counts():
    pk.launches = pk.stacked_launches = fk.launches = rk.launches = wk.launches = 0


@pytest.mark.parametrize("b", [37, 1])  # a ragged shape, and the per-frame shape
def test_stacked_pitch_kernel_matches_plain(device, b):
    x = torch.as_tensor(_frames(b, 4, 3), device=device).reshape(b, -1)[:, :1728]
    wins = downsample_2x(x)
    cand_k, pidx_k = pk.pitch_analysis_stacked(wins)
    cand_p, pidx_p = pitch_chain(wins)
    differ = (pidx_k != pidx_p) | (cand_k[..., 0] != cand_p[..., 0])
    assert int(differ.sum()) <= max(1, differ.numel() // 100)
    assert int((pidx_k - pidx_p).abs().max()) <= 2
    rowscale = cand_p.abs().amax(-1, keepdim=True) + 1.0
    if bool((~differ).any()):
        assert float(((cand_k - cand_p).abs() / rowscale)[~differ].max()) < 5e-3


def _rnn_inputs(device, b):
    rng = np.random.RandomState(4)
    hv, hn, hd, f = (
        torch.as_tensor((rng.randn(b, n) * sc).astype(np.float32), device=device)
        for n, sc in ((24, 0.5), (48, 0.5), (96, 0.5), (42, 2.0))
    )
    return hv, hn.clamp(min=0), hd, f


# one stream a block (B <= 1024: 1, 2, 37) and 32 a block (1061, whose
# last block holds 5 streams, and 4096)
@pytest.mark.parametrize("b", [1, 2, 37, 1061, 4096])
def test_rnn_kernel_matches_plain(device, engine, b):
    hv, hn, hd, f = _rnn_inputs(device, b)
    rk.launches = 0
    got = rk.rnn_step_cuda(engine.rnn_weights, hv, hn, hd, f)
    assert rk.launches == 1
    st, gains, vad = engine.rnn(RnnState(hv, hn, hd), f)
    for a, w in zip(got, (*st, gains, vad)):
        assert a.shape == w.shape
        torch.testing.assert_close(a, w, rtol=0, atol=2e-5)


@pytest.mark.parametrize("b", [1, 37, 1061])
def test_rnn_kernel_matches_its_mirror(device, engine, b):
    """rnn_step_staged sums as the kernel does at each tile and rounds
    each multiply-add once, as fmaf does: bit-exact."""
    hv, hn, hd, f = _rnn_inputs(device, b)
    got = rk.rnn_step_cuda(engine.rnn_weights, hv, hn, hd, f)
    want = rk.rnn_step_staged(engine.rnn, (hv, hn, hd), f)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        torch.testing.assert_close(a, w, rtol=0, atol=0)


@pytest.mark.parametrize("b", [1, 7, 4096])
def test_window_kernel_matches_plain(device, b):
    """Bit-exact on lags 0 and 768, above 768 (zero fill), above 1023 and
    negative (taken modulo 1024), and each value of start & 3."""
    rng = np.random.RandomState(5)
    mem = torch.as_tensor((rng.randn(b, 1728) * 1000).astype(np.float32), device=device)
    lag = rng.randint(-3000, 3000, size=b).astype(np.int32)
    lag[:7] = [0, 768, 1023, 769, 5, -6, 2047][:b]  # start & 3: 0, 0, 1, 3, 3, 2, 1
    lag = torch.as_tensor(lag, device=device)
    if b == 4096:
        assert set(((768 - (lag & 1023)) & 3).tolist()) == {0, 1, 2, 3}
    wk.launches = 0
    got = wk.window_cuda(mem, lag)
    assert wk.launches == 1
    torch.testing.assert_close(got, wk.barrel_shift_window(mem, lag), rtol=0, atol=0)


def test_denoise_audio_device_memory(device, engine):
    """denoise_audio uploads one chunk at a time: the peak device memory of
    a 10-minute signal stays within 2 MB of a 2-chunk signal's (the whole
    10-minute signal is 115 MB)."""
    rng = np.random.RandomState(9)
    peaks = []
    for seconds in (20, 600):
        audio = (rng.randn(seconds * 48000) * 1000).astype(np.float32)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        out = nt.denoise_audio(audio, engine, device=device)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated(device) - base)
        assert out.shape == (seconds * 48000 - 480,) and np.isfinite(out).all()
    assert peaks[1] <= peaks[0] + 2 * 2**20, peaks


def test_per_frame_golden_and_counts(device):
    raw = np.fromfile("tests/data/testing.raw", "<i2").astype(np.float32)
    state = nt.DenoiseState(device=device)
    _reset_counts()
    out = np.concatenate([state.process_frame(f)[0] for f in raw[: 100 * 480].reshape(100, 480)])
    # one replay a call of the captured step; the warm-up step before the
    # capture launches each kernel once more
    prog = state.program.program
    assert prog.replays == 100 and prog.warmups == 1
    assert pk.stacked_launches == rk.launches == wk.launches == 101
    assert pk.launches == fk.launches == 0
    _golden(out[480:])


def test_scan_engine_golden_and_counts(device):
    raw = np.fromfile("tests/data/testing.raw", "<i2").astype(np.float32)
    engine = nt.Engine(nt.RnnModel.default(), device, fused=False)
    _reset_counts()
    out = nt.denoise_audio(raw, engine, device=device)
    assert pk.launches > 0 and rk.launches > 0 and wk.launches > 0
    assert fk.launches == pk.stacked_launches == 0
    _golden(out)


def test_wrappers_refuse_bad_operands(device, engine):
    ds = torch.zeros((2, 864 + 240), device=device, dtype=torch.float64)
    with pytest.raises(TypeError):
        pk.pitch_analysis_stream(ds, torch.zeros((1, 2), device=device), 1)
    carry = fk.carry_arrays(nt.init_batch_carry(engine.model.meta, 2, device))
    filt = torch.zeros((1, 2, 960), device=device)[..., ::2]  # not contiguous
    with pytest.raises(ValueError):
        fk.frame_loop(engine.rnn, carry, filt, torch.zeros((1, 2, 105), device=device))
    with pytest.raises(ValueError):
        pk.pitch_analysis_stacked(torch.zeros((2, 1728), device=device)[:, ::2])  # not contiguous
    with pytest.raises(TypeError):
        wk.window_at_lag(torch.zeros((2, 1728), device=device), torch.zeros(2, dtype=torch.int64, device=device))
    state = torch.zeros((2, 24), device=device)
    with pytest.raises(ValueError):
        rk.rnn_step_cuda(engine.rnn_weights, state, state, state, torch.zeros((2, 42), device=device))
    old = rk.pack_weights(engine.rnn, device)  # the layer-order buffer is neither kernel's layout
    with pytest.raises(ValueError):
        rk.rnn_step_cuda(old[0::2], *(torch.zeros((2, n), device=device) for n in (24, 48, 96, 42)))
    filt = torch.zeros((1, 2, 480), device=device)
    for weights in (old, old[0::2]):
        with pytest.raises(ValueError):
            fk.frame_loop_cuda(engine.rnn, weights, carry, filt, torch.zeros((1, 2, 105), device=device))
    with pytest.raises(ValueError):  # float4 reads need a 16-byte aligned history
        wk.window_cuda(torch.zeros(2 * 1728 + 1, device=device)[1:].view(2, 1728),
                       torch.zeros(2, dtype=torch.int32, device=device))


# rows: one, a row short of a 16-row block, one block, one row over, and
# ragged larger counts; pitch indices over the search's range, or over
# [0, 768) with 0-19 first, whose lookups fall off the tables (they read 0)
@pytest.mark.parametrize("pidx_kind", ["search", "drawn"])
@pytest.mark.parametrize("r", [1, 15, 16, 17, 300, 4097])
def test_candidate_kernel_matches_plain(device, r, pidx_kind):
    """K4 on seeded tables: lag lanes exact, every lane within 1e-5
    relative, one launch."""
    rng = np.random.RandomState(6)
    corr = torch.as_tensor((rng.randn(r, 385) * 1e3).astype(np.float32), device=device)
    yy = torch.as_tensor(np.abs(rng.randn(r, 385) * 1e4).astype(np.float32), device=device)
    xx = torch.as_tensor(np.abs(rng.randn(r) * 1e4).astype(np.float32), device=device)
    if pidx_kind == "search":
        pidx = rng.randint(181, 768, size=r)
    else:
        pidx = rng.randint(0, 768, size=r)
        pidx[:20] = np.arange(20)[:r]
    pidx = torch.as_tensor(pidx.astype(np.int32), device=device)
    fk.cand_launches = 0
    got = fk.candidates(corr, yy, xx, pidx)
    want = fk.candidates_plain(corr, yy, xx, pidx)
    assert fk.cand_launches == 1
    torch.testing.assert_close(got[:, T_LANES], want[:, T_LANES], rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


def _skip_inputs(device, engine):
    # the clip at 1/4096: the lag0 stub's cepstra are band energies, which
    # at full scale drive the relu GRU states to ~1e16 (ill-conditioned)
    b, t = 13, 6
    frames = torch.as_tensor(_frames(b, t, 7) / 4096.0, device=device)
    carry = nt.init_batch_carry(engine.model.meta, b, device)
    pre, _ = precompute_chunk(carry.feat.input_mem, carry.feat.hp_mem, frames)
    return fk.carry_arrays(carry), pre


def test_frame_kernel_skip_none_is_production(device, engine):
    ca, pre = _skip_inputs(device, engine)
    prod = fk.frame_loop_cuda(engine.rnn, engine.rnn_weights, ca, pre.filtered, pre.cand)
    none = fk.frame_loop_cuda(engine.rnn, engine.rnn_weights, ca, pre.filtered, pre.cand, skip=())
    for a, b in zip((prod[0], *prod[1]), (none[0], *none[1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("stage", ["rd", "lag0", "dft", "feat", "rnn", "comb", "inv"])
def test_frame_kernel_skip_matches_plain(device, engine, stage):
    """Each stub of K2 launches, gives finite output and meets the
    waveform bars against the plain version's stub."""
    ca, pre = _skip_inputs(device, engine)
    fk.launches = 0
    packed_k, carry_k = fk.frame_loop(engine.rnn, ca, pre.filtered, pre.cand, engine.rnn_weights, skip=(stage,))
    assert fk.launches == 1
    packed_p, carry_p = fk.frame_loop_plain(engine.rnn, ca, pre.filtered, pre.cand, skip=(stage,))
    assert bool(torch.isfinite(packed_k).all())
    d = (packed_k[..., :480] - packed_p[..., :480]).double().abs()
    assert float((d**2).sum() / (packed_p[..., :480].double() ** 2).sum()) < 1e-3
    assert float((packed_k[..., 481] == packed_p[..., 481]).double().mean()) >= 0.98
    other = "rd" if stage == "inv" else "inv"
    with pytest.raises(ValueError):  # the kernel stubs one stage at a time
        fk.frame_loop(engine.rnn, ca, pre.filtered, pre.cand, engine.rnn_weights, skip=(stage, other))


def test_fft_probe_matches_float64(device):
    """K2's FFT alone: forward on seeded i16-scale windows and inverse on
    their spectra, each within 1e-5 of the row scale of torch.fft in
    float64, the im of bins 0 and 480 read as 0."""
    rng = np.random.RandomState(8)
    x = torch.as_tensor(np.clip(rng.randn(300, 960) * 6000, -32768, 32767).astype(np.float32), device=device)
    win = torch.as_tensor(fft.VORBIS_WINDOW, dtype=torch.float64, device=device)
    spec = torch.fft.rfft(x.double() * win, dim=1) * float(fft.WNORM)
    want = torch.cat([spec.real, spec.imag], 1)
    fft.launches = 0
    got = fft.rfft960(x)
    assert fft.launches == 1
    assert bool(((got.double() - want).abs() <= 1e-5 * want.abs().amax(1, keepdim=True)).all())
    packed = want.float()
    spec = torch.complex(packed[:, :481].double(), packed[:, 481:].double())
    spec[:, 0].imag.zero_()
    spec[:, 480].imag.zero_()
    want_y = torch.fft.irfft(spec, 960, dim=1) * 480.0 * win
    got_y = fft.irfft960(packed)
    assert bool(((got_y.double() - want_y).abs() <= 1e-5 * want_y.abs().amax(1, keepdim=True)).all())
    with pytest.raises(ValueError):
        fft.rfft960(torch.zeros((2, 1920), device=device)[:, ::2])  # not contiguous
