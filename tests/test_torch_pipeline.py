"""The port's per-frame path, lag-0 precompute and scan engine on the CPU
against the JAX package, on inputs made by numpy from a seed or cut from
tests/data/testing.raw.

Both sides run f32 on the CPU.  Where the two compute the same sums in
another order the bars are relative to the data's scale (stated per
test).  The JAX per-frame path takes its spectra through a two-stage
Cooley-Tukey DFT and the port through one dense basis, so the per-frame
comparison uses the reference's own cross-implementation bars: the
pitch-trace bar (tests/test_pitch_trace.py) and the golden metric.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnnoiseless_tpu import init_batch_carry as jax_init
from nnnoiseless_tpu import process_frames as jax_process_frames
from nnnoiseless_tpu.chunk import precompute_chunk as jax_precompute
from nnnoiseless_tpu.model import LayerMeta as JaxLayerMeta
from nnnoiseless_tpu.model import ModelMeta as JaxModelMeta
from nnnoiseless_tpu.model import RnnModel as JaxRnnModel
from nnnoiseless_tpu.ops.biquad import biquad_filter as jax_biquad
from nnnoiseless_tpu.ops.biquad import biquad_filter_dense as jax_biquad_dense
from nnnoiseless_tpu.ops.fft import forward_transform as jax_forward
from nnnoiseless_tpu.ops.fft import inverse_transform as jax_inverse
from nnnoiseless_tpu.ops.pitch import downsample_2x as jax_downsample
from nnnoiseless_tpu.pipeline import frame_step as jax_frame_step
from nnnoiseless_tpu.tables import BIQUAD_HP_A, BIQUAD_HP_B
from test_golden import relative_sq_error
from test_pitch_kernel import G_LANES, T_LANES

import nnnoiseless_tpu_torch as nt
from nnnoiseless_tpu_torch import flags
from nnnoiseless_tpu_torch.chunk import precompute_chunk
from nnnoiseless_tpu_torch.constants import FRAME_SIZE
from nnnoiseless_tpu_torch.model import LayerMeta, ModelMeta
from nnnoiseless_tpu_torch.ops import biquad, fft, pitch
from nnnoiseless_tpu_torch.pipeline import frame_step

T_CLIP = 100  # whole frames of the golden clip


def _golden_bars(out, reference_output):
    """tests/test_golden.py's bars, with the reference's truncating cast."""
    assert out.shape == reference_output.shape
    assert relative_sq_error(out, reference_output) < 1e-4
    delta = np.abs(reference_output.astype(np.int32) - out.astype(np.int16).astype(np.int32))
    assert delta.max() <= 2


@pytest.fixture(scope="module")
def engine():
    return nt.Engine(nt.RnnModel.default(), "cpu")


@pytest.fixture(scope="module")
def scan_engine():
    return nt.Engine(nt.RnnModel.default(), "cpu", fused=False)


@pytest.mark.parametrize("which", ["forward", "inverse"])
def test_transforms_match_jax(which):
    """f32 sums of 960 (962) products on both sides: within 1e-6 of the
    output's largest magnitude (measured 5e-7 forward, 4e-7 inverse)."""
    rng = np.random.RandomState(31)
    if which == "forward":
        x = (rng.randn(7, 960) * 1000).astype(np.float32)
        want = np.asarray(jax_forward(jnp.asarray(x))).reshape(7, 962)
        got = fft.forward_transform(torch.from_numpy(x)).numpy()
    else:
        x = (rng.randn(7, 962) * 100).astype(np.float32)
        want = np.asarray(jax_inverse(jnp.asarray(x.reshape(7, 2, 481))))
        got = fft.inverse_transform(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("which", ["scan", "dense"])
def test_biquads_match_jax(which):
    """The per-sample scan is the same f32 recurrence (equal to 1e-6 of
    the scale); the dense form sums the Toeplitz products in another order
    (within 1e-6 of the output's largest magnitude, measured 8e-8)."""
    rng = np.random.RandomState(32)
    x = (rng.randn(3, 480) * 2000).astype(np.float32)
    mem = (rng.randn(3, 2) * 10).astype(np.float32)
    if which == "scan":
        want = jax_biquad(jnp.asarray(x), jnp.asarray(mem), jnp.asarray(BIQUAD_HP_A), jnp.asarray(BIQUAD_HP_B))
        got = biquad.biquad_filter(torch.from_numpy(x), torch.from_numpy(mem), BIQUAD_HP_A, BIQUAD_HP_B)
    else:
        want = jax_biquad_dense(jnp.asarray(x), jnp.asarray(mem), tuple(BIQUAD_HP_A), tuple(BIQUAD_HP_B))
        got = biquad.biquad_filter_dense(torch.from_numpy(x), torch.from_numpy(mem), BIQUAD_HP_A, BIQUAD_HP_B)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max())


def test_downsample_matches_jax():
    """The same three f32 operations per sample: bit-exact."""
    x = (np.random.RandomState(33).randn(4, 1728) * 3000).astype(np.float32)
    want = np.stack([np.asarray(jax_downsample(jnp.asarray(r))) for r in x])
    np.testing.assert_array_equal(pitch.downsample_2x(torch.from_numpy(x)).numpy(), want)


@pytest.fixture(scope="module")
def lag0_pre(testing_raw):
    """precompute_chunk(lag0=True) of both packages at B=3, T=6 with a
    seeded history and biquad carry."""
    rng = np.random.RandomState(34)
    b, t = 3, 6
    frames = testing_raw[: b * t * FRAME_SIZE].reshape(b, t, FRAME_SIZE) * np.float32(1.3)
    mem = (rng.randn(b, 1728) * 500).astype(np.float32)
    hp = (rng.randn(b, 2) * 10).astype(np.float32)
    want, _ = jax.jit(jax_precompute, static_argnames="lag0")(
        jnp.asarray(mem), jnp.asarray(hp), jnp.asarray(frames), lag0=True
    )
    got, _ = precompute_chunk(*map(torch.from_numpy, (mem, hp, frames)), lag0=True)
    return got, want


@pytest.mark.parametrize("field", ["x", "ex", "silence", "ceps", "cand"])
def test_precompute_lag0_matches_jax(lag0_pre, field):
    """x and ex: f32 sums in another order, within 1e-6 of the largest
    magnitude (measured 1.3e-7 and 1.9e-7); silence exact; ceps (log10 of
    ex) within 1e-4 (measured 2.4e-6); cand: the decision lanes exact, the
    gain lanes within 1e-3 and every lane within 5e-3 of its row's scale
    (tests/test_pitch_kernel.py's bars)."""
    got, want = lag0_pre
    g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
    assert g.shape == w.shape
    if field in ("x", "ex"):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * np.abs(w).max())
    elif field == "silence":
        np.testing.assert_array_equal(g, w)
    elif field == "ceps":
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    else:
        np.testing.assert_array_equal(g[..., T_LANES], w[..., T_LANES])
        assert np.abs(g[..., G_LANES] - w[..., G_LANES]).max() < 1e-3
        assert (np.abs(g - w) / (np.abs(w).max(-1, keepdims=True) + 1.0)).max() < 5e-3


def test_frame_step_matches_jax(testing_raw, default_model, engine):
    """Two streams (the golden clip, and the clip shifted by 3 frames at
    0.6 gain) through 100 frame_step calls at B=2, against one jitted scan
    of the JAX frame_step.  Periods: the pitch-trace bar, at most 2 of 100
    frames off and those by at most 2 (measured: none off).  Output: the
    golden metric, rel < 1e-4 and at most 2 units per sample (measured
    6.9e-8 and 0.68).  vad within 5e-3 (measured 5e-4: the RNN carries the
    f32 differences of the two DFT formulations)."""
    clip = testing_raw[: T_CLIP * FRAME_SIZE]
    two = np.stack([clip, np.roll(clip, 3 * FRAME_SIZE) * np.float32(0.6)])
    two = two.reshape(2, T_CLIP, FRAME_SIZE)
    m = default_model

    @jax.jit
    def jax_run(carry, frames):
        def step(c, f):
            c2, o, v = jax.vmap(lambda ci, fi: jax_frame_step(m.params, m.meta, ci, fi))(c, f)
            return c2, (o, v, c2.feat.pitch_period)

        return jax.lax.scan(step, carry, jnp.swapaxes(frames, 0, 1))

    _, (out_j, vad_j, per_j) = jax_run(jax_init(m.meta, 2), jnp.asarray(two))
    carry = nt.init_batch_carry(engine.model.meta, 2, "cpu")
    outs, vads, pers = [], [], []
    for t in range(T_CLIP):
        carry, out, vad = frame_step(engine.rnn, carry, torch.from_numpy(two[:, t]))
        outs.append(out.numpy())
        vads.append(vad.numpy())
        pers.append(carry.feat.pitch_period.numpy())
    per_j = np.asarray(per_j)
    off = np.stack(pers) != per_j
    assert off.sum(0).max() <= 2
    assert np.abs(np.stack(pers) - per_j).max(initial=0, where=off) <= 2
    for s in range(2):
        got, want = np.stack(outs)[:, s].ravel(), np.asarray(out_j)[:, s].ravel()
        assert relative_sq_error(got, want) < 1e-4
        assert np.abs(got - want).max() <= 2
    np.testing.assert_allclose(np.stack(vads), np.asarray(vad_j), rtol=0, atol=5e-3)


@pytest.fixture(scope="module")
def scan_paths(testing_raw, default_model, scan_engine):
    """The port's scan engine and the JAX scan path (``_scan_batch``, where
    ``process_frames`` sends a batch on the CPU) on one chunk, B=4, T=8."""
    b, t = 4, 8
    frames = testing_raw[: b * t * FRAME_SIZE].reshape(b, t, FRAME_SIZE)
    ref = jax_process_frames(default_model, jax_init(default_model.meta, b), jnp.asarray(frames))
    carry = nt.init_batch_carry(scan_engine.model.meta, b, "cpu")
    return nt.scan_chunk(scan_engine, carry, torch.from_numpy(frames)), ref


def test_scan_chunk_output_matches_jax(scan_paths):
    """K2's bars (tests/test_torch_frame_kernel.py): output within 0.01
    i16 units, vad within 1e-5."""
    (_, out, vad), (_, out_j, vad_j) = scan_paths
    assert out.shape == (4, 8, FRAME_SIZE) and vad.shape == (4, 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=0.01, rtol=1e-5)
    np.testing.assert_allclose(vad.numpy(), np.asarray(vad_j), atol=1e-5)


def test_scan_chunk_carries_match_jax(scan_paths):
    """Periods exact; the history within 1e-6 of its scale (the two chunk
    biquads sum their f32 products in another order, measured 2.4e-4 on
    samples near 1e3); the rest within K2's bars."""
    (c, _, _), (c_j, _, _) = scan_paths
    np.testing.assert_array_equal(c.feat.pitch_period.numpy(), np.asarray(c_j.feat.pitch_period))
    mem_j = np.asarray(c_j.feat.input_mem)
    np.testing.assert_allclose(c.feat.input_mem.numpy(), mem_j, rtol=0, atol=1e-6 * np.abs(mem_j).max())
    np.testing.assert_allclose(c.feat.hp_mem.numpy(), np.asarray(c_j.feat.hp_mem), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(c.synthesis_mem.numpy(), np.asarray(c_j.synthesis_mem), atol=0.01)
    np.testing.assert_allclose(c.feat.cepstral_mem.numpy(), np.asarray(c_j.feat.cepstral_mem), atol=1e-5)
    for a, b in zip(c.rnn, c_j.rnn):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


@pytest.mark.parametrize("path", ["process_frame", "scan_engine"])
def test_golden(testing_raw, reference_output, engine, scan_engine, path):
    """The reference oracle through DenoiseState.process_frame (the
    per-frame path, one call per frame) and through the scan engine."""
    if path == "process_frame":
        state = nt.DenoiseState(engine)
        frames = testing_raw[: T_CLIP * FRAME_SIZE].reshape(T_CLIP, FRAME_SIZE)
        out = np.concatenate([state.process_frame(f)[0] for f in frames])[FRAME_SIZE:]
    else:
        assert not scan_engine.two_phase
        out = nt.denoise_audio(testing_raw, scan_engine)
    _golden_bars(out, reference_output)


def _custom_model(rng):
    """A valid model of non-standard topology (a 32-neuron vad GRU) with
    seeded int8-valued weights, as both packages' RnnModel."""
    layers = (
        ("input_dense", 42, 24, 0), ("vad_gru", 24, 32, 1), ("noise_gru", 42 + 24 + 32, 48, 2),
        ("denoise_gru", 42 + 32 + 48, 96, 2), ("denoise_output", 96, 22, 1), ("vad_output", 32, 1, 1),
    )
    params = {}
    for name, n_in, n, _ in layers:
        w = lambda *shape: rng.randint(-40, 41, size=shape).astype(np.float32)
        params[name] = (
            {"wi": w(n_in, 3 * n), "wr": w(n, 3 * n), "b": w(3 * n)}
            if name.endswith("gru")
            else {"w": w(n_in, n), "b": w(n)}
        )
    meta = ModelMeta(*(LayerMeta(n_in, n, a) for _, n_in, n, a in layers))
    jax_meta = JaxModelMeta(*(JaxLayerMeta(n_in, n, a) for _, n_in, n, a in layers))
    return nt.RnnModel(params, meta), JaxRnnModel(params, jax_meta)


def test_nonstandard_topology_takes_the_scan_engine(testing_raw):
    """A model the kernels K2 and K5 are not built for is served by the
    scan engine whatever NNT_FUSED says, as the JAX package serves it by
    its scan path, and matches JAX process_frames under K2's bars."""
    model, jax_model = _custom_model(np.random.RandomState(35))
    assert flags.FUSED  # the default: the two-phase engine where it can
    assert nt.Engine(nt.RnnModel.default(), "cpu").two_phase
    eng = nt.Engine(model, "cpu")
    assert not eng.two_phase and not eng.rnn.standard_topology()
    b, t = 2, 6
    frames = testing_raw[: b * t * FRAME_SIZE].reshape(b, t, FRAME_SIZE)
    carry, out, vad = nt.process_frames(eng, nt.init_batch_carry(model.meta, b, "cpu"), frames)
    c_j, out_j, vad_j = jax_process_frames(jax_model, jax_init(jax_model.meta, b), jnp.asarray(frames))
    assert carry.rnn.vad.shape == (b, 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=0.01, rtol=1e-5)
    np.testing.assert_allclose(vad.numpy(), np.asarray(vad_j), atol=1e-5)
    np.testing.assert_array_equal(carry.feat.pitch_period.numpy(), np.asarray(c_j.feat.pitch_period))
