"""The port's engine end to end on the CPU (the plain versions of both
kernels): the reference oracle over tests/data/testing.raw, chunking
invariance, and StreamBatch against the JAX scan path."""

import jax.numpy as jnp
import numpy as np
import pytest

from nnnoiseless_tpu import init_batch_carry as jax_init
from nnnoiseless_tpu.denoise import _scan_batch
from test_golden import relative_sq_error

import nnnoiseless_tpu_torch as nt
from nnnoiseless_tpu_torch.constants import FRAME_SIZE


@pytest.fixture(scope="module")
def engine():
    return nt.Engine(nt.RnnModel.default(), "cpu")


@pytest.fixture(scope="module")
def golden_out(testing_raw, engine):
    return nt.denoise_audio(testing_raw, engine, drop_first_frame=True)


def test_compare_to_reference(golden_out, reference_output):
    """tests/test_golden.py's bars: rel squared error < 1e-4 and at most 2
    i16 units per sample, with the reference's truncating i16 cast."""
    assert golden_out.shape == reference_output.shape
    assert relative_sq_error(golden_out, reference_output) < 1e-4
    delta = np.abs(reference_output.astype(np.int32) - golden_out.astype(np.int16).astype(np.int32))
    assert delta.max() <= 2


def test_internal_chunking_matches(testing_raw, engine):
    sig = testing_raw[: 20 * FRAME_SIZE]
    one = nt.denoise_audio(sig, engine, drop_first_frame=False, chunk_frames=10_000)
    small = nt.denoise_audio(sig, engine, drop_first_frame=False, chunk_frames=7)
    np.testing.assert_allclose(small, one, atol=1.0, rtol=1e-5)


def test_denoise_state_chunks_and_frames(testing_raw, engine):
    """DenoiseState's process_chunk / process_frame at B=1 reproduce the
    one-shot output, as tests/test_golden.py::test_chunked_equals_oneshot."""
    sig = testing_raw[: 20 * FRAME_SIZE]
    one = nt.denoise_audio(sig, engine, drop_first_frame=False)
    st = nt.DenoiseState(engine)
    frames = sig.reshape(20, FRAME_SIZE)
    parts = [st.process_chunk(frames[:7])[0].reshape(-1), st.process_chunk(frames[7:15])[0].reshape(-1)]
    for f in frames[15:]:
        out, vad = st.process_frame(f)
        assert out.shape == (FRAME_SIZE,) and 0.0 <= vad <= 1.0
        parts.append(out)
    np.testing.assert_allclose(np.concatenate(parts), one, atol=1.0, rtol=1e-5)


def test_stream_batch_matches_jax_scan(testing_raw, default_model, engine):
    """StreamBatch B=4, T=8 (the port's own precompute) against the JAX
    scan path under the frame-kernel bars."""
    b, t = 4, 8
    frames = testing_raw[: b * t * FRAME_SIZE].reshape(b, t, FRAME_SIZE)
    batch = nt.StreamBatch(b, engine)
    out, vad = batch.process(frames)
    c_j, out_j, vad_j = _scan_batch(
        default_model.params, default_model.meta, jax_init(default_model.meta, b), jnp.asarray(frames)
    )
    np.testing.assert_allclose(out, np.asarray(out_j), atol=0.01, rtol=1e-5)
    np.testing.assert_allclose(vad, np.asarray(vad_j), atol=1e-5)
    np.testing.assert_array_equal(
        batch.carry.feat.pitch_period.numpy(), np.asarray(c_j.feat.pitch_period)
    )
    np.testing.assert_allclose(batch.carry.feat.hp_mem.numpy(), np.asarray(c_j.feat.hp_mem), rtol=1e-5, atol=1e-3)
