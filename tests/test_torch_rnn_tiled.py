"""The register-tiled RNN stages of K5 and K2 on the CPU: the plain mirror
of their summing order (ops/rnn_kernel.py::rnn_step_staged) against the
JAX rnn_step and the Pallas RNN kernel in interpret mode, at both of K5's
tiles, and K2's tile in input order; the tiled weight layout (pack_tiled)
against the layer-order buffer (pack_weights); and denoise_audio's
one-chunk-at-a-time upload.

Bar: 2e-5 absolute, as tests/test_torch_rnn_kernel.py states it: the sums
run in another order than the JAX package's (lanes of k, then halving);
at one stream a block each sum is split over lanes; at 32 streams a
block the kernel sums in the plain version's order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnnoiseless_tpu.ops import rnn_pallas as rp
from nnnoiseless_tpu.ops.rnn import RnnState as JaxState, rnn_step as jax_rnn_step

import nnnoiseless_tpu_torch as nt
from nnnoiseless_tpu_torch import denoise
from nnnoiseless_tpu_torch.model import RnnModel
from nnnoiseless_tpu_torch.ops import rnn_kernel as rk
from nnnoiseless_tpu_torch.ops.rnn import Rnn

B = 3 * rp._BLOCK  # 1536, three Pallas blocks; smaller batches take the first rows
ATOL = 2e-5
OUTPUTS = ("vad", "noise", "denoise", "gains", "vad_prob")


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(13)  # test_torch_rnn_kernel.py's inputs
    state = (
        (rng.randn(B, 24) * 0.5).astype(np.float32),
        np.maximum(rng.randn(B, 48), 0).astype(np.float32),
        (rng.randn(B, 96) * 0.5).astype(np.float32),
    )
    return state, (rng.randn(B, 42) * 2).astype(np.float32)


@pytest.fixture(scope="module")
def want(inputs, default_model):
    state, feats = inputs
    m = default_model
    pallas = rp._rnn_pallas(
        rp._flatten_params(m.params), *map(jnp.asarray, state), jnp.asarray(feats),
        rp.meta_acts(m.meta), interpret=True,
    )
    st, gains, vad = jax_rnn_step(m.params, m.meta, JaxState(*map(jnp.asarray, state)), jnp.asarray(feats))
    return {
        "pallas": [np.asarray(a) for a in (*pallas[:4], pallas[4][:, 0])],
        "jax": [np.asarray(a) for a in (*st, gains, vad)],
    }


@pytest.mark.parametrize("against", ["pallas", "jax"])
@pytest.mark.parametrize("b", [1, 37, 1536])  # one stream a block (B <= 1024), and 32 a block
def test_staged_matches(inputs, want, default_model, b, against):
    state, feats = inputs
    rnn = Rnn.from_params(default_model.params, default_model.meta, "cpu")
    got = rk.rnn_step_staged(rnn, tuple(torch.from_numpy(s[:b]) for s in state), torch.from_numpy(feats[:b]))
    for name, g, w in zip(OUTPUTS, got, want[against]):
        assert g.shape == w[:b].shape
        np.testing.assert_allclose(g.numpy(), w[:b], atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("b", [8, 13, 1536])  # one of K2's 8-stream tiles, a ragged second, many
def test_frame_tile_sums_in_input_order(inputs, want, default_model, b):
    """K2's RNN tile (FRAME_TILE, csrc/frame_kernel.cuh): every stage sums
    in one lane, so a GRU's input sum over its runs of rows in turn
    (rnn_tile.cuh::tile_sums) is one sum in input order, bit-equal to the
    mirror's sum over their concatenation; the mirror at that tile within
    the bar of the JAX rnn_step."""
    assert [rk.lanes(q, rk.FRAME_TILE) for q in (6, 18, 36, 12, 72, 24, 1)] == [1] * 7
    state, feats = inputs
    rnn = Rnn.from_params(default_model.params, default_model.meta, "cpu")
    st, f = tuple(torch.from_numpy(s[:b]) for s in state), torch.from_numpy(feats[:b])
    hv, hn, hd = st
    for layer, runs in (("noise_gru", (hd[:, :24], hv, f)), ("denoise_gru", (hv, hn, f))):
        wi = getattr(rnn, layer).wi
        acc, k0 = torch.zeros((b, wi.shape[1])), 0
        for x in runs:  # one fmaf a step, rounded once, run after run
            for k in range(x.shape[1]):
                acc = (acc.double() + x[:, k, None].double() * wi[k0 + k].double()).float()
            k0 += x.shape[1]
        assert torch.equal(acc, rk._tile_sum(torch.cat(runs, 1), wi, rk.lanes(wi.shape[1] // 4, rk.FRAME_TILE))), layer
    got = rk.rnn_step_staged(rnn, st, f, tile=rk.FRAME_TILE)
    for name, g, w in zip(OUTPUTS, got, want["jax"]):
        np.testing.assert_allclose(g.numpy(), w[:b], atol=ATOL, rtol=0, err_msg=name)


def test_tiles_and_lanes():
    """The tile a batch takes and the lanes of each stage, as
    csrc/rnn_kernel.cu and rnn_tile.cuh choose them."""
    assert rk.tile_for(1) == rk.tile_for(rk.SMALL_B) == (1, 1, 576)
    assert rk.tile_for(rk.SMALL_B + 1) == rk.tile_for(4096) == (32, 8, 576)
    # output quads of the stages: dense 6, vad GRU 18 and 6, noise 36 and
    # 12, denoise 72 and 24, the vad head 1
    assert [rk.lanes(q, rk.tile_for(1)) for q in (6, 18, 36, 12, 72, 24, 1)] == [32, 32, 16, 32, 8, 16, 32]
    assert [rk.lanes(q, rk.tile_for(4096)) for q in (6, 18, 36, 12, 72, 24, 1)] == [1] * 7


def test_pack_tiled_round_trip():
    """Every weight of pack_weights' buffer at its place in the tiled
    layout, exactly; zeros in the padding; chunks 16-byte aligned; a
    weight that is not an int8 value raises."""
    model = RnnModel.default()
    rnn = Rnn.from_params(model.params, model.meta, "cpu")
    flat, woff, acts = rk.pack_weights(rnn, torch.device("cpu"))
    tiled, acts_t = rk.pack_tiled(rnn, torch.device("cpu"))
    assert tiled.dtype == torch.int8 and tiled.shape == (rk.TILED_BYTES,) == (87808,)
    assert torch.equal(acts_t, acts)
    assert rk.TILED_CHUNKS == (0, 1040, 4576, 4688, 24704, 85472)
    where = dict(zip(rk._WEIGHT_ORDER, woff.tolist()))
    used = torch.zeros(rk.TILED_BYTES, dtype=torch.bool)
    back = []
    for layer, name, off, rows, cols, pad in rk.TILED:
        block = tiled[off : off + rows * pad].view(rows, pad)
        used[off : off + rows * pad].view(rows, pad)[:, :cols] = True
        back.append(((layer, name), block[:, :cols].reshape(-1)))
    back = dict(back)
    assert torch.equal(torch.cat([back[key] for key in rk._WEIGHT_ORDER]), flat)
    assert not tiled[~used].any()
    for (layer, name), off in where.items():
        ref = model.params[layer][name].reshape(-1)
        np.testing.assert_array_equal(back[layer, name].numpy().astype(np.float32), ref)
    rnn.denoise_gru.wr[0, 0] = 0.25
    with pytest.raises(ValueError):
        rk.pack_tiled(rnn, torch.device("cpu"))


def test_denoise_audio_uploads_one_chunk(monkeypatch):
    """denoise_audio hands process_frames host frames, at most chunk_frames
    of them a call; its output is bit-identical to process_frames run
    chunk by chunk on the whole signal held as one tensor (as before the
    upload moved into the loop), and within tests/test_golden.py's
    chunking tolerance of a single call (another T rounds the chunk's
    biquad product differently)."""
    rng = np.random.RandomState(23)
    audio = (rng.randn(2, 25 * 480 + 100) * 3000).astype(np.float32)
    engine = nt.Engine(nt.RnnModel.default(), "cpu")
    seen = []
    inner = denoise.process_frames

    def spy(model, carry, frames, device=None):
        seen.append((type(frames), frames.shape))
        return inner(model, carry, frames, device)

    monkeypatch.setattr(denoise, "process_frames", spy)
    chunked = nt.denoise_audio(audio, engine, chunk_frames=10, device="cpu")
    assert seen == [(np.ndarray, (2, 10, 480))] * 2 + [(np.ndarray, (2, 5, 480))]
    seen.clear()
    whole = nt.denoise_audio(audio, engine, chunk_frames=25, device="cpu")
    assert seen == [(np.ndarray, (2, 25, 480))]
    assert chunked.shape == (2, 24 * 480)
    np.testing.assert_allclose(chunked, whole, atol=1.0, rtol=1e-5)
    frames = torch.as_tensor(audio[:, : 25 * 480].reshape(2, 25, 480))
    carry = nt.init_batch_carry(engine.model.meta, 2, "cpu")
    parts = []
    for start in range(0, 25, 10):
        carry, out, _ = inner(engine, carry, frames[:, start : start + 10])
        parts.append(out.numpy())
    np.testing.assert_array_equal(chunked, np.concatenate(parts, 1).reshape(2, -1)[:, 480:])
