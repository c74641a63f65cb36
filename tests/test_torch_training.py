"""The port's trainer (nnnoiseless_tpu_torch/training/) against the JAX
package's on the CPU: the float network, its gradient, the losses, Adam
steps under both learning-rate schedules, the int8 export, the init, the
sample weights, HDF5 loading, checkpoints and the device defaults.

Inputs are made with numpy from a seed and handed to both packages.  Each
tolerance has the largest error measured on the CPU beside it.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nnnoiseless_tpu_torch as nt
from nnnoiseless_tpu.training import losses as JL
from nnnoiseless_tpu.training import network as JN
from nnnoiseless_tpu.training import train as JT
from nnnoiseless_tpu_torch.constants import NB_BANDS, NB_FEATURES
from nnnoiseless_tpu_torch.model import params_from_numpy
from nnnoiseless_tpu_torch.training import data as TD
from nnnoiseless_tpu_torch.training import losses as TL
from nnnoiseless_tpu_torch.training import network as TN
from nnnoiseless_tpu_torch.training import train as TT

B, T = 4, 60


def _params(seed: int) -> dict:
    """Float params in the JAX layout, drawn with numpy within the clip."""
    rng = np.random.RandomState(seed)
    out = {}
    for layer in nt.model.LAYERS:
        m = getattr(TN.DEFAULT_META, layer)
        shapes = TN._layer_shapes(layer, m)
        out[layer] = {k: rng.uniform(-0.3, 0.3, s).astype(np.float32) for k, s in shapes.items()}
    return out


def _model(params: dict) -> TN.TrainableModel:
    model = TN.TrainableModel()
    model.load_state_dict(params_from_numpy(params, "cpu"))
    return model


def _batch(seed: int, b: int = B, t: int = T) -> dict:
    """Features, gains with -1 sentinels, vad with 0.5 labels, weights."""
    rng = np.random.RandomState(seed)
    gains = rng.rand(b, t, NB_BANDS).astype(np.float32)
    gains[rng.rand(b, t, NB_BANDS) < 0.2] = -1.0
    vad = (rng.rand(b, t, 1) > 0.5).astype(np.float32)
    vad[rng.rand(b, t, 1) < 0.2] = 0.5
    return {
        "features": rng.randn(b, t, NB_FEATURES).astype(np.float32),
        "gains": gains,
        "vad": vad,
        "sample_weight": rng.rand(b, t).astype(np.float32),
    }


def _torch(batch: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_forward_matches_jax():
    p, x = _params(0), _batch(1)["features"]
    jg, jv = JN.sequence_forward(p, jnp.asarray(x))
    with torch.no_grad():
        tg, tv = TN.sequence_forward(_model(p), torch.as_tensor(x))
    assert tg.shape == (B, T, NB_BANDS) and tv.shape == (B, T, 1)
    # measured 2.7e-7 (gains), 6.0e-8 (vad)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)


def test_gradient_matches_jax():
    p, bt = _params(2), _batch(3)
    bj = _jax(bt)

    def loss_fn(pp):
        g, v = JN.sequence_forward(pp, bj["features"])
        return JL.total_loss(bj["gains"], g, bj["vad"], v, bj["sample_weight"]) + JL.l2_regularization(pp)

    want = jax.grad(loss_fn)(p)
    model, bb = _model(p), _torch(bt)
    g, v = TN.sequence_forward(model, bb["features"])
    (TL.total_loss(bb["gains"], g, bb["vad"], v, bb["sample_weight"]) + TL.l2_regularization(model)).backward()
    for layer, leaves in want.items():
        for name, w in leaves.items():
            # measured at most 4.5e-8 absolute, 1.4% of this bar
            np.testing.assert_allclose(getattr(model, layer)[name].grad.numpy(), np.asarray(w),
                                       rtol=1e-4, atol=1e-6, err_msg=f"{layer}.{name}")


@pytest.mark.parametrize("name", ["gain_loss", "vad_loss", "msse", "total_loss", "total_loss_weighted",
                                  "l2_regularization"])
def test_loss_matches_jax(name):
    bt = _batch(4)
    rng = np.random.RandomState(5)
    pred_g = rng.rand(B, T, NB_BANDS).astype(np.float32)
    pred_v = rng.rand(B, T, 1).astype(np.float32)
    pred_g[0, 0, :3] = [0.0, 1.0, 1e-9]  # the BCE clip at both ends
    args = {
        "gain_loss": lambda L, c: L.gain_loss(c(bt["gains"]), c(pred_g)),
        "vad_loss": lambda L, c: L.vad_loss(c(bt["vad"]), c(pred_v)),
        "msse": lambda L, c: L.msse(c(bt["gains"]), c(pred_g)),
        "total_loss": lambda L, c: L.total_loss(c(bt["gains"]), c(pred_g), c(bt["vad"]), c(pred_v)),
        "total_loss_weighted": lambda L, c: L.total_loss(c(bt["gains"]), c(pred_g), c(bt["vad"]), c(pred_v),
                                                         c(bt["sample_weight"])),
    }
    if name == "l2_regularization":
        p = _params(6)
        want, got = JL.l2_regularization(p), TL.l2_regularization(_model(p)).detach()
    else:
        want, got = args[name](JL, jnp.asarray), args[name](TL, torch.as_tensor)
    assert got.shape == want.shape
    # measured at most 4.8e-7 (the total of 240 steps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("schedule", [None, "cosine"])
def test_train_steps_match_jax(schedule):
    p, bt = _params(7), _batch(8)
    if schedule is None:
        opt_j = JT.make_optimizer(1e-3)
    else:
        opt_j = JT.make_optimizer(optax.cosine_decay_schedule(1e-3, 5))
    state = JT.TrainState(jax.tree_util.tree_map(jnp.asarray, p), opt_j.init(p), jnp.int32(0))
    model = _model(p)
    opt_t = TT.make_optimizer(model, 1e-3, None if schedule is None else 5)
    bj, bb = _jax(bt), _torch(bt)
    batch_j = {k: bj[k] for k in ("features", "gains", "vad")}
    for _ in range(3):
        state, loss_j = JT.train_step(state, batch_j, bj["sample_weight"], JN.DEFAULT_META, opt_j)
        loss_t = TT.train_step(model, opt_t, bb, bb["sample_weight"])
        # measured at most 1.5e-6 relative (cosine)
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    got = TN.numpy_params(model)
    for layer, leaves in jax.device_get(state.params).items():
        for name, w in leaves.items():
            # measured at most 5.5e-7 absolute, 3.7% of this bar
            np.testing.assert_allclose(got[layer][name], w, rtol=1e-4, atol=1e-5, err_msg=f"{layer}.{name}")


def test_train_step_indexed_matches_train_step():
    """The gather on the device changes where the batch is assembled, not
    any input value: the same step, bit for bit."""
    rng = np.random.RandomState(9)
    n, t = 6, 30
    data = {"features": rng.randn(n, t, NB_FEATURES), "gains": rng.rand(n, t, NB_BANDS),
            "vad": (rng.rand(n, t, 1) > 0.5) * 1.0}
    data = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in data.items()}
    seq_w = torch.as_tensor(rng.rand(n), dtype=torch.float32)
    idx = torch.tensor([4, 1, 3, 1])  # repeats allowed (shuffled sampling)
    p = _params(10)
    m_ref, m_idx = _model(p), _model(p)
    o_ref, o_idx = TT.make_optimizer(m_ref), TT.make_optimizer(m_idx)
    batch = {k: v[idx] for k, v in data.items()}
    loss_ref = TT.train_step(m_ref, o_ref, batch, seq_w[idx][:, None].expand(4, t))
    loss_idx = TT.train_step_indexed(m_idx, o_idx, data, idx, seq_w)
    assert torch.equal(loss_ref, loss_idx)
    for a, b in zip(m_ref.parameters(), m_idx.parameters()):
        assert torch.equal(a, b)


def test_export_matches_jax_and_denoises():
    p = _params(11)
    p["vad_gru"]["wi"][0, :4] = [0.5 / 256, 1.5 / 256, -0.5 / 256, 0.499]  # half-way cases round to even
    got = TN.export_model(_model(p)).to_bytes()
    assert got == JN.export_model(p).to_bytes()
    assert TN.export_model(p).to_bytes() == got
    sig = (np.random.RandomState(3).randn(5 * 480) * 2000).astype(np.float32)
    out = nt.denoise_audio(sig, nt.RnnModel.from_bytes(got), drop_first_frame=False, device="cpu")
    assert out.shape == sig.shape and np.all(np.isfinite(out))


def test_init():
    a = TN.init_train_params(torch.Generator().manual_seed(0))
    b = TN.init_train_params(torch.Generator().manual_seed(0))
    c = TN.init_train_params(torch.Generator().manual_seed(1))
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        pa = pa.detach()
        layer, key = name.split(".")
        m = getattr(TN.DEFAULT_META, layer)
        assert pa.shape == TN._layer_shapes(layer, m)[key]
        assert torch.equal(pa, pb), name
        if key == "b":
            assert not pa.any(), name
        elif key == "wr":
            eye = torch.eye(m.nb_neurons)
            torch.testing.assert_close(pa @ pa.T, eye, atol=1e-5, rtol=0)
            assert not torch.equal(pa, pc), name
        else:
            limit = np.sqrt(6.0 / (pa.shape[0] + pa.shape[1]))
            assert float(pa.abs().max()) <= limit and float(pa.abs().max()) > 0.5 * limit, name
            assert not torch.equal(pa, pc), name


def test_compute_sample_weights_matches_jax():
    rng = np.random.RandomState(12)
    gains = rng.rand(30, 50, NB_BANDS).astype(np.float32) ** np.linspace(0.2, 4, 30)[:, None, None]
    gains[rng.rand(*gains.shape) < 0.3] = -1.0
    gains[5] = -1.0  # a sequence with no data
    np.testing.assert_array_equal(TN.compute_sample_weights(gains), JT.compute_sample_weights(gains))


def test_load_h5_shapes(tmp_path):
    h5py = pytest.importorskip("h5py")
    data = np.random.RandomState(13).rand(350, NB_FEATURES + 2 * NB_BANDS + 1).astype(np.float32)
    with h5py.File(tmp_path / "train.h5", "w") as f:
        f.create_dataset("data", data=data)
    feats, g, v = TN.load_h5(str(tmp_path / "train.h5"), window=100)
    assert feats.shape == (3, 100, NB_FEATURES) and g.shape == (3, 100, NB_BANDS) and v.shape == (3, 100, 1)
    np.testing.assert_array_equal(g[1, 2], data[102, NB_FEATURES : NB_FEATURES + NB_BANDS])
    np.testing.assert_array_equal(v[2, 99, 0], data[299, -1])


def _stepped(seed: int, cosine_steps=None):
    """A model and optimizer after one step, so Adam's state is full."""
    model = TN.init_train_params(torch.Generator().manual_seed(seed))
    opt = TT.make_optimizer(model, 1e-3, cosine_steps)
    TT.train_step(model, opt, {k: v for k, v in _torch(_batch(seed, 2, 5)).items() if k != "sample_weight"})
    return model, opt


def test_checkpoint_roundtrip(tmp_path):
    model, opt = _stepped(42)
    TT.save_checkpoint(tmp_path / "ckpt", model, opt, 1)
    model2 = TN.init_train_params(torch.Generator().manual_seed(0))
    opt2 = TT.make_optimizer(model2)
    assert TT.restore_checkpoint(tmp_path / "ckpt", model2, opt2) == 1
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(a, b)
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[a][k], opt2.state[b][k]), k
    assert TT.updates_taken(opt2) == 1


def test_checkpoint_never_deletes_unrelated_files(tmp_path):
    ckpt = tmp_path / "ckpts"
    ckpt.mkdir()
    precious = ckpt / "precious.txt"
    precious.write_text("do not delete")
    model, opt = _stepped(0)
    TT.save_checkpoint(ckpt, model, opt, 0)
    TT.save_checkpoint(ckpt, model, opt, 7)
    assert precious.read_text() == "do not delete"
    assert sorted(p.name for p in ckpt.iterdir()) == ["precious.txt", "step_00000000", "step_00000007"]
    assert TT.latest_checkpoint(ckpt).name == "step_00000007"
    model2 = TN.init_train_params(torch.Generator().manual_seed(1))
    assert TT.restore_checkpoint(ckpt, model2, TT.make_optimizer(model2)) == 7


def test_checkpoint_of_another_schedule_raises(tmp_path):
    model, opt = _stepped(3)
    TT.save_checkpoint(tmp_path, model, opt, 1)
    other = TN.init_train_params(torch.Generator().manual_seed(3))
    with pytest.raises(ValueError, match="schedule"):
        TT.restore_checkpoint(tmp_path, other, TT.make_optimizer(other, 1e-3, cosine_steps=10))


def test_fit_checkpoint_resume_roundtrip(tmp_path):
    """fit saves periodically; a second fit resuming from the directory
    continues at the saved step: 4 -> 10."""
    rng = np.random.RandomState(3)
    n, t = 8, 40
    feats = rng.randn(n, t, NB_FEATURES).astype(np.float32)
    gains = rng.rand(n, t, NB_BANDS).astype(np.float32)
    vad = (rng.rand(n, t, 1) > 0.5).astype(np.float32)
    ckpt = tmp_path / "ckpt"
    TT.fit(feats, gains, vad, epochs=2, batch_size=4, log_every=100,
           checkpoint_dir=str(ckpt), checkpoint_every=3, device="cpu")
    # 2 epochs x 2 steps: periodic save at step 3 + final save at step 4
    assert sorted(p.name for p in ckpt.glob("step_*")) == ["step_00000003", "step_00000004"]
    history: list = []
    params = TT.fit(feats, gains, vad, epochs=3, batch_size=4, log_every=100,
                    checkpoint_dir=str(ckpt), checkpoint_every=100, resume_from=str(ckpt),
                    history=history, device="cpu")
    assert TT.latest_checkpoint(ckpt).name == "step_00000010"
    assert [s for s, _ in history] == list(range(6))
    assert np.all(np.isfinite([l for _, l in history]))
    assert all(np.abs(a).max() <= TN.WEIGHT_CLIP for layer in params.values() for a in layer.values())


@pytest.mark.parametrize("name", ["fit", "generate", "train.main", "data.main", "datagen_bench.main"])
def test_defaults_to_cuda_and_raises_without_a_card(name, tmp_path):
    from nnnoiseless_tpu_torch.tools import datagen_bench

    z = np.zeros((2, 5, 1), np.float32)
    entries = {
        "fit": (TT.fit, lambda: TT.fit(z, z, z, epochs=1, batch_size=2)),
        "generate": (TD.generate, lambda: TD.generate(["s.wav"], ["n.wav"], 10)),
        "train.main": (None, lambda: TT.main(["--data", str(tmp_path / "missing.h5")])),
        "data.main": (None, lambda: TD.main(["--signal-glob", "x", "--noise-glob", "y", "--count", "1",
                                             "-o", str(tmp_path / "o.h5")])),
        "datagen_bench.main": (None, lambda: datagen_bench.main(["--workdir", str(tmp_path)])),
    }
    holder, call = entries[name]
    if holder is not None:
        assert inspect.signature(holder).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call()
