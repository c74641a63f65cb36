"""The port's multi-device split (nnnoiseless_tpu_torch/parallel/) and
data-parallel fit on the CPU, against the port's one-device engine and
trainer and against the JAX package.

Inference mirrors tests/test_parallel.py on mesh entries that repeat the
one CPU device (the role of the conftest's 8 virtual XLA devices).
Training runs ``fit(mesh=...)`` in gloo processes spawned by
``parallel.dryrun.run_ranks``; the rank functions below live in this
module, which imports JAX only inside the tests that compare with it, so
that a spawned rank imports the port and never ``jax``.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import nnnoiseless_tpu_torch as nt
from nnnoiseless_tpu_torch.constants import FRAME_SIZE, NB_BANDS, NB_FEATURES
from nnnoiseless_tpu_torch.model import LayerMeta, ModelMeta
from nnnoiseless_tpu_torch.parallel import dryrun, make_mesh, shard_batch, sharded_process_frames
from nnnoiseless_tpu_torch.parallel import mesh as mesh_mod
from nnnoiseless_tpu_torch.training import losses as TL
from nnnoiseless_tpu_torch.training import network as TN
from nnnoiseless_tpu_torch.training import train as TT

CPU8 = ["cpu"] * 8
RANK_TIMEOUT = 120.0  # s, each spawn test's own: a hung gloo rendezvous fails that test


def _frames(seed: int, b: int, t: int, scale: float = 2000.0) -> np.ndarray:
    return (np.random.RandomState(seed).randn(b, t, FRAME_SIZE) * scale).astype(np.float32)


def _carry(model, b):
    return nt.init_batch_carry(model.meta, b, "cpu")


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for sub in tree for leaf in _leaves(sub)]


@pytest.fixture(scope="module")
def model():
    return nt.RnnModel.default()


def test_sharded_matches_unsharded_and_jax(testing_raw, model, default_model):
    """tests/test_parallel.py::test_sharded_matches_unsharded: 8 entries,
    B=16, T=6, stream 0 from testing.raw, against the port's unsharded
    engine (its bars) and JAX's sharded engine on 8 devices
    (test_torch_golden.py's port-to-JAX bars)."""
    import jax

    from nnnoiseless_tpu import init_batch_carry as jax_init
    from nnnoiseless_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from nnnoiseless_tpu.parallel.mesh import shard_batch as jax_shard_batch
    from nnnoiseless_tpu.parallel.mesh import sharded_process_frames as jax_sharded

    b, t = 16, 6
    frames = _frames(0, b, t)
    frames[0] = testing_raw[: t * FRAME_SIZE].reshape(t, FRAME_SIZE)
    mesh = make_mesh(CPU8)
    c_s, out_s, vad_s = sharded_process_frames(model, shard_batch(_carry(model, b), mesh), frames, mesh)
    _, out_u, vad_u = nt.process_frames(nt.Engine(model, "cpu"), _carry(model, b), frames)
    assert out_s.shape == (b, t, FRAME_SIZE) and vad_s.shape == (b, t)
    assert len(c_s) == 8 and all(c.lastg.shape[0] == 2 for c in c_s)
    np.testing.assert_allclose(out_s.numpy(), out_u.numpy(), atol=1.0)
    np.testing.assert_allclose(vad_s.numpy(), vad_u.numpy(), atol=1e-3)

    jmesh = jax_make_mesh(jax.devices()[:8])
    _, out_j, vad_j = jax_sharded(default_model, jax_shard_batch(jax_init(default_model.meta, b), jmesh),
                                  frames, jmesh)
    np.testing.assert_allclose(out_s.numpy(), np.asarray(out_j), atol=0.01, rtol=1e-5)
    np.testing.assert_allclose(vad_s.numpy(), np.asarray(vad_j), atol=1e-5)


def test_sharded_carry_roundtrip(model):
    """Carries survive a sharded two-chunk run (test_parallel.py:49-63)."""
    b = 8
    mesh = make_mesh(CPU8)
    frames = _frames(1, b, 4, 1000.0)
    carry = shard_batch(_carry(model, b), mesh)
    carry, out_a, _ = sharded_process_frames(model, carry, frames[:, :2], mesh)
    carry, out_b, _ = sharded_process_frames(model, carry, frames[:, 2:], mesh)
    two_chunk = torch.cat([out_a, out_b], 1).numpy()
    _, out_full, _ = nt.process_frames(nt.Engine(model, "cpu"), _carry(model, b), frames)
    np.testing.assert_allclose(two_chunk, out_full.numpy(), atol=1.0)


def _custom_model(rng) -> nt.RnnModel:
    """A model of non-standard topology (a 32-neuron vad GRU), seeded
    int8-valued weights: the scan engine serves it."""
    layers = (
        ("input_dense", 42, 24, 0), ("vad_gru", 24, 32, 1), ("noise_gru", 42 + 24 + 32, 48, 2),
        ("denoise_gru", 42 + 32 + 48, 96, 2), ("denoise_output", 96, 22, 1), ("vad_output", 32, 1, 1),
    )
    params = {}
    for name, n_in, n, _ in layers:
        w = lambda *shape: rng.randint(-40, 41, size=shape).astype(np.float32)
        params[name] = ({"wi": w(n_in, 3 * n), "wr": w(n, 3 * n), "b": w(3 * n)} if name.endswith("gru")
                        else {"w": w(n_in, n), "b": w(n)})
    return nt.RnnModel(params, ModelMeta(*(LayerMeta(n_in, n, a) for _, n_in, n, a in layers)))


@pytest.mark.parametrize("engine", ["two_phase", "scan"])
def test_engine_per_shard(testing_raw, model, engine):
    """Each shard runs the one-device engine's choice
    (test_parallel.py:66-92): the two-phase engine for the standard model,
    held to the JAX test's bars against the unsharded scan engine; the
    scan engine for a non-standard one, against its unsharded run."""
    b, t = 8, 4
    frames = np.stack([testing_raw[i * FRAME_SIZE * t : (i + 1) * FRAME_SIZE * t].reshape(t, FRAME_SIZE)
                       for i in range(b)])
    mdl = model if engine == "two_phase" else _custom_model(np.random.RandomState(35))
    mesh = make_mesh(CPU8)
    _, out_s, vad_s = sharded_process_frames(mdl, shard_batch(_carry(mdl, b), mesh), frames, mesh)
    shard_engine = mesh_mod._engine_on(mdl, mesh.devices[0])
    assert shard_engine.two_phase == (engine == "two_phase")
    _, out_u, vad_u = nt.process_frames(nt.Engine(mdl, "cpu", fused=False), _carry(mdl, b), frames)
    np.testing.assert_allclose(out_s.numpy(), out_u.numpy(), atol=0.05)
    np.testing.assert_allclose(vad_s.numpy(), vad_u.numpy(), atol=1e-4)


_COLLECTIVES = (
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object", "all_to_all",
    "all_to_all_single", "reduce", "reduce_scatter", "reduce_scatter_tensor", "broadcast",
    "broadcast_object_list", "scatter", "gather", "barrier", "send", "recv", "isend", "irecv",
    "batch_isend_irecv", "monitored_barrier",
)


def test_no_collectives(monkeypatch, model):
    """test_parallel.py:95-131's claim for the port: the split calls no
    torch.distributed collective, and each carry slice stays on its own
    entry, holding that entry's streams."""

    def refuse(*args, **kwargs):
        raise AssertionError("a collective was called on the inference path")

    for name in _COLLECTIVES:
        if hasattr(dist, name):
            monkeypatch.setattr(dist, name, refuse)
    b, t = 16, 3
    mesh = make_mesh(CPU8)
    frames = _frames(2, b, t)
    carry = shard_batch(_carry(model, b), mesh)
    carry, out, vad = sharded_process_frames(model, carry, frames, mesh)
    assert out.device == mesh.devices[0] and vad.device == mesh.devices[0]
    want, _, _ = nt.process_frames(nt.Engine(model, "cpu"), _carry(model, b), frames)
    for i, (shard, device) in enumerate(zip(carry, mesh.devices)):
        for leaf, full in zip(_leaves(shard), _leaves(want)):
            assert leaf.device == device and leaf.shape[0] == b // 8
            torch.testing.assert_close(leaf, full[2 * i : 2 * i + 2], atol=1.0, rtol=1e-4)


def test_indivisible_batch_raises(model):
    mesh = make_mesh(CPU8)
    frames = np.zeros((6, 2, FRAME_SIZE), np.float32)  # 6 % 8 != 0
    with pytest.raises(ValueError, match="divisible"):
        shard_batch(_carry(model, 6), mesh)
    with pytest.raises(ValueError, match="divisible"):
        sharded_process_frames(model, _carry(model, 6), frames, mesh)
    scalar = _carry(model, 8)._replace(lastg=torch.zeros(()))
    with pytest.raises(ValueError, match="0-d"):
        shard_batch(scalar, mesh)


def test_make_mesh_needs_a_card():
    """The default mesh is every card present; without one it raises, as
    every entry point does, and names the CPU."""
    mesh = make_mesh(["cpu", "cpu"])
    assert mesh.size == 2 and mesh.axis_name == "dp" and mesh.devices == (torch.device("cpu"),) * 2
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_mesh()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        sharded_process_frames(nt.RnnModel.default(), None, np.zeros((2, 1, FRAME_SIZE), np.float32))


# ---- data-parallel fit ----------------------------------------------------

N_SEQ, T_SEQ, BATCH = 16, 40, 8
SEED = 0


def _train_data():
    """n=16 sequences in unequal gain tertiles (2 high, 5 middle, 9 low), so
    the sample weights differ by sequence and the ranks' weight sums differ
    at each step of SEED's permutation (asserted where it matters)."""
    rng = np.random.RandomState(4)
    level = np.array([0.85] * 2 + [0.5] * 5 + [0.15] * 9)[rng.permutation(N_SEQ)]
    gains = np.clip(level[:, None, None] + rng.uniform(-0.1, 0.1, (N_SEQ, T_SEQ, NB_BANDS)), 0, 1)
    gains[rng.rand(*gains.shape) < 0.1] = -1.0
    feats = rng.randn(N_SEQ, T_SEQ, NB_FEATURES)
    vad = (rng.rand(N_SEQ, T_SEQ, 1) > 0.5) * 1.0
    return tuple(a.astype(np.float32) for a in (feats, gains, vad))


def _fit_worker(mesh, arrays, kwargs):
    history: list = []
    params = TT.fit(*arrays, mesh=mesh, history=history, device="cpu", **kwargs)
    return params, history


def _ckpt_worker(mesh, arrays, ckpt):
    """fit with a checkpoint a step, recording this rank's saves, then a
    second fit resumed from them."""
    saved = []
    real = TT.save_checkpoint
    TT.save_checkpoint = lambda path, model, opt, step: saved.append(step) or real(path, model, opt, step)
    kw = dict(batch_size=BATCH, seed=SEED, log_every=100, device="cpu", mesh=mesh)
    TT.fit(*arrays, epochs=1, checkpoint_dir=ckpt, checkpoint_every=1, **kw)
    params = TT.fit(*arrays, epochs=2, resume_from=ckpt, **kw)
    return saved, params


def _indivisible_worker(mesh, arrays):
    try:
        TT.fit(*arrays, epochs=1, batch_size=3, device="cpu", mesh=mesh)
    except ValueError as e:
        return str(e)
    return None


def _assert_params_close(got, want):
    for layer, leaves in want.items():
        for name, w in leaves.items():
            np.testing.assert_allclose(got[layer][name], w, rtol=1e-4, atol=1e-5, err_msg=f"{layer}.{name}")


def _averaged_means_fit(arrays):
    """The step that averages the two ranks' own weighted means (stock DDP
    over this loss), emulated in one process: the wrong step."""
    feats, gains, vad = (torch.as_tensor(a) for a in arrays)
    seq_w = torch.as_tensor(TN.compute_sample_weights(arrays[1]))
    model = TN.init_train_params(torch.Generator().manual_seed(SEED))
    opt = TT.make_optimizer(model)
    perm = np.random.RandomState(SEED).permutation(N_SEQ)
    for i in range(0, N_SEQ - BATCH + 1, BATCH):
        grads = []
        for half in np.split(perm[i : i + BATCH], 2):
            idx = torch.as_tensor(half)
            g, v = TN.sequence_forward(model, feats[idx])
            sw = seq_w[idx][:, None].expand(len(half), T_SEQ)
            loss = TL.total_loss(gains[idx], g, vad[idx], v, sw) + TL.l2_regularization(model)
            grads.append(torch.autograd.grad(loss, list(model.parameters())))
        for p, g0, g1 in zip(model.parameters(), *grads):
            p.grad = (g0 + g1) / 2
        opt.step()
        TN.clip_params(model)
    return TN.numpy_params(model)


def test_fit_dp_matches_single_device_and_jax(monkeypatch):
    """fit over 2 gloo ranks (n=16, t=40, batch 8, one epoch: 2 steps)
    against the port's one-device fit and JAX's fit on a 2-device mesh
    (started from the port's initial parameters), under
    test_torch_training.py's step bars; and the step that averages
    per-rank weighted means misses those bars on this data."""
    import jax
    import jax.numpy as jnp

    from nnnoiseless_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from nnnoiseless_tpu.training import train as JT

    init = TN.numpy_params(TN.init_train_params(torch.Generator().manual_seed(SEED)))
    monkeypatch.setattr(JT, "init_train_params", lambda key, meta: jax.tree_util.tree_map(jnp.asarray, init))

    arrays = _train_data()
    seq_w = TN.compute_sample_weights(arrays[1])
    perm = np.random.RandomState(SEED).permutation(N_SEQ)
    for i in range(0, N_SEQ, BATCH):
        halves = np.split(perm[i : i + BATCH], 2)
        assert abs(seq_w[halves[0]].sum() - seq_w[halves[1]].sum()) > 0.5  # the ranks' weight sums differ

    kw = dict(epochs=1, batch_size=BATCH, seed=SEED, log_every=100)
    ranks = dryrun.run_ranks(2, _fit_worker, arrays, kw, timeout=RANK_TIMEOUT)
    hist_one: list = []
    one = TT.fit(*arrays, history=hist_one, device="cpu", **kw)
    hist_jax: list = []
    jx = JT.fit(*arrays, mesh=jax_make_mesh(jax.devices()[:2]), history=hist_jax, **kw)

    (p0, h0), (p1, h1) = ranks
    assert h0 == h1 and [s for s, _ in h0] == [0, 1]
    for layer, leaves in p0.items():
        for name, a in leaves.items():
            np.testing.assert_array_equal(a, p1[layer][name])  # the ranks stay identical
    for want_hist, want in ((hist_one, one), (hist_jax, jax.device_get(jx))):
        np.testing.assert_allclose([l for _, l in h0], [l for _, l in want_hist], rtol=1e-5)
        _assert_params_close(p0, want)
    with pytest.raises(AssertionError):
        _assert_params_close(_averaged_means_fit(arrays), one)


def test_fit_dp_checkpoints_from_rank_0(tmp_path):
    """Only rank 0 writes checkpoints (at steps 1, 2 and the final 2);
    both ranks resume from them and match the one-device resume."""
    arrays = _train_data()
    ckpt = str(tmp_path / "dp")
    (saved0, p0), (saved1, p1) = dryrun.run_ranks(2, _ckpt_worker, arrays, ckpt, timeout=RANK_TIMEOUT)
    assert saved0 == [1, 2, 2] and saved1 == []
    kw = dict(batch_size=BATCH, seed=SEED, log_every=100, device="cpu")
    one_dir = str(tmp_path / "one")
    TT.fit(*arrays, epochs=1, checkpoint_dir=one_dir, checkpoint_every=1, **kw)
    one = TT.fit(*arrays, epochs=2, resume_from=one_dir, **kw)
    _assert_params_close(p0, one)
    _assert_params_close(p1, one)


def test_fit_dp_indivisible_batch_raises():
    (msg0, msg1) = dryrun.run_ranks(2, _indivisible_worker, _train_data(), timeout=RANK_TIMEOUT)
    assert msg0 == msg1 and "divisible" in msg0


def test_dryrun(capsys):
    """dryrun_multichip(4) on the CPU prints its line; the sharded engine
    is within the JAX dry run's 0.1-unit bar."""
    line = dryrun.dryrun_multichip(4)
    assert capsys.readouterr().out.strip() == line
    assert line.startswith("dryrun_multichip OK on 4 devices")
    delta = float(line.rsplit("max |delta| ", 1)[1].rstrip(")"))
    assert delta <= 0.1
