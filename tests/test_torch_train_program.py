"""The training half of the compiled programs (nnnoiseless_tpu_torch/
programs.py: ``TrainProgram``, ``FeatureProgram``) on the CPU against the
JAX package and against the eager steps they wrap.

On the CPU a program runs the eager step on its static tensors, so it must
equal a loop of the eager step bit for bit.  Against the JAX package the
bars are tests/test_torch_training.py's (loss rtol 1e-5; parameters rtol
1e-4, atol 1e-5) for the train step and tests/test_torch_datagen.py's
feature bar (1e-4) for the generator's chunk; each has the largest error
measured on the CPU beside it.

Three Adam steps of two implementations part most at a parameter whose
first gradient lies within a few eps (1e-8) of zero: its first update is
lr g / (|g| + eps), so a rounding difference dg in g moves it by up to
lr dg / eps.  With _params(20) and _dataset(21), denoise_gru.wr[24, 261]
had a first gradient of 9.7e-9 (its leaf's median 1.1e-3), and the two
packages' float32 gradients, some 1e-9 apart there, left it 3.4e-5 apart
after three steps, over the 1e-5 bar.  That is the conditioning of the
comparison, not a fault of either step, so the JAX comparison runs on
data whose errors stay clear of it (_params(34), _dataset(35): 6.0e-6).

The ``cuda`` cases need a card and skip here: there the programs are CUDA
graphs, held bit-equal to the eager steps on the card, and a capture that
fails must raise; the data-parallel step's cases run in this process over
a 1-rank NCCL group (a ``FileStore`` in the test's temporary directory, no
network), the all-reduce inside the graph.  The file imports JAX only
inside the tests that compare with it, so the ``cuda`` cases run where JAX
is not installed::

    NNT_TEST_PLATFORM=cuda python -m pytest tests/test_torch_train_program.py -q -m cuda
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from nnnoiseless_tpu_torch.constants import FRAME_SIZE, NB_BANDS, NB_FEATURES
from nnnoiseless_tpu_torch.model import LAYERS, params_from_numpy
from nnnoiseless_tpu_torch.pipeline import FeatureState, FramePre, analyze_frame_hoisted, init_feature_state
from nnnoiseless_tpu_torch.programs import FeatureProgram, TrainProgram
from nnnoiseless_tpu_torch.training import data as TD
from nnnoiseless_tpu_torch.training import network as TN
from nnnoiseless_tpu_torch.training import train as TT

B, T, N_SEQ = 4, 60, 12  # batch and window of tests/test_torch_training.py; sequences in the dataset
STEPS = 3
W, T_GEN, T_TAIL = 2, 20, 12  # generator worlds, a chunk's frames, a shorter last chunk
GEN_FEAT_BAR = 1e-4


def _params(seed: int) -> dict:
    """Float params in the JAX layout, drawn with numpy within the clip."""
    rng = np.random.RandomState(seed)
    return {layer: {k: rng.uniform(-0.3, 0.3, s).astype(np.float32)
                    for k, s in TN._layer_shapes(layer, getattr(TN.DEFAULT_META, layer)).items()}
            for layer in LAYERS}


def _dataset(seed: int) -> dict:
    """N_SEQ sequences of T frames (gains with -1 sentinels, vad with 0.5
    labels), per-sequence weights, and each step's B indices (repeats
    allowed, as a shuffled epoch's are not, to hold the gather)."""
    rng = np.random.RandomState(seed)
    gains = rng.rand(N_SEQ, T, NB_BANDS).astype(np.float32)
    gains[rng.rand(*gains.shape) < 0.2] = -1.0
    vad = (rng.rand(N_SEQ, T, 1) > 0.5).astype(np.float32)
    vad[rng.rand(N_SEQ, T, 1) < 0.2] = 0.5
    return {
        "data": {"features": rng.randn(N_SEQ, T, NB_FEATURES).astype(np.float32), "gains": gains, "vad": vad},
        "seq_w": rng.uniform(0.3, 2.0, N_SEQ).astype(np.float32),
        "idx": [rng.randint(0, N_SEQ, B).astype(np.int64) for _ in range(2 * STEPS)],
    }


def _trainer(params: dict, ds: dict, device, cosine_steps=None):
    """(model, optimizer, dataset on ``device``, sample weights there)."""
    model = TN.TrainableModel()
    model.load_state_dict(params_from_numpy(params, "cpu"))
    model = model.to(device)
    opt = TT.make_optimizer(model, 1e-3, cosine_steps)
    data = {k: torch.as_tensor(v, device=device) for k, v in ds["data"].items()}
    return model, opt, data, torch.as_tensor(ds["seq_w"], device=device)


def _program(model, opt, data, seq_w):
    return TrainProgram(lambda idx: TT.train_step_indexed(model, opt, data, idx, seq_w), model, opt, B)


def _run(params, ds, device, graphed: bool, steps: int = STEPS, lr_at=None, cosine_steps=None):
    """``steps`` steps on ``device`` through a TrainProgram or the eager
    train_step_indexed; with ``lr_at = (k, lr)`` the learning rate is set
    in place before step k.  Returns (losses, params, optimizer, program
    or None)."""
    model, opt, data, seq_w = _trainer(params, ds, device, cosine_steps)
    prog = _program(model, opt, data, seq_w) if graphed else None
    losses = []
    for k in range(steps):
        if lr_at is not None and k == lr_at[0]:
            opt.param_groups[0]["lr"].fill_(lr_at[1])
        idx = torch.as_tensor(ds["idx"][k], device=device)
        loss = prog(idx) if graphed else TT.train_step_indexed(model, opt, data, idx, seq_w)
        losses.append(loss.clone())
    return torch.stack(losses).cpu(), [p.detach().cpu().clone() for p in model.parameters()], opt, prog


def _jax_run(params, ds, optimizer, steps: int = STEPS, lr_at=None):
    import jax
    import jax.numpy as jnp

    from nnnoiseless_tpu.training import network as JN
    from nnnoiseless_tpu.training import train as JT

    opt = JT.make_optimizer(optimizer)
    state = JT.TrainState(jax.tree_util.tree_map(jnp.asarray, params), opt.init(params), jnp.int32(0))
    data = {k: jnp.asarray(v) for k, v in ds["data"].items()}
    losses = []
    for k in range(steps):
        if lr_at is not None and k == lr_at[0]:
            state.opt_state.hyperparams["learning_rate"] = jnp.asarray(lr_at[1], jnp.float32)
        state, loss = JT.train_step_indexed(state, data, jnp.asarray(ds["idx"][k]), jnp.asarray(ds["seq_w"]),
                                            JN.DEFAULT_META, opt)
        losses.append(float(loss))
    return np.array(losses), jax.device_get(state.params)


def _assert_params_close(got: list, want: dict):
    got = dict(zip([n for n, _ in TN.TrainableModel().named_parameters()], got))
    for layer, leaves in want.items():
        for name, w in leaves.items():
            np.testing.assert_allclose(got[f"{layer}.{name}"].numpy(), w, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{layer}.{name}")


@pytest.mark.parametrize("schedule", [None, "cosine"])
def test_train_program_matches_jax(schedule):
    """Three program steps on the CPU against the JAX train_step_indexed,
    constant and cosine over 5 steps."""
    import optax

    p, ds = _params(34), _dataset(35)
    cosine = None if schedule is None else 5
    losses, got, _, _ = _run(p, ds, "cpu", graphed=True, cosine_steps=cosine)
    want_l, want_p = _jax_run(p, ds, 1e-3 if schedule is None else optax.cosine_decay_schedule(1e-3, 5))
    # measured at most 5.1e-7 relative
    np.testing.assert_allclose(losses.numpy(), want_l, rtol=1e-5)
    # measured at most 6.0e-6 absolute
    _assert_params_close(got, want_p)


def test_train_program_on_the_cpu_is_the_eager_step():
    """On the CPU the program is train_step_indexed on its static tensors:
    losses, parameters and Adam's state bit for bit, and nothing captured."""
    p, ds = _params(22), _dataset(23)
    l_prog, p_prog, o_prog, prog = _run(p, ds, "cpu", graphed=True, cosine_steps=4)
    l_eager, p_eager, o_eager, _ = _run(p, ds, "cpu", graphed=False, cosine_steps=4)
    assert torch.equal(l_prog, l_eager)
    assert all(torch.equal(a, b) for a, b in zip(p_prog, p_eager))
    for a, b in zip(o_prog.state.values(), o_eager.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
    assert torch.equal(o_prog.param_groups[0]["lr"], o_eager.param_groups[0]["lr"])
    assert prog.program.graph is None and prog.program.replays == 0
    assert TT.updates_taken(o_prog) == STEPS


def test_learning_rate_changed_mid_run():
    """Filling the learning-rate tensor in place between steps (the route
    make_optimizer documents) takes effect in the program, as changing
    optax's injected hyperparameter does in the JAX step."""
    p, ds = _params(24), _dataset(25)
    change = (2, 3e-3)
    losses, got, _, _ = _run(p, ds, "cpu", graphed=True, steps=4, lr_at=change)
    want_l, want_p = _jax_run(p, ds, 1e-3, steps=4, lr_at=change)
    # measured at most 1.2e-6 relative
    np.testing.assert_allclose(losses.numpy(), want_l, rtol=1e-5)
    # measured at most 3.0e-6 absolute
    _assert_params_close(got, want_p)
    _, unchanged, _, _ = _run(p, ds, "cpu", graphed=True, steps=4)
    assert not all(torch.equal(a, b) for a, b in zip(got, unchanged))


def test_fit_history_holds_each_steps_loss():
    """fit's history is each step's own loss (not the program's static
    loss, which the next step overwrites), bit-equal to an eager loop over
    the same permutations."""
    ds = _dataset(26)
    feats, gains, vad = (ds["data"][k] for k in ("features", "gains", "vad"))
    history: list = []
    params = TT.fit(feats, gains, vad, epochs=2, batch_size=B, seed=5, log_every=100, history=history,
                    lr_schedule="cosine", device="cpu")
    model = TN.init_train_params(torch.Generator().manual_seed(5))
    steps = 2 * (N_SEQ // B)
    opt = TT.make_optimizer(model, 1e-3, steps)
    data = {k: torch.as_tensor(v) for k, v in ds["data"].items()}
    seq_w = torch.as_tensor(TN.compute_sample_weights(gains))
    rng, want = np.random.RandomState(5), []
    for _ in range(2):
        perm = rng.permutation(N_SEQ)
        for i in range(0, N_SEQ - B + 1, B):
            want.append(float(TT.train_step_indexed(model, opt, data, torch.as_tensor(perm[i : i + B]), seq_w)))
    assert [s for s, _ in history] == list(range(steps))
    assert [l for _, l in history] == want
    assert len(set(want)) == steps
    for layer, leaves in TN.numpy_params(model).items():
        for name, w in leaves.items():
            np.testing.assert_array_equal(params[layer][name], w)


def test_checkpoint_saved_capturable_resumes_on_the_cpu(tmp_path):
    """A checkpoint whose param_groups say capturable (as one written on a
    card does) resumes on the CPU, Adam non-capturable there, and steps as
    the same checkpoint saved on the CPU does."""
    p, ds = _params(27), _dataset(28)
    model, opt, data, seq_w = _trainer(p, ds, "cpu")
    TT.train_step_indexed(model, opt, data, torch.as_tensor(ds["idx"][0]), seq_w)
    plain = TT.save_checkpoint(tmp_path / "cpu", model, opt, 1)
    ckpt = torch.load(plain, weights_only=True)
    for group in ckpt["optimizer"]["param_groups"]:
        group["capturable"] = True
    (tmp_path / "card").mkdir()
    torch.save(ckpt, tmp_path / "card" / plain.name)
    after = []
    for where in ("cpu", "card"):
        m2, o2, _, _ = _trainer(_params(0), ds, "cpu")
        assert TT.restore_checkpoint(tmp_path / where, m2, o2) == 1
        assert o2.param_groups[0]["capturable"] is False and TT.updates_taken(o2) == 1
        prog = _program(m2, o2, data, seq_w)
        prog(torch.as_tensor(ds["idx"][1]))
        after.append([q.detach().clone() for q in m2.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*after))


# ---- the generator's frame loop ------------------------------------------------


def _gen_frames(testing_raw, t_count: int, offset: int) -> torch.Tensor:
    """(2W, t_count, 480): each world's clean stream (a slice of the golden
    clip at a seeded gain) and noise stream (seeded white noise)."""
    rng = np.random.RandomState(offset)
    n = t_count * FRAME_SIZE
    out = []
    for i in range(W):
        start = offset * FRAME_SIZE + 7919 * i
        out.append(testing_raw[start : start + n] * rng.uniform(0.2, 1.5))
        out.append(rng.randn(n).astype(np.float32) * rng.uniform(100, 1500))
    return torch.from_numpy(np.stack(out).astype(np.float32).reshape(2 * W, t_count, FRAME_SIZE))


def _eager_loop(state, pre):
    """The generator's frame loop without a program: the eager
    analyze_frame_hoisted on the precompute's slices."""
    feats = []
    for t in range(pre.filtered.shape[0]):
        state, an = analyze_frame_hoisted(state, FramePre(*(f[t] for f in pre)))
        feats.append(an.features)
    return state, torch.stack(feats, 1)


def _chunks(lengths):
    """(frames, offset into the clip) of chained chunks of these lengths."""
    return [(t_count, 40 + sum(lengths[:i])) for i, t_count in enumerate(lengths)]


def _two_chunks(testing_raw, frame_loop, device="cpu", lengths=(T_GEN, T_TAIL)):
    """Two chained chunks (by default T_GEN, then T_TAIL frames) from a
    zero state: [(states', features, ex, silence)] each."""
    states, out = init_feature_state(3 * W, device), []
    for t_count, offset in _chunks(lengths):
        res = TD._feature_chunk(states, _gen_frames(testing_raw, t_count, offset).to(device), frame_loop)
        states = res[0]
        out.append(res)
    return out


def test_feature_program_matches_jax_feature_chunk(testing_raw):
    """Two chained chunks through one FeatureProgram against the JAX
    _feature_chunk (both of T_GEN frames: one JAX compile)."""
    import jax.numpy as jnp

    from nnnoiseless_tpu.pipeline import FeatureState as JState
    from nnnoiseless_tpu.training import data as JD

    lengths = (T_GEN, T_GEN)
    got = _two_chunks(testing_raw, FeatureProgram(W, "cpu"), lengths=lengths)
    states_j = JState(*(jnp.asarray(a.numpy()) for a in init_feature_state(3 * W, "cpu")))
    for (t_count, offset), (st, feats, ex, sil) in zip(_chunks(lengths), got):
        states_j, feats_j, ex_j, sil_j = JD._feature_chunk(
            states_j, jnp.asarray(_gen_frames(testing_raw, t_count, offset).numpy()))
        assert feats.shape == (W, t_count, NB_FEATURES)
        # measured at most 1.5e-5
        np.testing.assert_allclose(feats.numpy(), np.asarray(feats_j), atol=GEN_FEAT_BAR, rtol=0)
        # measured at most 1.7e-5 relative
        np.testing.assert_allclose(ex.numpy(), np.asarray(ex_j), rtol=1e-4, atol=1e-3)
        np.testing.assert_array_equal(sil.numpy(), np.asarray(sil_j))
        np.testing.assert_array_equal(st.pitch_period.numpy(), np.asarray(states_j.pitch_period))


def test_feature_program_on_the_cpu_is_the_eager_loop(testing_raw):
    """On the CPU the program is the eager frame loop on its static
    tensors: features, ex, silence and every state field bit for bit, over
    two chunks of different lengths."""
    prog = FeatureProgram(W, "cpu")
    for got, want in zip(_two_chunks(testing_raw, prog), _two_chunks(testing_raw, _eager_loop)):
        for a, b in zip(got[1:], want[1:]):
            assert torch.equal(a, b)
        for name in FeatureState._fields:
            assert torch.equal(getattr(got[0], name), getattr(want[0], name)), name
    assert prog.program.graph is None and prog.program.replays == 0


# ---- on a card -----------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_train_graph_equals_eager_on_the_card(card):
    """The train step replayed from its graph, with a learning rate
    changed in place mid-run, bit-equal to the eager capturable steps."""
    p, ds = _params(30), _dataset(31)
    change = (2, 3e-3)
    l_g, p_g, o_g, prog = _run(p, ds, card, graphed=True, steps=5, lr_at=change)
    l_e, p_e, o_e, _ = _run(p, ds, card, graphed=False, steps=5, lr_at=change)
    assert o_g.param_groups[0]["capturable"] and o_e.param_groups[0]["capturable"]
    assert torch.equal(l_g, l_e)
    assert all(torch.equal(a, b) for a, b in zip(p_g, p_e))
    assert prog.program.warmups == 1 and prog.program.replays == 5
    assert TT.updates_taken(o_g) == 5


@pytest.mark.cuda
def test_feature_graph_equals_eager_on_the_card(card, testing_raw):
    """The generator's frame loop replayed from its graph (K6 inside) over
    two chunks of different lengths, bit-equal to the eager loop."""
    prog = FeatureProgram(W, card)
    for got, want in zip(_two_chunks(testing_raw, prog, card), _two_chunks(testing_raw, _eager_loop, card)):
        for a, b in zip(got[1:], want[1:]):
            assert torch.equal(a, b)
        for name in FeatureState._fields:
            assert torch.equal(getattr(got[0], name), getattr(want[0], name)), name
    assert prog.program.replays == T_GEN + T_TAIL and prog.program.captured == {"K6": 1}


@pytest.mark.cuda
def test_failed_train_capture_raises_on_the_card(card):
    """A train step that reads the device from the host cannot be
    captured: the call raises, and so does the next; nothing runs it
    eagerly in the graph's place."""
    p, ds = _params(32), _dataset(33)
    model, opt, data, seq_w = _trainer(p, ds, card)
    step = lambda idx: TT.train_step_indexed(model, opt, data, idx, seq_w) * float(idx.sum().item() > -1)
    prog = TrainProgram(step, model, opt, B)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            prog(torch.as_tensor(ds["idx"][0], device=card))
        assert prog.program.graph is None and prog.program.replays == 0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_no_graph_is_destroyed_inside_a_capture(card):
    """A program whose step closes over it is freed by the cyclic
    collector, which destroys its graph, and a graph destroyed while
    another is captured invalidates that capture: a program dropped after
    its capture is freed before the next program captures, and no
    collection starts while a capture runs."""
    p, ds = _params(40), _dataset(41)
    idx = torch.as_tensor(ds["idx"][0], device=card)
    old = _program(*_trainer(p, ds, card))
    old(idx)
    events = []
    weakref.finalize(old, lambda: events.append(("freed", torch.cuda.is_current_stream_capturing())))
    del old

    def on_collection(phase, info):
        if phase == "start":
            events.append(("collection", torch.cuda.is_current_stream_capturing()))

    gc.callbacks.append(on_collection)
    try:
        new = _program(*_trainer(p, ds, card))
        new(idx)
    finally:
        gc.callbacks.remove(on_collection)
    assert ("freed", False) in events and ("freed", True) not in events
    assert ("collection", True) not in events
    assert new.program.graph is not None and new.program.replays == 1


@pytest.fixture
def nccl_mesh(card, tmp_path):
    """A 1-D "dp" DeviceMesh over a 1-rank NCCL group, destroyed after the
    test whatever its outcome."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield init_device_mesh("cuda", (1,), mesh_dim_names=("dp",))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", [None, "cosine"])
def test_dp_train_graph_equals_eager_on_the_card(nccl_mesh, card, schedule):
    """The data-parallel step (train_step_dp, its all-reduce inside the
    graph) replayed 3 times from its graph, bit-equal to 3 eager steps from
    the same parameters and Adam state, constant and cosine over 5 steps.
    The graph's warm-up step is the group's first collective."""
    p, ds = _params(36), _dataset(37)
    cosine = None if schedule is None else 5
    runs = []
    for graphed in (True, False):
        model, opt, data, seq_w = _trainer(p, ds, card, cosine)
        step = lambda idx: TT.train_step_dp(model, opt, data, idx, seq_w, nccl_mesh)
        prog = TrainProgram(step, model, opt, B) if graphed else None
        idxs = [torch.as_tensor(ds["idx"][k], device=card) for k in range(STEPS)]
        losses = torch.stack([(prog(idx) if graphed else step(idx)).clone() for idx in idxs])
        runs.append((losses.cpu(), [q.detach().cpu() for q in model.parameters()], opt, prog))
    (l_g, p_g, o_g, prog), (l_e, p_e, o_e, _) = runs
    assert o_g.param_groups[0]["capturable"] and o_e.param_groups[0]["capturable"]
    assert torch.equal(l_g, l_e) and len(set(l_g.tolist())) == STEPS
    assert all(torch.equal(a, b) for a, b in zip(p_g, p_e))
    assert prog.program.warmups == 1 and prog.program.replays == STEPS
    assert TT.updates_taken(o_g) == TT.updates_taken(o_e) == STEPS


@pytest.mark.cuda
def test_failed_dp_capture_raises_on_the_card(nccl_mesh, card):
    """A data-parallel step that reads the device from the host after its
    all-reduce cannot be captured: the call raises, and so does the next;
    nothing runs it eagerly in the graph's place (the parameters stay as
    they were), and the group still serves an eager step afterwards."""
    p, ds = _params(38), _dataset(39)
    model, opt, data, seq_w = _trainer(p, ds, card)
    before = [q.detach().clone() for q in model.parameters()]
    step = lambda idx: TT.train_step_dp(model, opt, data, idx, seq_w, nccl_mesh) * float(idx.sum().item() > -1)
    prog = TrainProgram(step, model, opt, B)
    idx = torch.as_tensor(ds["idx"][0], device=card)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            prog(idx)
        assert prog.program.graph is None and prog.program.replays == 0
        assert all(torch.equal(a, b) for a, b in zip(model.parameters(), before))
    torch.cuda.synchronize()
    assert torch.isfinite(TT.train_step_dp(model, opt, data, idx, seq_w, nccl_mesh))
