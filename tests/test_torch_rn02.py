"""RNNoise 0.2's network and recipe on the trainer (``training/rn02.py``)
against the plain reference of the benchmark
(``perf_bench/reference/rn02_train.py``, which imports nothing of the
port) and against ``torch.nn.GRU``, at a small size on the CPU: 65 -> 16
-> 24 convolution widths, GRUs of 24, T = 12, B = 3, seeded.  The JAX
package has no counterpart of this network, and the file does not import
JAX.

The ``cuda`` cases need a card and skip here: the graph of the step
against its eager steps, and the phase marks that split a traced replay::

    NNT_TEST_PLATFORM=cuda python -m pytest tests/test_torch_rn02.py -q -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nnnoiseless_tpu_torch import tracing
from nnnoiseless_tpu_torch.programs import TrainProgram
from nnnoiseless_tpu_torch.training import network as TN
from nnnoiseless_tpu_torch.training import rn02
from nnnoiseless_tpu_torch.training import train as TT
from perf_bench.reference import rn02_train as ref

META = rn02.Rn02Meta(input_dim=65, cond_size=16, gru_size=24, output_dim=32)
B, T = 3, 12


def _model(seed: int = 1) -> rn02.Rn02Model:
    return rn02.init_params(torch.Generator().manual_seed(seed), META)


def _rows(n: int, seed: int = 2) -> dict:
    g = torch.Generator().manual_seed(seed)
    gains = torch.rand((n, T, META.output_dim), generator=g)
    gains = torch.where(torch.rand(gains.shape, generator=g) < 0.1, -1.0, gains)
    return {"features": torch.randn((n, T, META.input_dim), generator=g), "gains": gains,
            "vad": (torch.rand((n, T, 1), generator=g) < 0.5).float()}


def _reset_before_step(layer, xw, h):
    """The 2018 network's cell in torch's layout: the reset gate applied to
    the state before the candidate's recurrent product."""
    n = h.shape[1]
    w, b = layer["weight_hh_l0"], layer["bias_hh_l0"]
    x_rz, x_n = xw.split((2 * n, n), 1)
    r, z = torch.sigmoid(x_rz + F.linear(h, w[: 2 * n], b[: 2 * n])).split(n, 1)
    return torch.lerp(torch.tanh(x_n + F.linear(r * h, w[2 * n :], b[2 * n :])), h, z)


def test_parameters_are_named_and_shaped_as_rnnoise_py():
    shapes = {k: tuple(v.shape) for k, v in rn02.Rn02Model().state_dict().items()}
    assert shapes == ref.leaf_shapes()
    assert shapes["conv1.weight"] == (128, 65, 3) and shapes["gru1.weight_ih_l0"] == (1152, 384)
    assert sum(np.prod(s) for s in shapes.values()) == 2_884_769


def test_forward_matches_the_reference():
    model = _model()
    f = _rows(B)["features"]
    with torch.no_grad():
        gains, vad = model(f)
        want_gains, want_vad = ref.forward(dict(model.state_dict()), f)
    assert gains.shape == (B, T - 4, META.output_dim) and vad.shape == (B, T - 4, 1)
    # float32 sums in another order (a convolution as one product over the
    # frames' windows, h' by lerp): a few ulps of values in (0, 1)
    torch.testing.assert_close(gains, want_gains, rtol=0, atol=2e-6)
    torch.testing.assert_close(vad, want_vad, rtol=0, atol=2e-6)


@pytest.mark.parametrize("step,agrees", [(rn02.gru_step, True), (_reset_before_step, False)],
                         ids=["reset_after", "reset_before"])
def test_gru_layer_is_torch_nn_gru(step, agrees, monkeypatch):
    layer = _model().gru1
    gru = torch.nn.GRU(META.gru_size, META.gru_size, batch_first=True)
    gru.load_state_dict(dict(layer.items()))
    x = torch.randn((B, T, META.gru_size), generator=torch.Generator().manual_seed(3))
    monkeypatch.setattr(rn02, "gru_step", step)
    with torch.no_grad():
        want, _ = gru(x)
        got = rn02.gru_sequence(layer, x)
    # the same cell in float32 over 12 steps: round-off of ~1e-7
    assert (float((got - want).abs().max()) < 1e-6) is agrees


def test_output_t_is_scored_against_target_frame_t_plus_3():
    pred_gains = torch.full((1, T - 4, META.output_dim), 0.5, requires_grad=True)
    pred_vad = torch.full((1, T - 4, 1), 0.5, requires_grad=True)
    for frame in range(T):
        gains = torch.full((1, T, META.output_dim), -1.0)  # masked everywhere ...
        gains[0, frame] = 0.3  # ... but at one frame
        vad = torch.full((1, T, 1), 0.5)  # weight 0 everywhere ...
        vad[0, frame] = 1.0  # ... but at the same frame
        g_gains, g_vad = torch.autograd.grad(rn02.loss(pred_gains, pred_vad, gains, vad), (pred_gains, pred_vad))
        hit = [t for t in range(T - 4) if g_gains[0, t].abs().sum() > 0 or g_vad[0, t].abs().sum() > 0]
        assert hit == ([frame - 3] if 3 <= frame < T - 1 else [])


def test_loss_terms():
    pred_gains = torch.tensor([[[0.2, 0.7, 0.9]]]).expand(1, 2, 3).contiguous()
    pred_vad = torch.tensor([[[0.3], [0.8]]])
    gains = torch.zeros((1, 6, 3))
    gains[0, 3:5] = torch.tensor([[0.5, -1.0, 0.0], [1.0, 0.25, -1.0]])
    vad = torch.zeros((1, 6, 1))
    vad[0, 3:5, 0] = torch.tensor([0.5, 1.0])
    got = float(rn02.loss(pred_gains, pred_vad, gains, vad))

    p, g = pred_gains[0].double().numpy(), gains[0, 3:5].double().numpy()
    v, pv = vad[0, 3:5].double().numpy(), pred_vad[0].double().numpy()
    t = np.maximum(g, 0) * np.tanh(8 * np.maximum(g, 0)) ** 2
    mask = np.minimum(g + 1, 1)  # 0 where a gain is -1
    gain_loss = np.mean((1 + 5 * v) * mask * (p**0.25 - t**0.25) ** 2)
    bce = -v * np.log(0.01 + pv) - (1 - v) * np.log(1.01 - pv)
    vad_loss = np.mean(np.abs(2 * v - 1) * bce)  # the frame at VAD 0.5 weighs 0
    assert got == pytest.approx(gain_loss + 0.001 * vad_loss, rel=1e-6)
    assert mask[0, 1] == 0 and mask[1, 2] == 0 and np.abs(2 * v - 1)[0, 0] == 0


def test_three_adamw_steps_of_fit_match_the_reference():
    n, seed, lr, decay = 3 * B, 4, 1e-3, 0.2  # a decay that moves the learning rate by 20% a step
    data = _rows(n, seed=5)
    history = []
    got = TT.fit(*(data[k].numpy() for k in ("features", "gains", "vad")), epochs=1, batch_size=B,
                 learning_rate=lr, lr_decay=decay, seed=seed, topology=META,
                 history=history, device="cpu")
    p0 = dict(rn02.init_params(torch.Generator().manual_seed(seed), META).state_dict())
    perm = torch.as_tensor(np.random.RandomState(seed).permutation(n))
    losses, _, p_end = ref.train(p0, data, list(perm.split(B)), lr, decay)
    # float32 sums in another order (above) and AdamW's update in torch's
    # form against the one written out: ~1e-7 of a loss near 0.3, ~1e-9 of
    # parameters that three steps moved by ~3e-3
    np.testing.assert_allclose([l for _, l in history], losses.numpy(), rtol=1e-5)
    assert set(got) == set(p_end)
    for k, v in p_end.items():
        np.testing.assert_allclose(got[k], v.numpy(), rtol=1e-4, atol=1e-7, err_msg=k)
        assert np.abs(got[k] - p0[k].numpy()).max() > 1e-4, k  # every leaf moved


def test_learning_rate_decays_on_the_device_by_the_update_count():
    model = _model()
    opt = TT.make_adamw(model, 1e-3, 0.5)
    data = _rows(B)
    lrs = []
    for _ in range(3):
        TT.train_step_indexed(model, opt, data, torch.arange(B), None)
        lrs.append(float(opt.param_groups[0]["lr"]))
    assert lrs == pytest.approx([1e-3, 1e-3 / 1.5, 1e-3 / 2.0], rel=1e-6)
    assert opt.param_groups[0]["weight_decay"] == 0.01 and opt.param_groups[0]["betas"] == (0.8, 0.98)


@pytest.mark.parametrize("topology", ["rnnoise-2018", "rnnoise-0.2"])
def test_steps_mark_their_phases_only_under_marks(topology):
    if topology == "rnnoise-0.2":
        model, data = _model(), _rows(B)
        opt, seq_w = TT.make_adamw(model), None
        want = ["forward.front", "forward.gru", "forward.head", "loss", "backward", "optimizer"]
    else:
        model = TN.init_train_params(torch.Generator().manual_seed(1))
        g = torch.Generator().manual_seed(2)
        data = {"features": torch.randn((B, T, 42), generator=g), "gains": torch.rand((B, T, 22), generator=g),
                "vad": torch.rand((B, T, 1), generator=g)}
        opt, seq_w = TT.make_optimizer(model), torch.ones(B)
        want = ["forward", "loss", "backward", "optimizer"]
    TT.train_step_indexed(model, opt, data, torch.arange(B), seq_w)  # no marks kept, nothing raised
    calls = iter(range(10, 1000, 10))
    with tracing.phase_marks(lambda: next(calls)) as marks:
        TT.train_step_indexed(model, opt, data, torch.arange(B), seq_w)
    assert [name for name, _ in marks.ends] == want
    assert list(marks.nodes().items()) == [(name, 10) for name in want]
    tracing.phase("after")  # outside the block: nothing
    assert len(marks.ends) == len(want)


def test_a_phase_marked_twice_in_a_step_raises():
    with tracing.phase_marks(lambda: 1) as marks:
        tracing.phase("loss")
        tracing.phase("loss")
    with pytest.raises(ValueError, match="marked twice"):
        marks.nodes()


def test_fit_refuses_what_the_recipe_does_not_do():
    data = _rows(B)
    rows = [data[k].numpy() for k in ("features", "gains", "vad")]
    with pytest.raises(ValueError, match="no mesh, no lr_schedule"):
        TT.fit(*rows, epochs=1, batch_size=B, topology=META, lr_schedule="cosine", device="cpu")
    with pytest.raises(ValueError, match="no sample weights"):
        rn02.Rn02Model(META).batch_loss(data, torch.ones(B, T))
    with pytest.raises(ValueError, match="unknown topology"):
        TT.fit(*rows, epochs=1, batch_size=B, topology="rnnoise-0.3", device="cpu")


def test_cli_trains_and_writes_a_state_dict_for_rnnoise_0_2(tmp_path, monkeypatch):
    data = _rows(2 * B, seed=6)
    frames = torch.cat([data["features"], data["gains"], data["vad"]], -1).numpy()
    path = tmp_path / "features.f32"
    frames.astype(np.float32).tofile(path)
    features, gains, vad = rn02.load_f32(path, T, META)
    np.testing.assert_array_equal(np.concatenate([features, gains, vad], -1), frames)
    monkeypatch.setitem(TT.TOPOLOGIES, "rnnoise-0.2", dataclasses.replace(rn02.RECIPE, meta=META))  # small widths
    out = tmp_path / "weights.pth"
    TT.main(["--topology", "rnnoise-0.2", "--data", str(path), "--window", str(T), "--epochs", "1",
             "--batch-size", str(B), "--out", str(out), "--device", "cpu"])
    state = torch.load(out, weights_only=True)
    model = rn02.Rn02Model(META)
    model.load_state_dict(state)  # loads by rnnoise.py's names
    assert set(state) == set(ref.leaf_shapes(**vars(META)))


# ---- on a card -----------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _program(device, seed: int = 1):
    model = _model(seed).to(device)
    opt = TT.make_adamw(model, 1e-3, 0.2)
    data = {k: v.to(device) for k, v in _rows(4 * B).items()}
    prog = TrainProgram(lambda idx: TT.train_step_indexed(model, opt, data, idx, None), model, opt, B)
    return model, opt, data, prog


@pytest.mark.cuda
def test_rn02_graph_equals_eager_on_the_card(card):
    batches = [torch.arange(i * B, (i + 1) * B, device=card) for i in range(3)]
    model, opt, data, prog = _program(card)
    graphed = [prog(idx).clone() for idx in batches]
    assert prog.program.graph is not None and prog.program.replays == 3
    e_model, e_opt, e_data, _ = _program(card)
    eager = [TT.train_step_indexed(e_model, e_opt, e_data, idx, None) for idx in batches]
    assert torch.equal(torch.stack(graphed), torch.stack(eager))
    for (k, p), q in zip(model.named_parameters(), e_model.parameters()):
        assert torch.equal(p, q), k


def _device_ops(prof) -> list:
    cuda = torch.autograd.DeviceType.CUDA
    ops = [(e.time_range.start, e.name) for e in prof.events()
           if e.device_type == cuda and not e.is_user_annotation]
    return [name for _, name in sorted(ops)]


@pytest.mark.cuda
def test_phases_split_a_traced_replay_of_the_rn02_step(card):
    _, _, _, prog = _program(card)
    prog(torch.arange(B, device=card))  # the capture
    step = prog.program
    assert list(step.phase_nodes) == ["forward.front", "forward.gru", "forward.head", "loss", "backward", "optimizer"]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step()
        torch.cuda.synchronize()
    ops = _device_ops(prof)
    assert len(ops) == step.graph_nodes
    assert sum(step.phase_nodes.values()) <= step.graph_nodes  # the loss's copy out follows the last mark
    at, by = 0, {}
    for name, n in step.phase_nodes.items():
        by[name], at = ops[at : at + n], at + n
    assert sum(len(v) for v in by.values()) + len(ops[at:]) == len(ops)
    # the three GRUs' recurrences are kernel K8's three forward launches
    assert sum("gru_ra_fwd" in n for n in by["forward.gru"]) == 3, by["forward.gru"]
    assert len(by["backward"]) > len(by["forward.gru"])
    assert any("gemm" in n.lower() or "gemv" in n.lower() for n in by["forward.front"])


@pytest.mark.cuda
def test_a_chain_shaped_capture_replays_in_capture_order(card):
    x = torch.rand(1 << 16, device=card)
    out = torch.empty_like(x)
    kinds = [("sin", torch.sin), ("exp", torch.exp), ("cos", torch.cos), ("sqrt", torch.sqrt)]

    def step():
        for name, fn in kinds:
            for _ in range(3):
                out.copy_(fn(x))  # one kernel of the kind, one copy
            tracing.phase(name)

    from nnnoiseless_tpu_torch.programs import StepProgram

    prog = StepProgram(step, [out], card)
    prog()
    assert list(prog.phase_nodes.values()) == [6, 6, 6, 6] and prog.graph_nodes == 24
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prog()
        torch.cuda.synchronize()
    ops = _device_ops(prof)
    assert len(ops) == 24
    for i, (name, _) in enumerate(kinds):
        assert sum(name in op.lower() for op in ops[6 * i : 6 * i + 6]) == 3, ops[6 * i : 6 * i + 6]
