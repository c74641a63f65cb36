"""The trainer's GRU recurrence over whole sequences (nnnoiseless_tpu_torch/
ops/gru_seq.py, kernel K7 on a card) against the per-frame cell it replaces.

On the CPU: the plain forward against a loop of the Keras reset_after=False
cell frame by frame (its input product taken a frame at a time), the plain
backward against autograd through that loop and by gradcheck in float64,
the width limit, and ``sequence_forward`` against the per-frame network.

The ``cuda`` cases need a card and skip here: the kernels against the plain
versions on the card (forward outputs and every gradient), two runs bit for
bit, and the launches of a train step.  The file does not import JAX::

    NNT_TEST_PLATFORM=cuda python -m pytest tests/test_torch_gru_sequence.py -q -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

from nnnoiseless_tpu_torch.model import RELU, SIGMOID, TANH, LayerMeta
from nnnoiseless_tpu_torch.ops import gru_seq as G
from nnnoiseless_tpu_torch.training import network as TN

ACT = {"tanh": TANH, "relu": RELU, "sigmoid": SIGMOID}
LAYER_SEEDS = {24: 1, 48: 2, 96: 3}


def _layer(n: int, n_in: int, seed: int, dtype=torch.float32, device="cpu") -> dict:
    """A GRU layer's parameters as the trainer draws them: glorot wi,
    orthogonal wr, a small bias (zero in the trainer; nonzero here so it
    is exercised)."""
    gen = torch.Generator().manual_seed(seed)
    wi = torch.empty(n_in, 3 * n)
    torch.nn.init.uniform_(wi, -(6.0 / (n_in + 3 * n)) ** 0.5, (6.0 / (n_in + 3 * n)) ** 0.5, generator=gen)
    wr = torch.empty(n, 3 * n)
    torch.nn.init.orthogonal_(wr, generator=gen)
    b = 0.1 * torch.randn(3 * n, generator=gen)
    return {k: v.to(dtype=dtype, device=device) for k, v in {"wi": wi, "wr": wr, "b": b}.items()}


def _cell(layer: dict, n: int, code: int, h, x):
    """The Keras reset_after=False cell, one frame (the trainer's cell
    before the recurrence moved to whole sequences)."""
    xw = x @ layer["wi"] + layer["b"]
    hzr = h @ layer["wr"][:, : 2 * n]
    z = torch.sigmoid(xw[:, :n] + hzr[:, :n])
    r = torch.sigmoid(xw[:, n : 2 * n] + hzr[:, n:])
    hh = G.activation(xw[:, 2 * n :] + (r * h) @ layer["wr"][:, 2 * n :], code)
    return z * h + (1.0 - z) * hh


def _cell_loop(layer: dict, n: int, code: int, x):
    h = x.new_zeros((x.shape[0], n))
    hs = []
    for t in range(x.shape[1]):
        h = _cell(layer, n, code, h, x[:, t])
        hs.append(h)
    return torch.stack(hs, 1)


def _sequence(layer: dict, code: int, x):
    return G.gru_sequence(x @ layer["wi"] + layer["b"], layer["wr"], code)


@pytest.mark.parametrize("t_count", [1, 7, 200])
@pytest.mark.parametrize("n", [24, 48, 96])
@pytest.mark.parametrize("act", ["tanh", "relu"])
def test_plain_forward_matches_the_cell_loop(act, n, t_count):
    layer = _layer(n, 30, LAYER_SEEDS[n])
    x = torch.randn(4, t_count, 30, generator=torch.Generator().manual_seed(n + t_count))
    with torch.no_grad():
        got, want = _sequence(layer, ACT[act], x), _cell_loop(layer, n, ACT[act], x)
    assert got.shape == (4, t_count, n)
    # measured 0 (bit-equal with this CPU's BLAS); a product of other row
    # blocking may round the input product differently
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("act", ["tanh", "relu", "sigmoid"])
def test_plain_backward_passes_gradcheck(act):
    """The plain backward formula and the weight gradient against float64
    finite differences, through the autograd Function."""
    n, gen = 5, torch.Generator().manual_seed(7)
    xw = (0.8 * torch.randn(2, 6, 3 * n, generator=gen, dtype=torch.float64)).requires_grad_()
    wr = (0.5 * torch.randn(n, 3 * n, generator=gen, dtype=torch.float64)).requires_grad_()
    assert torch.autograd.gradcheck(lambda a, w: G.gru_sequence(a, w, ACT[act]), (xw, wr))


@pytest.mark.parametrize("n", [24, 48, 96])
@pytest.mark.parametrize("act", ["tanh", "relu"])
def test_plain_backward_matches_autograd_of_the_cell_loop(act, n):
    """dXW's consequences (the gradients of wi, b and the inputs) and dwr
    against autograd through the per-frame loop, in float32 over 50
    frames."""
    gen = torch.Generator().manual_seed(n)
    x = torch.randn(3, 50, 30, generator=gen)
    target = torch.randn(3, 50, n, generator=gen)
    grads = []
    for run in (_sequence, lambda layer, code, xx: _cell_loop(layer, n, code, xx)):
        layer = {k: v.requires_grad_() for k, v in _layer(n, 30, LAYER_SEEDS[n]).items()}
        xx = x.clone().requires_grad_()
        (run(layer, ACT[act], xx) * target).sum().backward()
        grads.append({"x": xx.grad, **{k: v.grad for k, v in layer.items()}})
    got, want = grads
    for k in want:
        scale = float(want[k].abs().max())
        # measured at most 6.9e-7 of the leaf's largest magnitude
        assert float((got[k] - want[k]).abs().max()) <= 5e-6 * scale, k


def test_width_limit_on_cuda_only():
    with pytest.raises(ValueError, match=f"n <= {G.MAX_N}"):
        G.check_width(G.MAX_N + 1, torch.device("cuda"))
    G.check_width(G.MAX_N, torch.device("cuda"))
    G.check_width(G.MAX_N + 1, torch.device("cpu"))
    n = G.MAX_N + 2  # the CPU path takes any n
    layer = _layer(n, 8, 11)
    x = torch.randn(2, 3, 8, generator=torch.Generator().manual_seed(12))
    with torch.no_grad():
        np.testing.assert_allclose(_sequence(layer, TANH, x).numpy(), _cell_loop(layer, n, TANH, x).numpy(),
                                   atol=1e-6, rtol=0)


def test_the_plain_path_launches_nothing():
    before = (G.launches, G.backward_launches)
    layer = _layer(24, 8, 13)
    x = torch.randn(2, 4, 8, generator=torch.Generator().manual_seed(14)).requires_grad_()
    _sequence(layer, TANH, x).sum().backward()
    assert (G.launches, G.backward_launches) == before


def test_sequence_forward_matches_the_frame_loop():
    """The layer-by-layer network against the per-frame network it
    replaced (every layer a frame at a time) at the recipe's widths."""
    model = TN.init_train_params(torch.Generator().manual_seed(15))
    meta, f = model.meta, torch.randn(3, 40, 42, generator=torch.Generator().manual_seed(16))
    sizes = {layer: getattr(meta, layer).nb_neurons for layer in ("vad_gru", "noise_gru", "denoise_gru")}
    h = {k: f.new_zeros((3, n)) for k, n in sizes.items()}
    gains, vads = [], []
    with torch.no_grad():
        for t in range(f.shape[1]):
            x = f[:, t]
            d = TN._dense(model.input_dense, meta.input_dense, x)
            cell = lambda name, inp: _cell(getattr(model, name), sizes[name], getattr(meta, name).activation,
                                           h[name], inp)
            h["vad_gru"] = cell("vad_gru", d)
            vads.append(TN._dense(model.vad_output, meta.vad_output, h["vad_gru"]))
            h["noise_gru"] = cell("noise_gru", torch.cat([d, h["vad_gru"], x], -1))
            h["denoise_gru"] = cell("denoise_gru", torch.cat([h["vad_gru"], h["noise_gru"], x], -1))
            gains.append(TN._dense(model.denoise_output, meta.denoise_output, h["denoise_gru"]))
        g, v = TN.sequence_forward(model, f)
    # measured 6.0e-8 (gains), 6.0e-8 (vad)
    np.testing.assert_allclose(g.numpy(), torch.stack(gains, 1).numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(v.numpy(), torch.stack(vads, 1).numpy(), atol=1e-6, rtol=0)


# ---- on a card -----------------------------------------------------------------

# (n, activation): the recipe's three layers, an odd width, the widest, sigmoid
CARD_LAYERS = [(24, "tanh"), (48, "relu"), (96, "tanh"), (37, "relu"), (128, "tanh"), (5, "sigmoid")]
CARD_SHAPES = [(32, 2000), (1, 1), (3, 5)]
H_BAR = 2e-5  # states and gates, absolute (they lie in [-1, 1] or [0, 1] and relu's in [0, ~10])
GRAD_BAR = 1e-4  # gradients, of the leaf's largest magnitude


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_run(layer: dict, code: int, x, dh, kernels: bool):
    """(H, gates, dXW, dwr) of one layer on the card, by the kernels or by
    the plain loops on the same CUDA tensors."""
    xw = (x @ layer["wi"] + layer["b"]).contiguous()
    if kernels:
        h, gates = G.forward_cuda(xw, layer["wr"], code)
        dxw = G.backward_cuda(dh, h, gates, layer["wr"], code)
    else:
        h, gates = G.forward_plain(xw, layer["wr"], code)
        dxw = G.backward_plain(dh, h, gates, layer["wr"], code)
    return h, gates, dxw, G._weight_grad(dxw, h, gates)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: f"B{s[0]}xT{s[1]}")
@pytest.mark.parametrize("n,act", CARD_LAYERS)
def test_kernels_match_plain_on_the_card(card, n, act, shape):
    b, t = shape
    gen = torch.Generator().manual_seed(100 + n)
    layer = _layer(n, 42, n, device=card)
    x = torch.randn(b, t, 42, generator=gen).to(card)
    dh = (0.1 * torch.randn(b, t, n, generator=gen)).to(card)
    with torch.no_grad():
        got = _card_run(layer, ACT[act], x, dh, kernels=True)
        want = _card_run(layer, ACT[act], x, dh, kernels=False)
    for name, a, w in zip(("h", "gates"), got[:2], want[:2]):
        assert float((a - w).abs().max()) <= H_BAR, name
    for name, a, w in zip(("dxw", "dwr"), got[2:], want[2:]):
        assert float((a - w).abs().max()) <= GRAD_BAR * float(w.abs().max()), name


@pytest.mark.cuda
def test_kernels_repeat_bit_for_bit_on_the_card(card):
    gen = torch.Generator().manual_seed(200)
    layer = _layer(96, 114, 3, device=card)
    x = torch.randn(32, 300, 114, generator=gen).to(card)
    dh = torch.randn(32, 300, 96, generator=gen).to(card)
    with torch.no_grad():
        first, second = (_card_run(layer, TANH, x, dh, kernels=True) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_wider_layer_raises_on_the_card(card):
    n = G.MAX_N + 1
    with pytest.raises(ValueError, match=f"n <= {G.MAX_N}"):
        G.gru_sequence(torch.zeros(1, 2, 3 * n, device=card), torch.zeros(n, 3 * n, device=card), TANH)
    with pytest.raises(ValueError, match=f"n <= {G.MAX_N}"):
        wide = dataclasses.replace(TN.DEFAULT_META, denoise_gru=LayerMeta(114, n, TANH),
                                   denoise_output=LayerMeta(n, 22, SIGMOID))
        TN.sequence_forward(TN.TrainableModel(wide, device=card), torch.zeros(1, 2, 42, device=card))


@pytest.mark.cuda
def test_a_train_step_launches_three_forward_three_backward(card):
    """The network's three GRUs go through the kernels: 3 launches in the
    forward, 3 more in the backward."""
    model = TN.init_train_params(torch.Generator().manual_seed(17)).to(card)
    f = torch.randn(4, 30, 42, generator=torch.Generator().manual_seed(18)).to(card)
    before, before_bwd = G.launches, G.backward_launches
    gains, vad = TN.sequence_forward(model, f)
    assert (G.launches - before, G.backward_launches - before_bwd) == (3, 0)
    (gains.sum() + vad.sum()).backward()
    torch.cuda.synchronize()
    assert (G.launches - before, G.backward_launches - before_bwd) == (6, 3)
