"""RNNoise 0.2's reset-after GRU recurrence over whole sequences
(nnnoiseless_tpu_torch/ops/gru_reset_after.py, kernel K8 on a card) against
the per-frame cell it replaces, ``training/rn02.py``'s ``gru_step``, and
``torch.nn.GRU``.

On the CPU: the plain forward against a loop of ``gru_step`` (its input
product taken over all frames, as ``rn02.gru_sequence`` does) and against
``torch.nn.GRU``; the plain backward by gradcheck in float64 and against
autograd through the per-frame loop, ``W_hh``'s and ``b_hh``'s gradients
included; the width limit; no launches.

The ``cuda`` cases need a card and skip here: the kernels against the plain
loops (on the card's host) at the benchmark cell's shape, at the rn02 tests'
small shape, at B = 1, T = 1, at a B that leaves a cluster part-filled, at
widths that pad to the kernels' 384 (one not a multiple of 4) and at a B
that needs more than one wave of clusters; two runs bit for bit; the width and operand
errors; and the launches of a captured rn02 train step.
The file does not import JAX::

    NNT_TEST_PLATFORM=cuda python -m pytest tests/test_torch_gru_reset_after.py -q -m cuda
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nnnoiseless_tpu_torch.ops import gru_reset_after as G
from nnnoiseless_tpu_torch.training import rn02


def _layer(n: int, n_in: int, seed: int, dtype=torch.float32, device="cpu") -> dict:
    """A ``torch.nn.GRU`` layer's parameters by its default initialisation
    (uniform in +-1/sqrt(n)), named as ``rn02``'s are."""
    gen = torch.Generator().manual_seed(seed)
    bound = n**-0.5
    shapes = {"weight_ih_l0": (3 * n, n_in), "weight_hh_l0": (3 * n, n), "bias_ih_l0": (3 * n,),
              "bias_hh_l0": (3 * n,)}
    return {k: ((torch.rand(s, generator=gen) * 2 - 1) * bound).to(dtype=dtype, device=device)
            for k, s in shapes.items()}


def _step_loop(layer: dict, x):
    """rn02's per-frame recurrence: ``gru_step`` frame by frame over the input
    product of all frames."""
    h = x.new_zeros((x.shape[0], layer["weight_hh_l0"].shape[1]))
    hs = []
    for xw in F.linear(x, layer["weight_ih_l0"], layer["bias_ih_l0"]).unbind(1):
        h = rn02.gru_step(layer, xw, h)
        hs.append(h)
    return torch.stack(hs, 1)


def _sequence(layer: dict, x):
    return G.gru_sequence(F.linear(x, layer["weight_ih_l0"], layer["bias_ih_l0"]), layer["weight_hh_l0"],
                          layer["bias_hh_l0"])


@pytest.mark.parametrize("t_count", [1, 7, 200])
@pytest.mark.parametrize("n", [24, 384])
def test_plain_forward_matches_the_step_loop_and_torch_gru(n, t_count):
    layer = _layer(n, 30, n + t_count)
    x = torch.randn(4, t_count, 30, generator=torch.Generator().manual_seed(n * t_count))
    gru = torch.nn.GRU(30, n, batch_first=True)
    gru.load_state_dict(layer)
    with torch.no_grad():
        got, loop, (want, _) = _sequence(layer, x), _step_loop(layer, x), gru(x)
    assert got.shape == (4, t_count, n)
    # the same arithmetic as the loop, op for op: bit-equal
    assert torch.equal(got, loop)
    # torch.nn.GRU sums in another order: float32 round-off, measured at most
    # 1.9e-7 over 200 frames
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6, rtol=0)


def test_plain_backward_passes_gradcheck():
    """The plain backward and the weight and bias gradients against float64
    finite differences, through the autograd Function."""
    n, gen = 5, torch.Generator().manual_seed(7)
    xw = (0.8 * torch.randn(2, 6, 3 * n, generator=gen, dtype=torch.float64)).requires_grad_()
    w_hh = (0.5 * torch.randn(3 * n, n, generator=gen, dtype=torch.float64)).requires_grad_()
    b_hh = (0.3 * torch.randn(3 * n, generator=gen, dtype=torch.float64)).requires_grad_()
    assert torch.autograd.gradcheck(G.gru_sequence, (xw, w_hh, b_hh))


@pytest.mark.parametrize("n", [24, 96])
def test_plain_backward_matches_autograd_of_the_step_loop(n):
    """Every leaf's gradient (the inputs, W_ih, b_ih through dXW; W_hh, b_hh)
    against autograd through the per-frame loop, in float32 over 50 frames."""
    gen = torch.Generator().manual_seed(n)
    x = torch.randn(3, 50, 30, generator=gen)
    target = torch.randn(3, 50, n, generator=gen)
    grads = []
    for run in (_sequence, _step_loop):
        layer = {k: v.requires_grad_() for k, v in _layer(n, 30, n).items()}
        xx = x.clone().requires_grad_()
        (run(layer, xx) * target).sum().backward()
        grads.append({"x": xx.grad, **{k: v.grad for k, v in layer.items()}})
    got, want = grads
    for k in want:
        scale = float(want[k].abs().max())
        # measured at most 4.6e-7 of the leaf's largest magnitude
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
        assert torch.equal(_sequence(layer, x), _step_loop(layer, x))


def test_the_plain_path_launches_nothing():
    before = (G.launches, G.backward_launches)
    layer = {k: v.requires_grad_() for k, v in _layer(24, 8, 13).items()}
    x = torch.randn(2, 4, 8, generator=torch.Generator().manual_seed(14)).requires_grad_()
    _sequence(layer, x).sum().backward()
    assert (G.launches, G.backward_launches) == before
    assert all(v.grad is not None for v in layer.values())


# ---- on a card -----------------------------------------------------------------

# (B, T, n): the benchmark cell's, the rn02 tests', a single frame, a B that
# leaves a cluster part-filled, two more widths padded to 384 (37 takes the
# scalar loads), and a B past what the seated clusters hold at their most
# sequences (the clusters then run in more than one wave)
CARD_SHAPES = [(128, 1996, 384), (3, 12, 24), (1, 1, 384), (1, 1, 24), (130, 40, 384), (5, 30, 37),
               (70, 25, 150), (250, 6, 384)]
H_BAR = 2e-5  # states and gates, absolute (they lie in [-1, 1] or [0, 1]; hn within a few units)
GRAD_BAR = 1e-4  # gradients, of the leaf's largest magnitude


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_inputs(card, b: int, t: int, n: int, seed: int):
    gen = torch.Generator().manual_seed(seed)
    layer = _layer(n, 64, seed)
    x = torch.randn(b, t, 64, generator=gen)
    xw = F.linear(x, layer["weight_ih_l0"], layer["bias_ih_l0"])
    dh = 0.1 * torch.randn(b, t, n, generator=gen)
    return [a.contiguous().to(card) for a in (xw, layer["weight_hh_l0"], layer["bias_hh_l0"], dh)]


def _kernel_run(xw, w_hh, b_hh, dh):
    h, gates = G.forward_cuda(xw, w_hh, b_hh)
    dxw, dhw = G.backward_cuda(dh, h, gates, w_hh)
    return (h, gates, dxw, dhw, *G._weight_grads(dhw, h))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "B{}xT{}xn{}".format(*s))
def test_kernels_match_plain_on_the_card(card, shape):
    b, t, n = shape
    args = _card_inputs(card, b, t, n, 100 + n)
    with torch.no_grad():
        got = [a.cpu() for a in _kernel_run(*args)]
        xw, w_hh, b_hh, dh = (a.cpu() for a in args)
        h, gates = G.forward_plain(xw, w_hh, b_hh)
        dxw, dhw = G.backward_plain(dh, h, gates, w_hh)
        want = (h, gates, dxw, dhw, *G._weight_grads(dhw, h))
    for name, a, w in zip(("h", "gates"), got[:2], want[:2]):
        assert float((a - w).abs().max()) <= H_BAR, name
    for name, a, w in zip(("dxw", "dhw", "dw_hh", "db_hh"), got[2:], want[2:]):
        assert float((a - w).abs().max()) <= GRAD_BAR * float(w.abs().max()), name
    plan = G.last_plan
    assert plan["sequences"] * plan["clusters"] >= b and plan["clusters"] <= -(-b // plan["sequences"])


@pytest.mark.cuda
def test_kernels_repeat_bit_for_bit_on_the_card(card):
    args = _card_inputs(card, 130, 300, 384, 200)
    with torch.no_grad():
        first, second = (_kernel_run(*args) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_wider_layer_and_other_operands_raise_on_the_card(card):
    n = G.MAX_N + 1
    with pytest.raises(ValueError, match=f"n <= {G.MAX_N}"):
        G.gru_sequence(torch.zeros(1, 2, 3 * n, device=card), torch.zeros(3 * n, n, device=card),
                       torch.zeros(3 * n, device=card))
    xw, w_hh, b_hh, _ = _card_inputs(card, 2, 3, 24, 1)
    with pytest.raises(ValueError, match="float32"):
        G.gru_sequence(xw.double(), w_hh.double(), b_hh.double())
    with pytest.raises(ValueError, match="contiguous"):
        G.gru_sequence(xw.transpose(0, 1).contiguous().transpose(0, 1), w_hh, b_hh)
    with pytest.raises(ValueError, match="CPU tensors"):
        G.forward_plain(xw, w_hh, b_hh)


@pytest.mark.cuda
def test_a_captured_rn02_step_launches_three_forward_three_backward(card):
    """The captured train step of RNNoise 0.2 holds the three GRUs' kernels:
    3 forward launches and 3 backward, and they replay once a step."""
    from nnnoiseless_tpu_torch.programs import TrainProgram
    from nnnoiseless_tpu_torch.training import train as TT

    meta = rn02.Rn02Meta(input_dim=65, cond_size=16, gru_size=24, output_dim=32)
    model = rn02.init_params(torch.Generator().manual_seed(1), meta).to(card)
    opt = TT.make_adamw(model, 1e-3, 0.2)
    g = torch.Generator().manual_seed(2)
    data = {"features": torch.randn((6, 12, 65), generator=g).to(card),
            "gains": torch.rand((6, 12, 32), generator=g).to(card),
            "vad": (torch.rand((6, 12, 1), generator=g) < 0.5).float().to(card)}
    prog = TrainProgram(lambda idx: TT.train_step_indexed(model, opt, data, idx, None), model, opt, 3)
    prog(torch.arange(3, device=card))  # the warm-up and the capture
    assert prog.program.captured == {"K8": 6, "K8 backward": 3}
    before = (G.launches, G.backward_launches)
    prog(torch.arange(3, 6, device=card))
    torch.cuda.synchronize()
    assert (G.launches - before[0], G.backward_launches - before[1]) == (6, 3)
