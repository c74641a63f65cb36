"""RNNoise 0.2's network and loss (xiph/rnnoise v0.2, ``torch/rnnoise/rnnoise.py``,
class ``RNNoise``, and ``torch/rnnoise/train_rnnoise.py``), a second topology
for the trainer beside the 2018 network of :mod:`.network`.

Per frame::

    f(65) -> Conv1d(65 -> 128, k=3, valid) tanh -> Conv1d(128 -> 384, k=3, valid) tanh = c
    c -> GRU384 -> g1 -> GRU384 -> g2 -> GRU384 -> g3
    [c, g1, g2, g3](1536) -> Linear(32) sigmoid (gains), Linear(1) sigmoid (vad)

The two valid convolutions shorten a sequence of T frames to T - 4 outputs;
the loss scores output t against target frame t + 3 (the recipe's
``gain[:, 3:-1]``).  The GRUs are ``torch.nn.GRU``'s cell, the reset gate
applied after the recurrent product (``reset_after``), gates in torch's
r, z, n order::

    r, z = sigmoid(W_ir x + b_ir + W_hr h + b_hr), sigmoid(W_iz x + b_iz + W_hz h + b_hz)
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn));   h' = (1 - z) n + z h

The parameters are named and shaped as ``rnnoise.py``'s (``conv1.weight``
(128, 65, 3), ``gru1.weight_ih_l0`` (1152, 384), ..., ``vad_dense.bias``),
so a state dict loads into that class and into ``torch.nn.GRU`` unchanged.
Everything is written out in torch ops and the port's kernels rather than
taken from ``torch.nn.GRU``/cuDNN, so that a train step is one captured graph
whose nodes the program counts, as the 2018 step is.  The three GRUs are
stacked with no feedback between them, so each layer's input product is one
product over all frames and only ``h W_hh^T`` is left inside the loop over
time: on a card kernel K8 walks it, one launch a layer forward and one
backward.
Each convolution is one product over the frames' 3-frame windows
(``unfold``), in the (batch, time, channel) layout the GRUs read.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import tracing
from ..ops import gru_reset_after
from .recipe import Recipe, adam_for_device


@dataclass(frozen=True)
class Rn02Meta:
    """The widths: features in, the first convolution's channels
    (``cond_size``), the second's and each GRU's (``gru_size``), gains out."""

    input_dim: int = 65
    cond_size: int = 128
    gru_size: int = 384
    output_dim: int = 32


RN02_META = Rn02Meta()  # train_rnnoise.py's defaults
KERNEL = 3
LOOKBACK = 3  # output t is scored against target frame t + LOOKBACK ...
LOOKAHEAD = 1  # ... and the last LOOKAHEAD frames have no output
GAMMA = 0.25  # perceptual exponent of the gain error
VAD_WEIGHT = 0.001
GRUS = ("gru1", "gru2", "gru3")
# train_rnnoise.py's optimizer: AdamW (torch's default weight decay) and
# LambdaLR(1 / (1 + LR_DECAY * step))
BETAS = (0.8, 0.98)
ADAM_EPS = 1e-8
WEIGHT_DECAY = 0.01
LR_DECAY = 5e-5  # assumed: not checked against the recipe's --lr-decay default
BATCH_SIZE = 128


def param_shapes(meta: Rn02Meta = RN02_META) -> dict:
    """``{layer: {name: shape}}`` in ``rnnoise.py``'s parameter order."""
    c, g = meta.cond_size, meta.gru_size
    gru = {"weight_ih_l0": (3 * g, g), "weight_hh_l0": (3 * g, g), "bias_ih_l0": (3 * g,), "bias_hh_l0": (3 * g,)}
    return {
        "conv1": {"weight": (c, meta.input_dim, KERNEL), "bias": (c,)},
        "conv2": {"weight": (g, c, KERNEL), "bias": (g,)},
        **{name: dict(gru) for name in GRUS},
        "dense_out": {"weight": (meta.output_dim, 4 * g), "bias": (meta.output_dim,)},
        "vad_dense": {"weight": (1, 4 * g), "bias": (1,)},
    }


class Rn02Model(nn.Module):
    """The float parameters, one ``ParameterDict`` a layer, so that the
    state_dict keys are ``rnnoise.py``'s.  Zero until :func:`init_params`
    or ``load_state_dict`` fills them."""

    def __init__(self, meta: Rn02Meta = RN02_META, device=None):
        super().__init__()
        self.meta = meta
        for layer, shapes in param_shapes(meta).items():
            setattr(self, layer, nn.ParameterDict(
                {k: nn.Parameter(torch.zeros(s, device=device)) for k, s in shapes.items()}
            ))

    def forward(self, features: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return forward(self, features)

    def batch_loss(self, batch: dict, sample_weight=None) -> torch.Tensor:
        """The 0.2 loss of a batch {features (B,T,65), gains (B,T,32), vad
        (B,T,1)}; its recipe weighs no samples."""
        if sample_weight is not None:
            raise ValueError("RNNoise 0.2's recipe takes no sample weights")
        gains_pred, vad_pred = forward(self, batch["features"])
        return loss(gains_pred, vad_pred, batch["gains"], batch["vad"])

    def post_step(self) -> None:
        """Nothing: the 0.2 recipe clips no weights."""


def init_params(generator: torch.Generator, meta: Rn02Meta = RN02_META) -> Rn02Model:
    """torch's default initialisation of Conv1d, GRU and Linear on the CPU,
    drawn from ``generator``: every tensor uniform in +-1/sqrt(fan), fan the
    input channels times the kernel (Conv1d), the hidden size (GRU) or the
    input features (Linear)."""
    model = Rn02Model(meta)
    with torch.no_grad():
        for layer, group in model.named_children():
            w = group["weight_hh_l0"] if layer in GRUS else group["weight"]
            bound = 1.0 / math.sqrt(math.prod(w.shape[1:]))
            for p in group.values():
                nn.init.uniform_(p, -bound, bound, generator=generator)
    return model


def _conv(layer, x: torch.Tensor) -> torch.Tensor:
    """A valid Conv1d over time: (B, T, C) -> (B, T - k + 1, O)."""
    w = layer["weight"]
    win = x.unfold(1, w.shape[2], 1)  # (B, T - k + 1, C, k)
    return F.linear(win.reshape(*win.shape[:2], -1), w.reshape(w.shape[0], -1), layer["bias"])


def gru_step(layer, xw: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One reset-after step from the input product ``xw`` (B, 3n) (its
    biases in) and the state ``h`` (B, n)."""
    n = h.shape[1]
    hw = F.linear(h, layer["weight_hh_l0"], layer["bias_hh_l0"])
    x_rz, x_n = xw.split((2 * n, n), 1)
    h_rz, h_n = hw.split((2 * n, n), 1)
    r, z = torch.sigmoid(x_rz + h_rz).split(n, 1)
    return torch.lerp(torch.tanh(x_n + r * h_n), h, z)


def gru_sequence(layer, x: torch.Tensor) -> torch.Tensor:
    """One GRU layer over (B, T, n) from a zero state -> its outputs (B, T, n).
    The input product is one product over all frames.  On a card the
    recurrence is kernel K8 (``ops/gru_reset_after.py``), one launch forward
    and one backward; on the CPU a loop of :func:`gru_step` over the frames
    of the input product, taken by ``unbind``, whose gradient is one stack
    (a frame taken by indexing would add a whole-sequence gradient each
    step)."""
    xws = F.linear(x, layer["weight_ih_l0"], layer["bias_ih_l0"])
    if x.is_cuda:
        return gru_reset_after.gru_sequence(xws, layer["weight_hh_l0"], layer["bias_hh_l0"])
    h = x.new_zeros((x.shape[0], layer["weight_hh_l0"].shape[1]))
    hs = []
    for xw in xws.unbind(1):
        h = gru_step(layer, xw, h)
        hs.append(h)
    return torch.stack(hs, 1)


def forward(model: Rn02Model, features: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """features (B, T, 65) -> (gains (B, T - 4, 32), vad (B, T - 4, 1)).
    Marks the phases ``forward.front``, ``forward.gru`` and ``forward.head``
    for a capture (:func:`tracing.phase`)."""
    x = torch.tanh(_conv(model.conv1, features))
    x = torch.tanh(_conv(model.conv2, x))
    tracing.phase("forward.front")
    outs = [x]
    for name in GRUS:
        outs.append(gru_sequence(getattr(model, name), outs[-1]))
    tracing.phase("forward.gru")
    cat = torch.cat(outs, -1)
    gains = torch.sigmoid(F.linear(cat, model.dense_out["weight"], model.dense_out["bias"]))
    vad = torch.sigmoid(F.linear(cat, model.vad_dense["weight"], model.vad_dense["bias"]))
    tracing.phase("forward.head")
    return gains, vad


def target_gains(gains: torch.Tensor) -> torch.Tensor:
    """The recipe's target shaping: g * tanh(8 g)^2 of the gains clamped at 0
    (the -1 "no data" sentinel becomes 0, and its band is masked)."""
    g = torch.clamp(gains, min=0.0)
    return g * torch.tanh(8.0 * g) ** 2


def loss(gains_pred: torch.Tensor, vad_pred: torch.Tensor, gains: torch.Tensor, vad: torch.Tensor) -> torch.Tensor:
    """train_rnnoise.py's loss, the mean over batch, frames and bands:
    ``mean((1 + 5 vad) min(g + 1, 1) (p^0.25 - t^0.25)^2)`` plus 0.001 x
    ``mean(|2 vad - 1| (-vad log(0.01 + p_vad) - (1 - vad) log(1.01 - p_vad)))``,
    the targets ``gains`` (B, T, 32) and ``vad`` (B, T, 1) cropped to frames
    3 .. T - 2, so that output t meets frame t + 3."""
    gains, vad = gains[:, LOOKBACK:-LOOKAHEAD], vad[:, LOOKBACK:-LOOKAHEAD]
    e = gains_pred**GAMMA - target_gains(gains) ** GAMMA
    gain_loss = ((1.0 + 5.0 * vad) * torch.clamp(gains + 1.0, max=1.0) * e**2).mean()
    bce = -vad * torch.log(0.01 + vad_pred) - (1.0 - vad) * torch.log(1.01 - vad_pred)
    vad_loss = (torch.abs(2.0 * vad - 1.0) * bce).mean()
    return gain_loss + VAD_WEIGHT * vad_loss


def numpy_params(model: Rn02Model) -> dict:
    """The state dict as numpy arrays, ``{"conv1.weight": array, ...}``."""
    return {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}


def load_f32(path, window: int = 2000, meta: Rn02Meta = RN02_META):
    """The recipe's training data: a raw float32 file of frames of
    ``input_dim`` features, ``output_dim`` gains and one VAD (98 floats),
    cut into sequences of ``window`` frames -> (features, gains, vad)."""
    dim = meta.input_dim + meta.output_dim + 1
    data = np.fromfile(path, dtype=np.float32)
    n_seq = len(data) // (window * dim)
    data = data[: n_seq * window * dim].reshape(n_seq, window, dim)
    return data[..., : meta.input_dim], data[..., meta.input_dim : -1], data[..., -1:]


def make_adamw(model: Rn02Model, learning_rate: float = 1e-3, lr_decay: float = LR_DECAY) -> torch.optim.AdamW:
    """RNNoise 0.2's optimizer (train_rnnoise.py): AdamW, betas (0.8, 0.98),
    eps 1e-8, torch's default weight decay 0.01, the learning rate
    ``learning_rate / (1 + lr_decay * n)`` after n updates (its
    ``LambdaLR``), set by the step itself on the device from AdamW's update
    count.  Device, state and learning-rate tensor as
    ``network.make_optimizer``'s."""
    opt = torch.optim.AdamW(
        # "cosine_steps": None only for the checkpoint format, whose groups
        # all carry it (train.restore_checkpoint compares it)
        [{"params": list(model.parameters()), "base_lr": learning_rate, "cosine_steps": None,
          "lr_decay": lr_decay}],
        lr=learning_rate, betas=BETAS, eps=ADAM_EPS, weight_decay=WEIGHT_DECAY,
    )
    return adam_for_device(opt, decayed_lr)


def decayed_lr(group: dict, count: torch.Tensor) -> torch.Tensor:
    """``base_lr / (1 + lr_decay * count)`` at the update count ``count``."""
    return group["base_lr"] / (1.0 + group["lr_decay"] * count)


def _one_device(mesh, lr_schedule) -> None:
    if mesh is not None or lr_schedule is not None:
        raise ValueError("rnnoise-0.2 trains on one device by its own schedule: no mesh, no lr_schedule")


# train_rnnoise.py's recipe: AdamW under its decay, no sample weights, no
# clip, batch 128, the state dict; one device, no other schedule
RECIPE = Recipe(
    meta=RN02_META,
    init=init_params,
    optimizer=lambda model, lr, cosine_steps, lr_decay: make_adamw(model, lr, lr_decay),
    sample_weights=lambda gains, device: None,
    load=load_f32,
    numpy_params=numpy_params,
    write=lambda params, path: torch.save({k: torch.from_numpy(v) for k, v in params.items()}, path),
    batch_size=BATCH_SIZE,
    out="weights.pth",
    check=_one_device,
)
