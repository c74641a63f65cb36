"""The noise-suppression RNN: dense layers + three RNNoise-style GRUs.

Reference compute (src/rnn.rs:242-379): pre-activations accumulate the raw
int8 weight values against f32 inputs and are scaled by 1/256 before the
table activation; the GRU is Keras ``reset_after=False`` with the reset gate
pre-multiplied by the state (rnn.rs:310-312).  Per frame::

    d = dense(f); vad_h = gru(d); vad = dense(vad_h)
    noise_h = gru([d, vad_h, f]); den_h = gru([vad_h, noise_h, f])
    gains = dense(den_h)
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..constants import WEIGHTS_SCALE
from ..model import GRU_LAYERS, LAYERS, RELU, SIGMOID, TANH, ModelMeta, params_from_numpy
from . import rnn_kernel
from .activations import relu, sigmoid_approx, tansig_approx
from .rnn_kernel import DIMS


def activate(x: torch.Tensor, activation: int) -> torch.Tensor:
    if activation == TANH:
        return tansig_approx(x)
    if activation == SIGMOID:
        return sigmoid_approx(x)
    if activation == RELU:
        return relu(x)
    raise ValueError(f"unknown activation {activation}")


class RnnState(NamedTuple):
    """The three GRU hidden states (leading axes = batch)."""

    vad: torch.Tensor
    noise: torch.Tensor
    denoise: torch.Tensor


class Rnn(nn.Module):
    """The six layers of a model as buffers (int8 values held as f32).

    Built from the numpy params of :class:`model.RnnModel` (or the JAX
    package's, which share the layout) by :meth:`from_params`.
    """

    def __init__(self, meta: ModelMeta):
        super().__init__()
        self.meta = meta
        for name in LAYERS:
            m = getattr(meta, name)
            shapes = (
                {"wi": (m.nb_inputs, 3 * m.nb_neurons),
                 "wr": (m.nb_neurons, 3 * m.nb_neurons), "b": (3 * m.nb_neurons,)}
                if name in GRU_LAYERS
                else {"w": (m.nb_inputs, m.nb_neurons), "b": (m.nb_neurons,)}
            )
            layer = nn.Module()
            for key, shape in shapes.items():
                layer.register_buffer(key, torch.zeros(shape))
            self.add_module(name, layer)

    @classmethod
    def from_params(cls, params: dict, meta: ModelMeta, device) -> "Rnn":
        rnn = cls(meta).to(device)
        rnn.load_state_dict(params_from_numpy(params, device))
        return rnn

    def standard_topology(self) -> bool:
        m, d = self.meta, DIMS
        return (
            m.input_dense.nb_inputs == d["f"]
            and m.input_dense.nb_neurons == d["d"]
            and m.vad_gru.nb_neurons == d["v"]
            and m.noise_gru.nb_neurons == d["n"]
            and m.denoise_gru.nb_neurons == d["h"]
            and m.denoise_output.nb_neurons == d["g"]
        )

    def _dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        layer = getattr(self, name)
        pre = (layer.b + torch.matmul(x, layer.w)) * WEIGHTS_SCALE
        return activate(pre, getattr(self.meta, name).activation)

    def _gru(self, name: str, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        layer = getattr(self, name)
        n = getattr(self.meta, name).nb_neurons
        gi = torch.matmul(x, layer.wi)
        rzr = torch.matmul(h, layer.wr[:, : 2 * n])
        b = layer.b
        z = sigmoid_approx(WEIGHTS_SCALE * (b[:n] + gi[..., :n] + rzr[..., :n]))
        r = h * sigmoid_approx(
            WEIGHTS_SCALE * (b[n : 2 * n] + gi[..., n : 2 * n] + rzr[..., n:])
        )
        hh = activate(
            WEIGHTS_SCALE * (b[2 * n :] + gi[..., 2 * n :] + torch.matmul(r, layer.wr[:, 2 * n :])),
            getattr(self.meta, name).activation,
        )
        return z * h + (1.0 - z) * hh

    def forward(self, state: RnnState, features: torch.Tensor):
        """One frame: returns (new_state, gains (..., 22), vad (...))."""
        d = self._dense("input_dense", features)
        vad_h = self._gru("vad_gru", state.vad, d)
        vad = self._dense("vad_output", vad_h)
        noise_h = self._gru("noise_gru", state.noise, torch.cat([d, vad_h, features], -1))
        den_h = self._gru("denoise_gru", state.denoise, torch.cat([vad_h, noise_h, features], -1))
        gains = self._dense("denoise_output", den_h)
        return RnnState(vad_h, noise_h, den_h), gains, vad[..., 0]


def rnn_step(rnn: Rnn, state: RnnState, features: torch.Tensor, weights: tuple | None = None):
    """One frame of (B, ...) streams: (new_state, gains (B, 22), vad (B,)).

    The dispatch of ``nnnoiseless_tpu/ops/rnn.py::rnn_step``: a
    standard-topology model on CUDA tensors runs kernel K5
    (ops/rnn_kernel.py) with ``weights`` (its ``pack_tiled``, packed here
    when None); any other topology runs :meth:`Rnn.forward` on any device,
    as the JAX package does; CPU tensors run :meth:`Rnn.forward`.
    """
    if features.is_cuda and rnn.standard_topology():
        if weights is None:
            weights = rnn_kernel.pack_tiled(rnn, features.device)
        hv, hn, hd, gains, vad = rnn_kernel.rnn_step_cuda(weights, *state, features)
        return RnnState(hv, hn, hd), gains, vad
    if features.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {features.device}")
    return rnn(state, features)
