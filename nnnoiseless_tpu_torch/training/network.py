"""Float training-mode network (the Keras model of train/rnn_train.py:65-77).

Topology (all GRUs ``reset_after=False``, recurrent activation sigmoid)::

    f(42) -> Dense24 tanh -> GRU24 tanh -> Dense1 sigmoid   (vad)
    [d, vad_h, f](90)  -> GRU48 relu
    [vad_h, noise_h, f](114) -> GRU96 tanh -> Dense22 sigmoid (gains)

The counterpart of ``nnnoiseless_tpu/training/network.py``.  Differences
from the inference path (ops/rnn.py): float32 weights with true
tanh/sigmoid/relu (training wants smooth gradients; the 201-entry tansig
table is an inference-time artifact), and whole sequences at once.  The
weights keep the serialized layout, ``(in, out)`` for ``x @ w`` with the
update/reset/candidate gates at column offsets 0/n/2n, so quantization
gives a loadable ``.rnn``.

The layers run one after another over all frames, not frame by frame: no
layer reads a later frame of another, so each dense layer and each GRU's
input product is one product over all (B, T) rows, and only a GRU's
recurrence walks the frames (``ops/gru_seq.py``: kernel K7 on a card, the
plain loop on the CPU).

The cell is written out rather than taken from ``torch.nn.GRU``/cuDNN:
those apply the reset gate after the recurrent product,
``r * (h W_hn + b_hn)``, where Keras ``reset_after=False`` applies it
before, ``(r * h) @ wr[:, 2n:]``.  That is another function, and its
weights would not export.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .. import tracing
from ..model import (
    GRU_LAYERS,
    LAYERS,
    RELU,
    SIGMOID,
    TANH,
    LayerMeta,
    ModelMeta,
    RnnModel,
    quantize_weights,
)
from ..ops.gru_seq import activation, gru_sequence
from .losses import l2_regularization, total_loss

DEFAULT_META = ModelMeta(
    input_dense=LayerMeta(42, 24, TANH),
    vad_gru=LayerMeta(24, 24, TANH),
    noise_gru=LayerMeta(90, 48, RELU),
    denoise_gru=LayerMeta(114, 96, TANH),
    denoise_output=LayerMeta(96, 22, SIGMOID),
    vad_output=LayerMeta(24, 1, SIGMOID),
)

WEIGHT_CLIP = 0.499  # rnn_train.py:62 WeightClip constraint


def _layer_shapes(layer: str, m: LayerMeta) -> dict:
    if layer in GRU_LAYERS:
        n = m.nb_neurons
        return {"wi": (m.nb_inputs, 3 * n), "wr": (n, 3 * n), "b": (3 * n,)}
    return {"w": (m.nb_inputs, m.nb_neurons), "b": (m.nb_neurons,)}


class TrainableModel(nn.Module):
    """The float parameters, one ``ParameterDict`` a layer, so that the
    state_dict keys are ``"<layer>.<name>"`` (``input_dense.w``,
    ``vad_gru.wi``, ...) as ``model.params_from_numpy`` makes them from the
    JAX package's params.  Zero until :func:`init_train_params` or
    ``load_state_dict`` fills them."""

    def __init__(self, meta: ModelMeta = DEFAULT_META, device=None):
        super().__init__()
        self.meta = meta
        for layer in LAYERS:
            shapes = _layer_shapes(layer, getattr(meta, layer))
            setattr(self, layer, nn.ParameterDict(
                {k: nn.Parameter(torch.zeros(s, device=device)) for k, s in shapes.items()}
            ))

    def forward(self, features: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return sequence_forward(self, features)

    def batch_loss(self, batch: dict, sample_weight=None) -> torch.Tensor:
        """The 2018 recipe's loss of a batch {features (B,T,42), gains
        (B,T,22), vad (B,T,1)}: ``total_loss`` + ``l2_regularization``."""
        gains_pred, vad_pred = sequence_forward(self, batch["features"])
        tracing.phase("forward")
        return total_loss(batch["gains"], gains_pred, batch["vad"], vad_pred, sample_weight) \
            + l2_regularization(self)

    def post_step(self) -> None:
        clip_params(self)  # Keras WeightClip(0.499) constraint


def init_train_params(generator: torch.Generator, meta: ModelMeta = DEFAULT_META) -> TrainableModel:
    """Keras-style init on the CPU, drawn from ``generator``: glorot-uniform
    kernels (limit sqrt(6 / (fan_in + fan_out))), orthogonal recurrent
    kernels (an (n, 3n) matrix with orthonormal rows), zero biases."""
    model = TrainableModel(meta)
    with torch.no_grad():
        for layer in LAYERS:
            for name, p in getattr(model, layer).items():
                if name == "wr":
                    nn.init.orthogonal_(p, generator=generator)
                elif name != "b":
                    limit = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
                    nn.init.uniform_(p, -limit, limit, generator=generator)
    return model


@torch.no_grad()
def clip_params(model: TrainableModel) -> None:
    """Apply the Keras WeightClip(0.499) constraint to every tensor, biases
    too, in place."""
    for p in model.parameters():
        p.clamp_(-WEIGHT_CLIP, WEIGHT_CLIP)


def numpy_params(model: TrainableModel) -> dict:
    """The parameters as numpy arrays in the JAX package's layout:
    ``{layer: {name: array}}``."""
    return {
        layer: {k: v.detach().cpu().numpy().copy() for k, v in getattr(model, layer).items()}
        for layer in LAYERS
    }


def _dense(layer, m: LayerMeta, x):
    return activation(x @ layer["w"] + layer["b"], m.activation)


def _gru(layer, m: LayerMeta, x):
    """A Keras reset_after=False GRU over whole sequences: x (B, T, in) ->
    states (B, T, n) from a zero state."""
    return gru_sequence(x @ layer["wi"] + layer["b"], layer["wr"], m.activation)


def sequence_forward(model: TrainableModel, features: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward a batch of sequences: features (B, T, 42) -> (gains (B, T, 22),
    vad (B, T, 1)), one layer at a time over all frames."""
    meta = model.meta
    d = _dense(model.input_dense, meta.input_dense, features)
    h_vad = _gru(model.vad_gru, meta.vad_gru, d)
    vad = _dense(model.vad_output, meta.vad_output, h_vad)
    h_noise = _gru(model.noise_gru, meta.noise_gru, torch.cat([d, h_vad, features], -1))
    h_den = _gru(model.denoise_gru, meta.denoise_gru, torch.cat([h_vad, h_noise, features], -1))
    return _dense(model.denoise_output, meta.denoise_output, h_den), vad


def export_model(params, meta: ModelMeta | None = None) -> RnnModel:
    """Quantize float params to int8 and wrap them as a loadable RnnModel,
    by the rule of train/dump_rnn.py: clip(round(256 w), -128, 127).

    ``params``: a :class:`TrainableModel` (its meta is used), or numpy
    params in the JAX package's layout (``meta`` defaults to DEFAULT_META).
    """
    if isinstance(params, nn.Module):
        meta = meta or params.meta
        params = numpy_params(params)
    q = {
        name: {k: quantize_weights(np.asarray(v)).astype(np.float32) for k, v in layer.items()}
        for name, layer in params.items()
    }
    return RnnModel(q, meta or DEFAULT_META)
