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
import pathlib

import numpy as np
import torch
from torch import nn

from .. import tracing
from ..constants import NB_BANDS, NB_FEATURES
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
from .recipe import Recipe, adam_for_device

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


def make_optimizer(model: TrainableModel, learning_rate: float = 1e-3,
                   cosine_steps: int | None = None) -> torch.optim.Adam:
    """Adam with optax's ``adam`` defaults (b1 0.9, b2 0.999, eps 1e-8), set
    up for the device of ``model``'s parameters (move the model first).

    On a card it is ``capturable``: its update count and bias corrections
    stay on the device, so a step can be captured in a CUDA graph
    (``programs.TrainProgram``), and the eager steps run the same
    arithmetic.  On the CPU it is not (capturable Adam refuses CPU
    tensors).  Adam's state (``step``, ``exp_avg``, ``exp_avg_sq``) is
    created here, zero, so that a captured step finds it in place.

    The learning rate is a 0-d float32 tensor on that device,
    ``opt.param_groups[0]["lr"]``, which every step reads (optax's
    ``inject_hyperparams``).  To change it mid-run, write the tensor in
    place: ``opt.param_groups[0]["lr"].fill_(new_lr)``.  Assigning a new
    float or tensor to the group instead would not reach a step already
    captured.  With ``cosine_steps`` the step itself sets it before each
    update to ``optax.cosine_decay_schedule(learning_rate,
    cosine_steps)`` (alpha 0) at Adam's own update count, computed on the
    device, so the first update uses the schedule at 0, as optax's does.
    """
    opt = torch.optim.Adam(
        [{"params": list(model.parameters()), "base_lr": learning_rate, "cosine_steps": cosine_steps}],
        lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
    )
    return adam_for_device(opt, None if cosine_steps is None else cosine_lr)


def cosine_lr(group: dict, count: torch.Tensor) -> torch.Tensor:
    """optax's cosine decay of ``base_lr`` to 0 over ``cosine_steps`` at the
    update count ``count``."""
    steps = group["cosine_steps"]
    return group["base_lr"] * (0.5 * (1.0 + torch.cos(math.pi * count.clamp(max=steps) / steps)))


def compute_sample_weights(gains: np.ndarray) -> np.ndarray:
    """Tertile reweighting by per-sequence mean gain (rnn_train.py:108-118)."""
    y = gains.reshape(gains.shape[0], -1)
    masked = np.ma.masked_equal(y, -1.0)
    means = masked.mean(axis=1).filled(np.nan)
    hi = means > 2 / 3
    lo = means < 1 / 3
    med = ~hi & ~lo & ~np.isnan(means)
    total = np.sum(~np.isnan(means))
    w = np.zeros(len(means))
    for m in (hi, med, lo):
        n = max(m.sum(), 1)
        w += m * (total / n)
    return (w / 3.0).astype(np.float32)


def load_h5(path: str, window: int = 2000):
    """Load the 87-column HDF5 produced by the data generator.

    Layout per row: 42 features | 22 gains | 22 noise levels | 1 vad
    (reference src/training.rs:90-94, 155-159).  Needs ``h5py``.
    """
    import h5py

    with h5py.File(path, "r") as f:
        data = np.asarray(f["data"], np.float32)
    n_seq = len(data) // window
    data = data[: n_seq * window]
    features = data[:, :NB_FEATURES].reshape(n_seq, window, NB_FEATURES)
    gains = data[:, NB_FEATURES : NB_FEATURES + NB_BANDS].reshape(n_seq, window, NB_BANDS)
    vad = data[:, NB_FEATURES + 2 * NB_BANDS :].reshape(n_seq, window, 1)
    return features, gains, vad


# train/rnn_train.py's recipe: Adam (constant or cosine), the tertile sample
# weights, the weight clip (``post_step``), batch 32, the int8 export
RECIPE = Recipe(
    meta=DEFAULT_META,
    init=init_train_params,
    optimizer=lambda model, lr, cosine_steps, lr_decay: make_optimizer(model, lr, cosine_steps),
    sample_weights=lambda gains, device: torch.as_tensor(compute_sample_weights(gains), device=device),
    load=load_h5,
    numpy_params=numpy_params,
    write=lambda params, path: pathlib.Path(path).write_bytes(export_model(params).to_bytes()),
    batch_size=32,
    out="weights.rnn",
)
