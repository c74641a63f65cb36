"""RNN model container and ``.rnn`` binary parser (numpy), plus the bridge
from numpy params to the port's torch module state.

The file format (reference src/rnn.rs:96-232) is a flat stream of signed
bytes: six layers (input_dense, vad_gru, noise_gru, denoise_gru,
denoise_output, vad_output), each ``<nb_inputs> <nb_neurons> <activation>``
then its weights (input-major: the weight from input ``i`` to neuron ``j``
is at ``i * nb_neurons + j``) and biases.  GRU layers hold
``input_weights[nb_inputs * 3n]``, ``recurrent_weights[n * 3n]`` and
``bias[3n]`` with the update/reset/candidate gates at offsets 0/n/2n.

This is the parser, serializer and text-format converter of
``nnnoiseless_tpu/model.py``, copied so that the port never imports the JAX
package.  Weights stay as their raw int8 values in
float32 arrays shaped for ``x @ W``; the 1/256 scale is applied to the
pre-activations (ops/rnn.py).
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Tuple

import numpy as np
import torch

TANH = 0
SIGMOID = 1
RELU = 2

_ACTIVATION_NAMES = {TANH: "tanh", SIGMOID: "sigmoid", RELU: "relu"}

# The built-in model ships inside the JAX package's assets; it is opened by
# path so that no module of that package is imported.
DEFAULT_WEIGHTS = (
    pathlib.Path(__file__).resolve().parent.parent
    / "nnnoiseless_tpu" / "assets" / "weights.rnn"
)

LAYERS = (
    "input_dense", "vad_gru", "noise_gru", "denoise_gru",
    "denoise_output", "vad_output",
)
GRU_LAYERS = ("vad_gru", "noise_gru", "denoise_gru")


class ModelParseError(ValueError):
    """Raised when model bytes are malformed, truncated, or topologically invalid."""


@dataclasses.dataclass(frozen=True)
class LayerMeta:
    nb_inputs: int
    nb_neurons: int
    activation: int


@dataclasses.dataclass(frozen=True)
class ModelMeta:
    """Hashable static description of a model (shapes + activations)."""

    input_dense: LayerMeta
    vad_gru: LayerMeta
    noise_gru: LayerMeta
    denoise_gru: LayerMeta
    denoise_output: LayerMeta
    vad_output: LayerMeta

    def acts(self) -> tuple:
        """The six activation codes in layer order (the frame kernel's)."""
        return tuple(getattr(self, n).activation for n in LAYERS)


class RnnModel:
    """A parsed model: ``params`` dict of float32 numpy arrays + ``meta``.

    ``params`` layout (the JAX package's, so the two share weights)::

        {"input_dense": {"w": (in, n), "b": (n,)},
         "vad_gru": {"wi": (in, 3n), "wr": (n, 3n), "b": (3n,)}, ...,
         "denoise_output": {"w", "b"}, "vad_output": {"w", "b"}}
    """

    def __init__(self, params: dict, meta: ModelMeta):
        self.params = params
        self.meta = meta

    @classmethod
    def from_bytes(cls, data: bytes) -> "RnnModel":
        """Parse a ``.rnn`` binary; raises ModelParseError on invalid input."""
        return _parse(np.frombuffer(data, dtype=np.int8))

    @classmethod
    def try_from_bytes(cls, data: bytes):
        """Like :meth:`from_bytes` but returns ``None`` on invalid input,
        mirroring the reference's ``Option``-returning API (rnn.rs:75)."""
        try:
            return cls.from_bytes(data)
        except ModelParseError:
            return None

    # The reference's zero-copy constructor (rnn.rs:92) is the same parse
    # here: Python has no owned-versus-borrowed distinction.
    from_static_bytes = from_bytes

    @classmethod
    def from_file(cls, path) -> "RnnModel":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())

    @classmethod
    def default(cls) -> "RnnModel":
        """The built-in 87,521-byte model."""
        return cls.from_file(DEFAULT_WEIGHTS)

    def to_bytes(self) -> bytes:
        """Serialize back to the ``.rnn`` binary format (round-trip exact);
        raises ValueError for weights that are not int8 values."""
        out = []
        for name in LAYERS:
            m = getattr(self.meta, name)
            out.append(np.array([m.nb_inputs, m.nb_neurons, m.activation], dtype=np.int8))
            for key in ("wi", "wr", "b") if name in GRU_LAYERS else ("w", "b"):
                a = np.asarray(self.params[name][key], dtype=np.float32).reshape(-1)
                ints = a.astype(np.int64)
                if not np.array_equal(ints.astype(np.float32), a) or not np.all(np.abs(ints + 0.5) < 128):
                    raise ValueError("model weights are not integer-valued int8")
                out.append(ints.astype(np.int8))
        return b"".join(a.tobytes() for a in out)


def convert_rnnoise(text: str) -> bytes:
    """Convert the 'rnnoise-nu model file version 1' text format to binary
    (train/convert_rnnoise.py: integers are taken mod 256 as raw bytes)."""
    lines = text.split("\n", 1)
    if lines[0].strip() != "rnnoise-nu model file version 1":
        raise ModelParseError("unexpected rnnoise text model header")
    return bytes(bytearray(int(v) % 256 for v in lines[1].split()))


def _parse(data: np.ndarray) -> RnnModel:
    pos = 0

    def take(n: int) -> np.ndarray:
        nonlocal pos
        if data.size - pos < n:
            raise ModelParseError("truncated model file")
        out = data[pos : pos + n]
        pos += n
        return out

    def header() -> Tuple[int, int, int]:
        nb_inputs, nb_neurons, activation = (int(v) for v in take(3))
        if nb_inputs < 0 or nb_neurons < 0:
            raise ModelParseError("negative layer size")
        if activation not in _ACTIVATION_NAMES:
            raise ModelParseError(f"unknown activation {activation}")
        return nb_inputs, nb_neurons, activation

    def mat(rows: int, cols: int) -> np.ndarray:
        return take(rows * cols).astype(np.float32).reshape(rows, cols)

    def dense():
        n_in, n, act = header()
        return {"w": mat(n_in, n), "b": take(n).astype(np.float32)}, LayerMeta(n_in, n, act)

    def gru():
        n_in, n, act = header()
        layer = {"wi": mat(n_in, 3 * n), "wr": mat(n, 3 * n),
                 "b": take(3 * n).astype(np.float32)}
        return layer, LayerMeta(n_in, n, act)

    input_dense, m_id = dense()
    vad_gru, m_vg = gru()
    noise_gru, m_ng = gru()
    denoise_gru, m_dg = gru()
    denoise_output, m_do = dense()
    vad_output, m_vo = dense()

    if pos != data.size:
        raise ModelParseError("trailing bytes after model")

    # Topology validation, identical rules to rnn.rs:196-222.
    if m_id.nb_inputs != 42 or m_do.nb_neurons != 22 or m_vo.nb_neurons != 1:
        raise ModelParseError("bad input/output sizes")
    if m_id.nb_neurons != m_vg.nb_inputs or m_vg.nb_neurons != m_vo.nb_inputs:
        raise ModelParseError("input_dense/vad_gru/vad_output size mismatch")
    if 42 + m_id.nb_neurons + m_vg.nb_neurons != m_ng.nb_inputs:
        raise ModelParseError("noise_gru input size mismatch")
    if 42 + m_vg.nb_neurons + m_ng.nb_neurons != m_dg.nb_inputs:
        raise ModelParseError("denoise_gru input size mismatch")
    if m_dg.nb_neurons != m_do.nb_inputs:
        raise ModelParseError("denoise_output input size mismatch")

    params = {
        "input_dense": input_dense,
        "vad_gru": vad_gru,
        "noise_gru": noise_gru,
        "denoise_gru": denoise_gru,
        "denoise_output": denoise_output,
        "vad_output": vad_output,
    }
    return RnnModel(params, ModelMeta(m_id, m_vg, m_ng, m_dg, m_do, m_vo))


def quantize_weights(w: np.ndarray) -> np.ndarray:
    """float weights -> int8 values, the dump_rnn.py rule:
    clip(round(256*w), -128, 127)."""
    # np.round rounds half to even, as the reference's Python round() does
    # on floats.
    return np.clip(np.round(256.0 * np.asarray(w, dtype=np.float64)), -128, 127).astype(np.int8)


def params_from_numpy(params: dict, device) -> dict:
    """The JAX package's ``RnnModel.params`` (nested dict of numpy arrays)
    as the port's module state: a flat ``state_dict`` of float32 tensors on
    ``device``, keyed ``"<layer>.<name>"`` as :class:`ops.rnn.Rnn` names its
    buffers."""
    return {
        f"{layer}.{name}": torch.as_tensor(
            np.asarray(arr, np.float32), device=device
        ).clone()
        for layer in LAYERS
        for name, arr in params[layer].items()
    }
