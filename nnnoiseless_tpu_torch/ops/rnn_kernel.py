"""Kernel K5: one step of the whole RNN cell for a batch of streams.

Replaces ``nnnoiseless_tpu/ops/rnn_pallas.py::rnn_step_pallas`` (body
``_rnn_pallas``).  :func:`pack_weights` gathers a model's int8 weights
(one buffer in layer order, offsets, activation codes); :func:`pack_tiled`
lays them out as kernels K2 and K5 take them (the tiled layout
:data:`TILED`), and :func:`check_tiled` holds a kernel's operands to it.
:func:`rnn_step_cuda` launches ``csrc/rnn_kernel.cu`` (stages in
``csrc/rnn_tile.cuh``, which K2 runs too); its plain version is
``ops/rnn.py::Rnn.forward``, and ``ops/rnn.py::rnn_step`` picks between the
two.  :func:`rnn_step_staged` is a plain mirror of the tiles' summing order
(K5's at a batch, or K2's tile), for the tests.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..constants import WEIGHTS_SCALE
from ..model import RELU, SIGMOID, TANH
from .activations import relu, sigmoid_approx, tansig_approx, tansig_table

# Kernel launches since the last reset (the plain version does not count).
launches = 0

# widths of the standard topology, the one the kernels are built for
DIMS = dict(f=42, d=24, v=24, n=48, h=96, g=22)

_WEIGHT_ORDER = (
    ("input_dense", "w"), ("input_dense", "b"),
    ("vad_gru", "wi"), ("vad_gru", "wr"), ("vad_gru", "b"),
    ("noise_gru", "wi"), ("noise_gru", "wr"), ("noise_gru", "b"),
    ("denoise_gru", "wi"), ("denoise_gru", "wr"), ("denoise_gru", "b"),
    ("denoise_output", "w"), ("denoise_output", "b"),
    ("vad_output", "w"), ("vad_output", "b"),
)

# K5's chunks in stage order; each weight matrix is (inputs, outputs) with
# its outputs padded to a multiple of 4, a GRU's wi and wr stacked.
_CHUNKS = (
    ("input_dense", ("w", "b")),
    ("vad_gru", ("wi", "wr", "b")),
    ("vad_output", ("w", "b")),
    ("noise_gru", ("wi", "wr", "b")),
    ("denoise_gru", ("wi", "wr", "b")),
    ("denoise_output", ("w", "b")),
)
_SHAPES = {  # (rows, outputs) of each part at the standard widths
    "input_dense": (42, 24), "vad_gru": (24, 72), "vad_output": (24, 1),
    "noise_gru": (90, 144), "denoise_gru": (114, 288), "denoise_output": (96, 22),
}
_RECURRENT = {"vad_gru": 24, "noise_gru": 48, "denoise_gru": 96}


def _tiled_layout():
    """([(layer, name, byte offset, rows, outputs, padded outputs)], chunk
    offsets, total bytes): the layout of csrc/rnn_kernel.cu's CHUNK_OFF."""
    parts, chunks, off = [], [], 0
    for layer, names in _CHUNKS:
        chunks.append(off)
        rows, cols = _SHAPES[layer]
        for name in names:
            r = {"w": rows, "wi": rows, "wr": _RECURRENT.get(layer, 0), "b": 1}[name]
            pad = cols if name == "b" else -(-cols // 4) * 4
            parts.append((layer, name, off, r, cols, pad))
            off += r * pad
        off = -(-off // 16) * 16
    return parts, tuple(chunks), off


TILED, TILED_CHUNKS, TILED_BYTES = _tiled_layout()  # 87,808 bytes


def pack_weights(rnn, device: torch.device):
    """An ``ops.rnn.Rnn``'s weights gathered: (int8 weights concatenated
    in layer order, int32 offsets, int32 activation codes) on ``device``.
    Every weight of a ``.rnn`` model is an int8 value, so int8 storage is
    exact; other weights raise."""
    parts = [getattr(rnn, layer).get_buffer(name).reshape(-1) for layer, name in _WEIGHT_ORDER]
    flat = torch.cat(parts).to(device)
    as_i8 = flat.to(torch.int8)
    if not torch.equal(as_i8.to(flat.dtype), flat):
        raise ValueError("the kernels need int8-valued weights")
    offsets = np.cumsum([0] + [p.numel() for p in parts[:-1]]).astype(np.int32)
    return (
        as_i8,
        torch.as_tensor(offsets, device=device),
        torch.as_tensor(np.asarray(rnn.meta.acts(), np.int32), device=device),
    )


def pack_tiled(rnn, device: torch.device):
    """A standard-topology ``ops.rnn.Rnn``'s weights as K2 and K5 take them:
    (int8 buffer of :data:`TILED_BYTES` in the layout :data:`TILED`, zeros
    in the padding, int32 activation codes) on ``device``; built from
    :func:`pack_weights`, whose int8 check it shares."""
    flat, offsets, acts = pack_weights(rnn, torch.device("cpu"))
    where = {key: int(o) for key, o in zip(_WEIGHT_ORDER, offsets)}
    buf = torch.zeros(TILED_BYTES, dtype=torch.int8)
    for layer, name, off, rows, cols, pad in TILED:
        src = flat[where[layer, name] : where[layer, name] + rows * cols].reshape(rows, cols)
        buf[off : off + rows * pad].view(rows, pad)[:, :cols] = src
    return buf.to(device), acts.to(device)


def check_tiled(weights: tuple, device: torch.device) -> tuple:
    """``weights`` as :func:`pack_tiled` gives them, (int8 buffer, int32
    codes), contiguous on ``device`` and the buffer 16-byte aligned; raise
    on anything else (the old layout of :func:`pack_weights` too)."""
    if len(weights) != 2:
        raise ValueError("weights must be pack_tiled's (buffer, codes)")
    w, acts = weights
    if (w.dtype, acts.dtype) != (torch.int8, torch.int32):
        raise TypeError("weights must be pack_tiled's (int8, int32)")
    if w.shape != (TILED_BYTES,) or acts.shape != (6,):
        raise ValueError(f"weights must be pack_tiled's {TILED_BYTES} bytes and 6 codes")
    if any(a.device != device or not a.is_contiguous() for a in weights):
        raise ValueError(f"weights must be contiguous on {device}")
    if w.data_ptr() % 16:
        raise ValueError("the int8 weight buffer must be 16-byte aligned")
    return w, acts


def rnn_step_cuda(weights: tuple, hv, hn, hd, features):
    """Launch K5 on the current CUDA stream.  ``weights``: pack_tiled of a
    standard-topology model; states (B, 24), (B, 48), (B, 96), features
    (B, 42).  Returns (hv', hn', hd', gains (B, 22), vad (B,))."""
    global launches
    b = features.shape[0]
    d = DIMS
    want = {"hv": (hv, d["v"]), "hn": (hn, d["n"]), "hd": (hd, d["h"]), "features": (features, d["f"])}
    for name, (arr, width) in want.items():
        if arr.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {arr.dtype}")
        if tuple(arr.shape) != (b, width):
            raise ValueError(f"{name} must be {(b, width)}, got {tuple(arr.shape)}")
        if arr.device != features.device or not arr.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {features.device}")
    w, acts = check_tiled(weights, features.device)
    # one allocation for the five outputs (the per-frame path is bound by
    # host time), each a contiguous slice
    widths = (d["v"], d["n"], d["h"], d["g"], 1)
    flat = torch.empty(b * sum(widths), dtype=torch.float32, device=features.device)
    *outs, vad = (part.view(b, n) for part, n in zip(flat.split([b * n for n in widths]), widths))
    vad = vad.view(b)
    if b:
        stream = torch.cuda.current_stream(features.device).cuda_stream
        err = _build.library().nnt_rnn_step(
            tansig_table(features.device).data_ptr(), w.data_ptr(), acts.data_ptr(), w.numel(),
            features.data_ptr(), hv.data_ptr(), hn.data_ptr(), hd.data_ptr(),
            *(o.data_ptr() for o in outs), vad.data_ptr(), b, stream,
        )
        _build.check(err, "nnt_rnn_step")
        launches += 1
    return (*outs, vad)


# ---- the plain mirror of the tiles' summing order ---------------------------

SMALL_B = 1024  # csrc/rnn_kernel.cu: at or below, one stream a block
_TILES = {"small": (1, 1, 576), "big": (32, 8, 576)}  # (streams, per thread, threads)
FRAME_TILE = (8, 4, 256)  # csrc/frame_kernel.cuh: K2's RNN tile, one a block


def tile_for(batch: int) -> tuple:
    """(streams a block, streams a thread, threads) K5 runs ``batch`` with."""
    return _TILES["small" if batch <= SMALL_B else "big"]


def lanes(quads: int, tile: tuple) -> int:
    """rnn_tile.cuh::lanes: the lanes a stage with ``quads`` output quads
    splits each sum over in ``tile`` (only the one-stream tile splits)."""
    s, _, threads = tile
    if s > 1:
        return 1
    n = threads // quads
    return 32 if n >= 32 else 1 << (max(n, 1).bit_length() - 1)


def _tile_sum(x, w, ks: int):
    """(B, K) x (K, J) summed as the kernel does: lane l of ``ks`` adds
    k = l, l + ks, ... in turn from 0, each step rounded once as its fmaf
    rounds (the product of an f32 and an int8 value is exact in float64,
    so only the sum is rounded, to float64 and then to float32), then the
    lanes' sums combine by halving (the xor shuffles)."""
    k = x.shape[1]
    steps = -(-k // ks)
    pad = steps * ks - k
    x = torch.nn.functional.pad(x, (0, pad)).reshape(x.shape[0], steps, ks).double()
    w = torch.nn.functional.pad(w, (0, 0, 0, pad)).reshape(steps, ks, -1).double()
    part = torch.zeros((x.shape[0], ks, w.shape[-1]), dtype=torch.float32, device=x.device)
    for m in range(steps):
        part = (part.double() + x[:, m, :, None] * w[m]).float()
    while part.shape[1] > 1:
        h = part.shape[1] // 2
        part = part[:, :h] + part[:, h:]
    return part[:, 0]


def _act(x, code: int):
    return {TANH: tansig_approx, SIGMOID: sigmoid_approx, RELU: relu}[code](x)


def rnn_step_staged(rnn, state, features, tile: tuple | None = None):
    """One frame of (B, ...) streams through the stages of
    ``csrc/rnn_tile.cuh`` in plain torch, with the summing order of
    ``tile`` (:func:`lanes`; by default K5's at this batch,
    :func:`tile_for`): every pre-activation is the bias plus the input
    sum, z and r then add the state's sum, and the 1/256 scale and the
    table activation follow.  A GRU's input sum runs over the
    concatenation of its inputs; K2 sums them as runs of rows in turn, in
    one lane, which gives the same bits.  Returns (hv', hn', hd', gains
    (B, 22), vad (B,)) as ``rnn_step_cuda``."""
    b = features.shape[0]
    tile = tile_for(b) if tile is None else tile

    def dense(layer, x):
        m, code = getattr(rnn, layer), getattr(rnn.meta, layer).activation
        ks = lanes(-(-m.w.shape[1] // 4), tile)
        return _act((m.b + _tile_sum(x, m.w, ks)) * WEIGHTS_SCALE, code)

    def gru(layer, x, h):
        m, code = getattr(rnn, layer), getattr(rnn.meta, layer).activation
        n = h.shape[1]
        ks = lanes(3 * n // 4, tile)
        pre = m.b + _tile_sum(x, m.wi, ks)
        zr = pre[:, : 2 * n] + _tile_sum(h, m.wr[:, : 2 * n], ks)
        cand = pre[:, 2 * n :]
        z = sigmoid_approx(zr[:, :n] * WEIGHTS_SCALE)
        rh = h * sigmoid_approx(zr[:, n:] * WEIGHTS_SCALE)
        hh = _act((cand + _tile_sum(rh, m.wr[:, 2 * n :], lanes(n // 4, tile))) * WEIGHTS_SCALE, code)
        return z * h + (1.0 - z) * hh

    hv, hn, hd = state
    d = dense("input_dense", features)
    hv2 = gru("vad_gru", d, hv)
    vad = dense("vad_output", hv2)
    hn2 = gru("noise_gru", torch.cat([d, hv2, features], 1), hn)
    hd2 = gru("denoise_gru", torch.cat([hv2, hn2, features], 1), hd)
    gains = dense("denoise_output", hd2)
    return hv2, hn2, hd2, gains, vad[:, 0]
