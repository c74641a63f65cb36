"""Kernel K5: one step of the whole RNN cell for a batch of streams.

Replaces ``nnnoiseless_tpu/ops/rnn_pallas.py::rnn_step_pallas`` (body
``_rnn_pallas``).  The weights go in as kernel K2 takes them,
:func:`pack_weights`: int8 values in one buffer with their offsets and the
six activation codes.  :func:`rnn_step_cuda` launches
``csrc/rnn_kernel.cu``; its plain version is ``ops/rnn.py::Rnn.forward``,
and ``ops/rnn.py::rnn_step`` picks between the two.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from ..tables import TANSIG_TABLE

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


def pack_weights(rnn, device: torch.device):
    """An ``ops.rnn.Rnn``'s weights as K2 and K5 take them: (int8 weights
    concatenated in kernel order, int32 offsets, int32 activation codes) on
    ``device``.  Every weight of a ``.rnn`` model is an int8 value, so int8
    storage is exact; other weights raise."""
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


@functools.lru_cache(maxsize=8)
def _tansig(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(TANSIG_TABLE, device=device)


def rnn_step_cuda(weights: tuple, hv, hn, hd, features):
    """Launch K5 on the current CUDA stream.  ``weights``: pack_weights of
    a standard-topology model; states (B, 24), (B, 48), (B, 96), features
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
    w, woff, acts = weights
    if (w.dtype, woff.dtype, acts.dtype) != (torch.int8, torch.int32, torch.int32):
        raise TypeError("weights must be pack_weights' (int8, int32, int32)")
    if woff.shape != (len(_WEIGHT_ORDER),) or acts.shape != (6,):
        raise ValueError("weights must be pack_weights' 15 offsets and 6 codes")
    if any(a.device != features.device or not a.is_contiguous() for a in weights):
        raise ValueError(f"weights must be contiguous on {features.device}")
    if w.data_ptr() % 16:
        raise ValueError("the int8 weight buffer must be 16-byte aligned")
    outs = tuple(
        torch.empty((b, n), dtype=torch.float32, device=features.device)
        for n in (d["v"], d["n"], d["h"], d["g"])
    )
    vad = torch.empty((b,), dtype=torch.float32, device=features.device)
    if b:
        stream = torch.cuda.current_stream(features.device).cuda_stream
        err = _build.library().nnt_rnn_step(
            _tansig(features.device).data_ptr(), w.data_ptr(), woff.data_ptr(), acts.data_ptr(),
            w.numel(), features.data_ptr(), hv.data_ptr(), hn.data_ptr(), hd.data_ptr(),
            *(o.data_ptr() for o in outs), vad.data_ptr(), b, stream,
        )
        _build.check(err, "nnt_rnn_step")
        launches += 1
    return (*outs, vad)
