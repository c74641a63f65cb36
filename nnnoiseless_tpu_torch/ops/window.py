"""Kernel K6: each stream's analysis window at its pitch lag.

Replaces ``nnnoiseless_tpu/ops/window.py::_pallas_window``.  The analysis
at the pitch lag needs ``input_mem[768 - lag : 1728 - lag]`` with a lag per
stream (reference transform_input, src/features.rs:281-298).

:func:`window_at_lag` launches ``csrc/window_kernel.cu`` for CUDA tensors
and runs :func:`barrel_shift_window` for CPU tensors.
"""

from __future__ import annotations

import torch

from .. import _build
from ..constants import PITCH_BUF_SIZE, WINDOW_SIZE

N_BITS = 10  # lags below 1024 (PITCH_MAX_PERIOD = 768)
_OFF = PITCH_BUF_SIZE - WINDOW_SIZE  # 768

# Kernel launches since the last reset (the plain version does not count).
launches = 0


def barrel_shift_window(input_mem: torch.Tensor, lag: torch.Tensor) -> torch.Tensor:
    """The plain version (``_barrel_shift_window`` there): ten shifts with
    zero fill, each gated by one bit of the lag.  (..., 1728), (...) int ->
    (..., 960); a lag above 768 reads zeros before the history's start,
    and the lag counts modulo 1024."""
    y = input_mem
    for b in range(N_BITS):
        sh = 1 << b
        shifted = torch.cat([torch.zeros_like(y[..., :sh]), y[..., :-sh]], dim=-1)
        y = torch.where((((lag >> b) & 1) == 1)[..., None], shifted, y)
    return y[..., _OFF:]


def _check(input_mem, lag):
    if input_mem.dtype != torch.float32 or lag.dtype != torch.int32:
        raise TypeError("input_mem must be float32 and lag int32")
    if input_mem.ndim != 2 or input_mem.shape[1] != PITCH_BUF_SIZE or lag.shape != input_mem.shape[:1]:
        raise ValueError(f"bad shapes input_mem {tuple(input_mem.shape)}, lag {tuple(lag.shape)}")
    if lag.device != input_mem.device:
        raise ValueError("input_mem and lag must be on one device")


def window_cuda(input_mem: torch.Tensor, lag: torch.Tensor) -> torch.Tensor:
    """Launch K6 on the current CUDA stream: (B, 1728), (B,) -> (B, 960)."""
    global launches
    _check(input_mem, lag)
    if not (input_mem.is_contiguous() and lag.is_contiguous()):
        raise ValueError("input_mem and lag must be contiguous")
    if input_mem.data_ptr() % 16:
        raise ValueError("input_mem must be 16-byte aligned (the kernel reads float4s)")
    b = input_mem.shape[0]
    out = torch.empty((b, WINDOW_SIZE), dtype=torch.float32, device=input_mem.device)
    if b:
        stream = torch.cuda.current_stream(input_mem.device).cuda_stream
        err = _build.library().nnt_window_at_lag(
            input_mem.data_ptr(), lag.data_ptr(), out.data_ptr(), b, stream
        )
        _build.check(err, "nnt_window_at_lag")
        launches += 1
    return out


def window_at_lag(input_mem: torch.Tensor, lag: torch.Tensor) -> torch.Tensor:
    """(B, 1728) input histories, (B,) int32 lags -> (B, 960) windows
    ``input_mem[b, 768 - lag[b] + i]``, zero where that index is negative."""
    if input_mem.is_cuda:
        return window_cuda(input_mem, lag)
    if input_mem.device.type != "cpu":
        raise ValueError(f"unsupported device {input_mem.device}")
    _check(input_mem, lag)
    return barrel_shift_window(input_mem, lag)
