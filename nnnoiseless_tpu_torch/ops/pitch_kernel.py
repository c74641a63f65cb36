"""Kernels K1 and K3: pitch analysis of 2x-decimated 864-sample windows.

Replaces ``nnnoiseless_tpu/ops/pitch_kernel.py::pitch_analysis_stream``.
Frame t of stream b reads the 864-sample window
``ds[b, 240(t+1) : 240(t+1) + 864]`` with lane 0 replaced by ``w0[t, b]``
(the window-local decimation boundary, pitch.rs:455-458), whitens it,
builds the 385-lag correlation and energy tables, runs the coarse/fine
search and writes the 105 octave-removal candidate lanes and the pitch
index.

:func:`pitch_analysis_stream` launches ``csrc/pitch_kernel.cu`` (the kernel
in ``csrc/pitch_kernel.cuh``) for CUDA tensors and runs
:func:`pitch_analysis_plain` for CPU tensors.

K3 replaces ``pitch_analysis_pallas`` there: the same analysis of R windows
already stacked (R, 864), with no lane patched, one per stream on the
per-frame path.  :func:`pitch_analysis_stacked` launches it through a
second entry point of the same source for CUDA tensors and runs
``ops/pitch.py::pitch_chain`` for CPU tensors.

K1 has a ``skip`` knob for attribution, as K2 has: ``skip=(stage,)`` stubs
one stage of SKIP_STAGES, in the kernel (one instance per stage, built in
``csrc/pitch_kernel_skip.cu``) and in the plain version alike; the stage's
cost is the production time minus the stub's.  The JAX kernel's
``corrinv`` stage is not ported: it stubs the inverse DFT of a correlation
that this kernel never transforms.  Production calls never pass it.
"""

from __future__ import annotations

import torch

from .. import _build
from ..constants import PITCH_BUF_SIZE
from .pitch import N_CAND, pitch_chain

N_DS = PITCH_BUF_SIZE // 2  # 864
DS_STEP = 240  # decimated samples per frame

# Kernel launches since the last reset (the plain versions do not count):
# K1 in ``launches``, K3 in ``stacked_launches``.
launches = 0
stacked_launches = 0

# Stages the ``skip`` knob stubs out, bit i of the kernel's mask for stage i
# (the stubs of nnnoiseless_tpu/ops/pitch_kernel.py:554-642):
#   whiten  whitening: y = x
#   etab    the 385-lag energy table: zeros
#   corr    the 385-lag correlation: zeros
#   coarse  the coarse search: best4 = second4 = 0
#   cand    the candidate walk: every lane xx = max(etab[384], 0)
SKIP_STAGES = ("whiten", "etab", "corr", "coarse", "cand")


def _skip_mask(skip) -> int:
    """The kernel's mask for ``skip``: at most one stage of SKIP_STAGES."""
    skip = tuple(skip)
    unknown = set(skip) - set(SKIP_STAGES)
    if unknown:
        raise ValueError(f"unknown skip stages {sorted(unknown)}; known: {SKIP_STAGES}")
    if len(skip) > 1:
        raise ValueError(f"the pitch kernel stubs one stage at a time, got {skip}")
    return sum(1 << SKIP_STAGES.index(name) for name in skip)


def window_stack(ds: torch.Tensor, w0: torch.Tensor, t_count: int) -> torch.Tensor:
    """(T, B, 864) windows of frames 0..T-1 with the lane-0 patch."""
    idx = DS_STEP * (torch.arange(t_count, device=ds.device) + 1)[:, None] + torch.arange(
        N_DS, device=ds.device
    )
    wins = ds[:, idx].transpose(0, 1).clone()  # (T, B, 864)
    wins[..., 0] = w0
    return wins


def pitch_analysis_plain(ds: torch.Tensor, w0: torch.Tensor, t_count: int, skip: tuple = ()):
    """The plain PyTorch version: the ops/pitch.py chain on the window
    stack, with the stub of ``skip``."""
    _skip_mask(skip)
    return pitch_chain(window_stack(ds, w0, t_count), tuple(skip))


def _check(ds, w0, t_count):
    if ds.dtype != torch.float32 or w0.dtype != torch.float32:
        raise TypeError("ds and w0 must be float32")
    if ds.ndim != 2 or w0.shape != (t_count, ds.shape[0]):
        raise ValueError(f"bad shapes ds {tuple(ds.shape)}, w0 {tuple(w0.shape)}, T={t_count}")
    need = N_DS + DS_STEP * t_count
    if ds.shape[1] < need:
        raise ValueError(f"ds too short for {t_count} windows: need {need}, have {ds.shape[1]}")
    if ds.device != w0.device:
        raise ValueError("ds and w0 must be on one device")


def pitch_analysis_cuda(ds: torch.Tensor, w0: torch.Tensor, t_count: int, skip: tuple = ()):
    """Launch K1 on ds's current CUDA stream; returns (cand (T,B,105),
    pidx (T,B) int32).  ``skip``: at most one stage to stub out."""
    global launches
    mask = _skip_mask(skip)
    _check(ds, w0, t_count)
    if ds.stride(1) != 1 or not w0.is_contiguous():
        raise ValueError("ds rows and w0 must be contiguous")
    b = ds.shape[0]
    cand = torch.empty((t_count, b, N_CAND), dtype=torch.float32, device=ds.device)
    pidx = torch.empty((t_count, b), dtype=torch.int32, device=ds.device)
    if b and t_count:
        lib = _build.library()
        stream = torch.cuda.current_stream(ds.device).cuda_stream
        args = (ds.data_ptr(), ds.stride(0), w0.data_ptr(), cand.data_ptr(), pidx.data_ptr(),
                b, t_count)
        if mask:
            err = lib.nnt_pitch_analysis_skip(*args, mask, stream)
        else:
            err = lib.nnt_pitch_analysis(*args, stream)
        _build.check(err, "nnt_pitch_analysis")
        launches += 1
    return cand, pidx


def pitch_analysis_stream(ds: torch.Tensor, w0: torch.Tensor, t_count: int, skip: tuple = ()):
    """(B, >= 864 + 240T) decimated signal, (T, B) lane-0 patches ->
    ((T, B, 105) candidate lanes, (T, B) int32 pitch index).  ``skip``: at
    most one stage of SKIP_STAGES to stub out, for attribution only."""
    if ds.is_cuda:
        return pitch_analysis_cuda(ds, w0, t_count, skip)
    if ds.device.type != "cpu":
        raise ValueError(f"unsupported device {ds.device}")
    _check(ds, w0, t_count)
    return pitch_analysis_plain(ds, w0, t_count, skip)


def _check_stacked(windows):
    if windows.dtype != torch.float32:
        raise TypeError(f"windows must be float32, got {windows.dtype}")
    if windows.ndim != 2 or windows.shape[1] != N_DS:
        raise ValueError(f"windows must be (R, {N_DS}), got {tuple(windows.shape)}")


def pitch_analysis_stacked_cuda(windows: torch.Tensor):
    """Launch K3 on the current CUDA stream; returns (cand (R, 105),
    pidx (R,) int32)."""
    global stacked_launches
    _check_stacked(windows)
    if not windows.is_contiguous():
        raise ValueError("windows must be contiguous")
    r = windows.shape[0]
    cand = torch.empty((r, N_CAND), dtype=torch.float32, device=windows.device)
    pidx = torch.empty((r,), dtype=torch.int32, device=windows.device)
    if r:
        stream = torch.cuda.current_stream(windows.device).cuda_stream
        err = _build.library().nnt_pitch_analysis_stacked(
            windows.data_ptr(), cand.data_ptr(), pidx.data_ptr(), r, stream
        )
        _build.check(err, "nnt_pitch_analysis_stacked")
        stacked_launches += 1
    return cand, pidx


def pitch_analysis_stacked(windows: torch.Tensor):
    """(R, 864) raw decimated windows -> ((R, 105) candidate lanes, (R,)
    int32 pitch index)."""
    if windows.is_cuda:
        return pitch_analysis_stacked_cuda(windows)
    if windows.device.type != "cpu":
        raise ValueError(f"unsupported device {windows.device}")
    _check_stacked(windows)
    return pitch_chain(windows)
