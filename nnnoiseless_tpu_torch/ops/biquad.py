"""The high-pass biquad: per sample, per frame, and over a whole chunk.

Convention (reference src/util.rs:73-127): both coefficient pairs have an
implicit leading 1, and

    y[n] = x[n] + mem0
    mem0' = mem1 + (b0*x[n] - a0*y[n])
    mem1' =        b1*x[n] - a1*y[n]

:func:`biquad_filter` runs that recurrence sample by sample.  The filter
is linear and time-invariant, so one frame is an (n, n) Toeplitz product
plus rank-2 carry terms (:func:`biquad_filter_dense`), and a whole chunk
is that product per sub-frame plus a closed-form carry propagation across
sub-frames (:func:`biquad_filter_frames`), all tables built in f64 (the
construction of ``nnnoiseless_tpu/ops/biquad.py``).  The products must
run in full f32: the Toeplitz rows cancel large partial sums, so TF32 or
bf16 loses up to ~160 i16 units (the package sets ``allow_tf32 = False``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _tables_f64(a0, a1, b0, b1, n):
    """Unrolled-recurrence matrices for a fixed biquad over n samples:
    y = x + x @ W + mem @ P,  mem' = x @ H + mem @ Q."""
    A = np.array([[-a0, 1.0], [-a1, 0.0]], np.float64)
    c = np.array([b0 - a0, b1 - a1], np.float64)
    powers = np.empty((n + 1, 2, 2))
    powers[0] = np.eye(2)
    for j in range(1, n + 1):
        powers[j] = A @ powers[j - 1]
    g = powers[:, 0, :] @ c  # g[j] = (A^j c)[0]
    W = np.zeros((n, n))
    for t in range(1, n):
        W[:t, t] = g[t - 1 :: -1][:t]  # W[k, t] = g[t-1-k]
    P = powers[:n, 0, :].T.copy()
    H = powers[n - 1 :: -1, :, :] @ c
    Q = powers[n].T
    return W, P, H, Q


def biquad_filter(x: torch.Tensor, mem: torch.Tensor, a, b) -> tuple[torch.Tensor, torch.Tensor]:
    """Filter ``x`` (..., n) with carry ``mem`` (..., 2) one sample at a
    time, in f32; returns (y, mem')."""
    a0, a1, b0, b1 = (float(v) for v in (a[0], a[1], b[0], b[1]))
    m0, m1 = mem[..., 0], mem[..., 1]
    ys = []
    for xn in x.unbind(-1):
        y = xn + m0
        m0, m1 = m1 + (b0 * xn - a0 * y), b1 * xn - a1 * y
        ys.append(y)
    return torch.stack(ys, dim=-1), torch.stack([m0, m1], dim=-1)


def _on(device: torch.device, tables) -> tuple:
    """f64 numpy tables as f32 tensors on ``device``."""
    return tuple(torch.as_tensor(np.ascontiguousarray(m, np.float32), device=device) for m in tables)


@functools.lru_cache(maxsize=8)
def _linear_tables(a0, a1, b0, b1, n, device: torch.device):
    """:func:`_tables_f64` as f32 tensors on ``device``, uploaded once
    (the per-frame path calls this every frame, and a CUDA graph cannot
    capture an upload from pageable memory): (W, P, H, Q)."""
    return _on(device, _tables_f64(a0, a1, b0, b1, n))


def biquad_filter_dense(x: torch.Tensor, mem: torch.Tensor, a, b) -> tuple[torch.Tensor, torch.Tensor]:
    """One block (..., n) with carry (..., 2) as f32 products:
    y = x + x @ W + mem @ P, mem' = x @ H + mem @ Q."""
    W, P, H, Q = _linear_tables(float(a[0]), float(a[1]), float(b[0]), float(b[1]), x.shape[-1], x.device)
    y = x + torch.matmul(x, W) + torch.matmul(mem, P)
    return y, torch.matmul(x, H) + torch.matmul(mem, Q)


@functools.lru_cache(maxsize=8)
def _carry_prop_tables(a0, a1, b0, b1, n, t_count, device: torch.device):
    """Closed-form carry propagation over ``t_count`` blocks, in Q's modal
    basis (see ``nnnoiseless_tpu/ops/biquad.py::_carry_prop_tables``: Q is
    severely non-normal for the HP filter, so the tables are built where
    its powers are a bounded rotation-scaling and nothing cancels).

    Returns f32 tensors on ``device``, uploaded once: (W (n,n), HT (n,2),
    Tm (2,2), M (2t, 2(t+1)), Qp (2, 2(t+1)), Pp (2,n), Tinv (2,2)).
    """
    W, P, H, Q = _tables_f64(a0, a1, b0, b1, n)
    lam, V = np.linalg.eig(Q)
    if abs(lam[0].imag) > 1e-12 * abs(lam[0]):
        v = V[:, 0]
        Tm = np.stack([v.real, v.imag], axis=1)
    else:
        Tm = V.real
    if not np.all(np.isfinite(Tm)) or np.linalg.cond(Tm) > 1e3:
        Tm = np.eye(2)
    Tinv = np.linalg.inv(Tm)
    G = Tinv @ Q @ Tm
    if not np.allclose(Tm @ G @ Tinv, Q, atol=1e-8 * max(1.0, abs(Q).max())):
        Tm = Tinv = np.eye(2)
        G = Q
    gpow = np.empty((t_count + 1, 2, 2))
    gpow[0] = np.eye(2)
    for j in range(1, t_count + 1):
        gpow[j] = gpow[j - 1] @ G
    M = np.zeros((t_count, 2, t_count + 1, 2))
    for t in range(1, t_count + 1):
        for k in range(t):
            M[k, :, t, :] = gpow[t - 1 - k]
    Qp = np.transpose(gpow, (1, 0, 2)).reshape(2, 2 * (t_count + 1))
    return _on(device, (W, H @ Tm, Tm, M.reshape(2 * t_count, 2 * (t_count + 1)), Qp, Tinv @ P, Tinv))


# 480-sample frames are filtered as four 120-sample sub-frames: the Toeplitz
# product is quadratic in block length, the carry product is tiny.
_SUB_FRAME = 120


def biquad_filter_frames(
    frames: torch.Tensor, mem: torch.Tensor, a: tuple, b: tuple
) -> tuple[torch.Tensor, torch.Tensor]:
    """Filter a chunk of frames (B, T, n) with carry (B, 2) at once.

    Returns (filtered (B, T, n), mem' (B, 2)).
    """
    b_sz, t_count, n = frames.shape
    if n % _SUB_FRAME == 0 and n > _SUB_FRAME:
        k = n // _SUB_FRAME
        y, mem_out = _biquad_frames_blocked(
            frames.reshape(b_sz, t_count * k, _SUB_FRAME), mem, a, b
        )
        return y.reshape(b_sz, t_count, n), mem_out
    return _biquad_frames_blocked(frames, mem, a, b)


def _biquad_frames_blocked(frames, mem, a, b):
    b_sz, t_count, n = frames.shape
    W, HT, Tm, M, Qp, Pp, Tinv = _carry_prop_tables(
        float(a[0]), float(a[1]), float(b[0]), float(b[1]), n, t_count, frames.device
    )
    xw = torch.matmul(frames, W)  # (B, T, n)
    xh = torch.matmul(frames, HT)  # (B, T, 2), modal basis
    u = torch.matmul(xh.reshape(b_sz, 2 * t_count), M)
    u = u + torch.matmul(torch.matmul(mem, Tm), Qp)
    u = u.reshape(b_sz, t_count + 1, 2)  # modal state at each block start
    y = frames + xw + torch.matmul(u[:, :t_count], Pp)
    mem_out = torch.matmul(u[:, t_count], Tinv)
    return y, mem_out
