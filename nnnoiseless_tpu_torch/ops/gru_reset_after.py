"""Kernel K8: RNNoise 0.2's reset-after GRU recurrence over whole sequences.

Replaces no Pallas kernel: the JAX package has no RNNoise 0.2 trainer.
:func:`gru_sequence` is the recurrence of one ``torch.nn.GRU`` layer (the
reset gate applied after the recurrent product, gates in torch's r, z, n
order) as a ``torch.autograd.Function``: it takes the layer's input products
over whole sequences, ``XW = x W_ih^T + b_ih`` (B, T, 3n), the recurrent
weight ``W_hh`` (3n, n) and bias ``b_hh`` (3n), and returns the states H
(B, T, n) from h0 = 0::

    r, z = sigmoid(XW_rz + HW_rz), HW = h W_hh^T + b_hh;  hn = HW_n
    n = tanh(XW_n + r hn);  h' = lerp(n, h, z) = (1 - z) n + z h

For CUDA tensors the forward and the backward are one launch each of
``csrc/gru_ra_kernel.cu`` (:func:`forward_cuda`, :func:`backward_cuda`): all
T frames of a layer in one launch, ``W_hh`` spread over a 16-block thread
block cluster, which bounds n to :data:`MAX_N`.  For CPU tensors they are the
plain loops :func:`forward_plain` and :func:`backward_plain`, the same
arithmetic in PyTorch ops, which take any n and dtype.  Either way ``W_hh``'s
gradient is one product over all B * T rows and ``b_hh``'s one sum
(:func:`_weight_grads`); the gradients of ``W_ih``, ``b_ih`` and the inputs
flow through autograd of ``XW``'s product.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build

MAX_N = 384  # the widest layer a 16-block cluster's registers hold W_hh of

# Kernel launches since the last reset (the plain versions do not count):
# forward and backward together, and the backward alone.
launches = 0
backward_launches = 0
# The last launch's layout: {"seated": clusters the card holds at once,
# "sequences": a cluster's, "clusters": launched}, or None before any.
last_plan = None


def forward_plain(xw: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The recurrence frame by frame on the CPU: xw (B, T, 3n), w_hh (3n, n),
    b_hh (3n) -> (H (B, T, n), gates (B, T, 4n): r, z, n and hn)."""
    _check_cpu(xw, w_hh, b_hh)
    b, t_count, n3 = xw.shape
    n = n3 // 3
    h = xw.new_zeros((b, n))
    hs, gates = [], []
    for t in range(t_count):
        x_rz, x_n = xw[:, t].split((2 * n, n), 1)
        h_rz, hn = F.linear(h, w_hh, b_hh).split((2 * n, n), 1)
        r, z = torch.sigmoid(x_rz + h_rz).split(n, 1)
        c = torch.tanh(x_n + r * hn)
        h = torch.lerp(c, h, z)
        hs.append(h)
        gates.append(torch.cat([r, z, c, hn], 1))
    return torch.stack(hs, 1), torch.stack(gates, 1)


def backward_plain(dh_out: torch.Tensor, h: torch.Tensor, gates: torch.Tensor,
                   w_hh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradient of :func:`forward_plain`'s H on the CPU, frame by frame
    from T - 1 down to 0: dH, H (B, T, n), gates (B, T, 4n), w_hh (3n, n) ->
    (dXW, dHW (B, T, 3n)), dHW the gradient of ``h W_hh^T + b_hh``."""
    _check_cpu(dh_out, h, gates, w_hh)
    b, t_count, n = h.shape
    carry = h.new_zeros((b, n))
    dxw = h.new_empty((b, t_count, 3 * n))
    dhw = h.new_empty((b, t_count, 3 * n))
    for t in reversed(range(t_count)):
        r, z, c, hn = gates[:, t].split(n, 1)
        hp = h[:, t - 1] if t else torch.zeros_like(carry)
        dh = dh_out[:, t] + carry
        dc = dh * (1.0 - z) * (1.0 - c * c)
        dz = dh * (hp - c) * (z * (1.0 - z))
        dhn = dc * r
        dr = dc * hn * (r * (1.0 - r))
        dxw[:, t] = torch.cat([dr, dz, dc], 1)
        dhw[:, t] = torch.cat([dr, dz, dhn], 1)
        carry = dh * z + dhw[:, t] @ w_hh
    return dxw, dhw


def _check_cpu(*arrays: torch.Tensor) -> None:
    if any(a.device.type != "cpu" for a in arrays):
        raise ValueError("the plain GRU loops take CPU tensors; a CUDA tensor goes to the kernels")


def check_width(n: int, device: torch.device) -> None:
    """Raise ValueError for a layer of ``n`` units on a CUDA device that the
    kernels do not take (n > :data:`MAX_N`); the CPU takes any n."""
    if torch.device(device).type == "cuda" and n > MAX_N:
        raise ValueError(f"the reset-after GRU kernels take n <= {MAX_N} (W_hh must fit in a cluster); got n = {n}")


def _check_cuda(w_hh: torch.Tensor, *arrays: torch.Tensor) -> int:
    n = w_hh.shape[1]
    check_width(n, w_hh.device)
    for a in (w_hh,) + arrays:
        if a.dtype != torch.float32:
            raise ValueError(f"the reset-after GRU kernels take float32, got {a.dtype}")
        if a.device != w_hh.device or not a.is_contiguous():
            raise ValueError(f"the reset-after GRU kernels' operands must be contiguous on {w_hh.device}")
    return n


def _launch(name: str, *args) -> None:
    global last_plan
    plan = (ctypes.c_int * 3)()
    err = getattr(_build.library(), name)(*args, ctypes.addressof(plan), torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)
    last_plan = dict(zip(("seated", "sequences", "clusters"), plan))


def forward_cuda(xw: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K8's forward on the current CUDA stream; as :func:`forward_plain`."""
    global launches
    n = _check_cuda(w_hh, xw, b_hh)
    b, t_count, _ = xw.shape
    h = torch.empty((b, t_count, n), dtype=torch.float32, device=xw.device)
    gates = torch.empty((b, t_count, 4 * n), dtype=torch.float32, device=xw.device)
    if b and t_count:
        with torch.cuda.device(xw.device):
            _launch("nnt_gru_ra_fwd", xw.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), h.data_ptr(),
                    gates.data_ptr(), b, t_count, n)
        launches += 1
    return h, gates


def backward_cuda(dh_out: torch.Tensor, h: torch.Tensor, gates: torch.Tensor,
                  w_hh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K8's backward on the current CUDA stream; as :func:`backward_plain`."""
    global launches, backward_launches
    n = _check_cuda(w_hh, dh_out, h, gates)
    b, t_count, _ = h.shape
    dxw = torch.empty((b, t_count, 3 * n), dtype=torch.float32, device=h.device)
    dhw = torch.empty_like(dxw)
    if b and t_count:
        with torch.cuda.device(h.device):
            _launch("nnt_gru_ra_bwd", dh_out.data_ptr(), h.data_ptr(), gates.data_ptr(), w_hh.data_ptr(),
                    dxw.data_ptr(), dhw.data_ptr(), b, t_count, n)
        launches += 1
        backward_launches += 1
    return dxw, dhw


def _weight_grads(dhw: torch.Tensor, h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(dW_hh (3n, n), db_hh (3n)) over all B * T rows: ``dHW^T @ Hprev``,
    Hprev the states one frame back (0 at the first), and dHW's column sums."""
    b, t_count, n = h.shape
    hp = torch.cat([h.new_zeros((b, 1, n)), h[:, :-1]], 1).reshape(-1, n)
    rows = dhw.reshape(-1, 3 * n)
    return rows.T @ hp, rows.sum(0)


class GruResetAfter(torch.autograd.Function):
    """H = the recurrence over XW; saves (W_hh, H, gates) for the backward."""

    @staticmethod
    def forward(ctx, xw, w_hh, b_hh):
        h, gates = forward_cuda(xw, w_hh, b_hh) if xw.is_cuda else forward_plain(xw, w_hh, b_hh)
        ctx.save_for_backward(w_hh, h, gates)
        return h

    @staticmethod
    def backward(ctx, dh_out):
        w_hh, h, gates = ctx.saved_tensors
        dh_out = dh_out.contiguous()
        if h.is_cuda:
            dxw, dhw = backward_cuda(dh_out, h, gates, w_hh)
        else:
            dxw, dhw = backward_plain(dh_out, h, gates, w_hh)
        dw, db = _weight_grads(dhw, h) if any(ctx.needs_input_grad[1:]) else (None, None)
        return dxw, dw, db


def gru_sequence(xw: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """One reset-after GRU layer over whole sequences: xw (B, T, 3n) the
    input products with their bias, w_hh (3n, n) and b_hh (3n) the recurrent
    weight and bias (gates r, z, n at row offsets 0, n, 2n) -> H (B, T, n)
    from a zero state.  On CUDA the kernels (n <= :data:`MAX_N`, float32,
    contiguous, else a ValueError); on the CPU the plain loops."""
    n = w_hh.shape[1] if w_hh.ndim == 2 else -1
    if xw.ndim != 3 or w_hh.shape != (3 * n, n) or b_hh.shape != (3 * n,) or xw.shape[2] != 3 * n:
        raise ValueError(f"xw must be (B, T, 3n) for w_hh (3n, n) and b_hh (3n); got {tuple(xw.shape)}, "
                         f"{tuple(w_hh.shape)}, {tuple(b_hh.shape)}")
    if xw.device != w_hh.device or b_hh.device != w_hh.device:
        raise ValueError("xw, w_hh and b_hh must be on one device")
    return GruResetAfter.apply(xw, w_hh, b_hh)
