"""Kernel K7: the float trainer's GRU recurrence over whole sequences.

Replaces no Pallas kernel: the JAX trainer's recurrence is a ``lax.scan``
(``nnnoiseless_tpu/training/network.py``).  :func:`gru_sequence` is the
recurrence of one Keras ``reset_after=False`` GRU layer as a
``torch.autograd.Function``: it takes the layer's input products over whole
sequences, ``XW = x @ wi + b`` (B, T, 3n), and returns the states H
(B, T, n) from h0 = 0.  Only ``h @ wr`` stays inside the loop over time.

For CUDA tensors the forward and the backward are one launch each of
``csrc/gru_seq_kernel.cu`` (:func:`forward_cuda`, :func:`backward_cuda`):
all T frames of a layer in one launch, ``wr`` held in registers, which
bounds n to :data:`MAX_N`.  For CPU tensors they are the plain loops
:func:`forward_plain` and :func:`backward_plain`, the same arithmetic in
PyTorch ops, which take any n and dtype.  Either way the weight gradient is
one product over all B * T rows (:func:`_weight_grad`), and the gradients
of ``wi``, ``b`` and the inputs flow through autograd of ``XW``'s product.
"""

from __future__ import annotations

import torch

from .. import _build
from ..model import RELU, SIGMOID, TANH

MAX_N = 128  # the widest layer whose wr (n x 3n floats) the kernels keep on one SM

# Kernel launches since the last reset (the plain versions do not count):
# forward and backward together, and the backward alone.
launches = 0
backward_launches = 0


def activation(x, code: int):
    """The float activation of model.py's ``code`` (TANH, SIGMOID, RELU)."""
    if code == TANH:
        return torch.tanh(x)
    if code == SIGMOID:
        return torch.sigmoid(x)
    if code == RELU:
        return torch.relu(x)
    raise ValueError(f"unknown activation code {code}")


def _act_grad(y, code: int):
    """The activation's derivative as a function of its output ``y``."""
    if code == TANH:
        return 1.0 - y * y
    if code == SIGMOID:
        return y * (1.0 - y)
    if code == RELU:
        return (y > 0).to(y.dtype)
    raise ValueError(f"unknown activation code {code}")


def forward_plain(xw: torch.Tensor, wr: torch.Tensor, code: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The recurrence frame by frame: xw (B, T, 3n), wr (n, 3n) -> (H
    (B, T, n), gates (B, T, 3n): z, r and the candidate c after its
    activation)."""
    b, t_count, n3 = xw.shape
    n = n3 // 3
    h = xw.new_zeros((b, n))
    hs, gates = [], []
    for t in range(t_count):
        x = xw[:, t]
        hzr = h @ wr[:, : 2 * n]
        z = torch.sigmoid(x[:, :n] + hzr[:, :n])
        r = torch.sigmoid(x[:, n : 2 * n] + hzr[:, n:])
        c = activation(x[:, 2 * n :] + (r * h) @ wr[:, 2 * n :], code)
        h = z * h + (1.0 - z) * c
        hs.append(h)
        gates.append(torch.cat([z, r, c], 1))
    return torch.stack(hs, 1), torch.stack(gates, 1)


def backward_plain(dh_out: torch.Tensor, h: torch.Tensor, gates: torch.Tensor, wr: torch.Tensor,
                   code: int) -> torch.Tensor:
    """The gradient of :func:`forward_plain`'s H with respect to xw, frame
    by frame from T - 1 down to 0: dH, H (B, T, n), gates (B, T, 3n), wr
    (n, 3n) -> dXW (B, T, 3n)."""
    b, t_count, n = h.shape
    carry = h.new_zeros((b, n))
    dxw = h.new_empty((b, t_count, 3 * n))
    for t in reversed(range(t_count)):
        z, r, c = gates[:, t].split(n, 1)
        hp = h[:, t - 1] if t else torch.zeros_like(carry)
        dh = dh_out[:, t] + carry
        dz = dh * (hp - c) * (z * (1.0 - z))
        dc = dh * (1.0 - z) * _act_grad(c, code)
        drh = dc @ wr[:, 2 * n :].T
        dr = drh * hp * (r * (1.0 - r))
        carry = dh * z + drh * r + dz @ wr[:, :n].T + dr @ wr[:, n : 2 * n].T
        dxw[:, t] = torch.cat([dz, dr, dc], 1)
    return dxw


def check_width(n: int, device: torch.device) -> None:
    """Raise ValueError for a layer of ``n`` neurons on a CUDA device that
    the kernels do not take (n > :data:`MAX_N`); the CPU takes any n."""
    if torch.device(device).type == "cuda" and n > MAX_N:
        raise ValueError(f"the GRU sequence kernels take n <= {MAX_N} (wr must fit on one SM); got n = {n}")


def _check_cuda(wr: torch.Tensor, *arrays: torch.Tensor) -> int:
    n = wr.shape[0]
    check_width(n, wr.device)
    for a in (wr,) + arrays:
        if a.dtype != torch.float32:
            raise TypeError(f"the GRU sequence kernels take float32, got {a.dtype}")
        if a.device != wr.device or not a.is_contiguous():
            raise ValueError(f"the GRU sequence kernels' operands must be contiguous on {wr.device}")
    return n


def forward_cuda(xw: torch.Tensor, wr: torch.Tensor, code: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K7's forward on the current CUDA stream; as :func:`forward_plain`."""
    global launches
    n = _check_cuda(wr, xw)
    b, t_count, _ = xw.shape
    h = torch.empty((b, t_count, n), dtype=torch.float32, device=xw.device)
    gates = torch.empty_like(xw)
    if b and t_count:
        stream = torch.cuda.current_stream(xw.device).cuda_stream
        err = _build.library().nnt_gru_seq_fwd(xw.data_ptr(), wr.data_ptr(), h.data_ptr(), gates.data_ptr(),
                                               b, t_count, n, code, stream)
        _build.check(err, "nnt_gru_seq_fwd")
        launches += 1
    return h, gates


def backward_cuda(dh_out: torch.Tensor, h: torch.Tensor, gates: torch.Tensor, wr: torch.Tensor,
                  code: int) -> torch.Tensor:
    """Launch K7's backward on the current CUDA stream; as :func:`backward_plain`."""
    global launches, backward_launches
    n = _check_cuda(wr, dh_out, h, gates)
    b, t_count, _ = h.shape
    dxw = torch.empty_like(gates)
    if b and t_count:
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = _build.library().nnt_gru_seq_bwd(dh_out.data_ptr(), h.data_ptr(), gates.data_ptr(), wr.data_ptr(),
                                               dxw.data_ptr(), b, t_count, n, code, stream)
        _build.check(err, "nnt_gru_seq_bwd")
        launches += 1
        backward_launches += 1
    return dxw


def _weight_grad(dxw: torch.Tensor, h: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """dwr (n, 3n) over all B * T rows: ``Hprev^T @ dXW[:, :2n]`` beside
    ``(R * Hprev)^T @ dXW[:, 2n:]``, Hprev the states one frame back (0 at
    the first)."""
    b, t_count, n = h.shape
    hp = torch.cat([h.new_zeros((b, 1, n)), h[:, :-1]], 1).reshape(-1, n)
    rows = dxw.reshape(-1, 3 * n)
    rh = gates[..., n : 2 * n].reshape(-1, n) * hp
    return torch.cat([hp.T @ rows[:, : 2 * n], rh.T @ rows[:, 2 * n :]], 1)


class GruSequence(torch.autograd.Function):
    """H = the recurrence over XW; saves (wr, H, gates) for the backward."""

    @staticmethod
    def forward(ctx, xw, wr, code: int):
        h, gates = forward_cuda(xw, wr, code) if xw.is_cuda else forward_plain(xw, wr, code)
        ctx.save_for_backward(wr, h, gates)
        ctx.code = code
        return h

    @staticmethod
    def backward(ctx, dh_out):
        wr, h, gates = ctx.saved_tensors
        dh_out = dh_out.contiguous()
        if h.is_cuda:
            dxw = backward_cuda(dh_out, h, gates, wr, ctx.code)
        else:
            dxw = backward_plain(dh_out, h, gates, wr, ctx.code)
        dwr = _weight_grad(dxw, h, gates) if ctx.needs_input_grad[1] else None
        return dxw, dwr, None


def gru_sequence(xw: torch.Tensor, wr: torch.Tensor, code: int) -> torch.Tensor:
    """One GRU layer over whole sequences: xw (B, T, 3n) the input products
    with the bias, wr (n, 3n) the recurrent kernel (gates z, r, c at column
    offsets 0, n, 2n), ``code`` the candidate's activation (model.py's
    TANH, SIGMOID or RELU) -> H (B, T, n) from a zero state.  On CUDA the
    kernels (n <= :data:`MAX_N`, float32, else an error); on the CPU the
    plain loops."""
    if xw.ndim != 3 or wr.ndim != 2 or wr.shape[1] != 3 * wr.shape[0] or xw.shape[2] != wr.shape[1]:
        raise ValueError(f"xw must be (B, T, 3n) for wr (n, 3n); got {tuple(xw.shape)}, {tuple(wr.shape)}")
    if code not in (TANH, SIGMOID, RELU):
        raise ValueError(f"unknown activation code {code}")
    if xw.device != wr.device:
        raise ValueError("xw and wr must be on one device")
    return GruSequence.apply(xw, wr, code)
