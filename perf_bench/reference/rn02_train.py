"""The plain reference of RNNoise 0.2's train step: xiph/rnnoise v0.2
``torch/rnnoise/rnnoise.py`` (class ``RNNoise``) and
``torch/rnnoise/train_rnnoise.py`` in plain float32 PyTorch.

It imports nothing of the program.  The convolutions are ``F.conv1d``;
each GRU is written out by ``torch.nn.GRU``'s equations (gates r, z, n,
the reset gate applied after the recurrent product), one layer over the
whole sequence before the next; the head is the concatenation of the
second convolution and the three GRUs; the loss is the recipe's, with its
targets cropped to frames 3 .. T - 2; autograd takes the gradient, and
AdamW with the recipe's ``LambdaLR(1 / (1 + d step))`` is written out.
Every product runs in float32 (both TF32 flags off) unless ``tf32``
asks for the control.  The recipe's block sparsification of the GRU
weights between steps is left out, as in the program.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

GRUS = ("gru1", "gru2", "gru3")
GAMMA = 0.25
BETAS = (0.8, 0.98)
ADAM_EPS = 1e-8
WEIGHT_DECAY = 0.01


def leaf_shapes(input_dim=65, cond_size=128, gru_size=384, output_dim=32) -> dict:
    """``rnnoise.py``'s parameter names and shapes."""
    g = gru_size
    out = {"conv1.weight": (cond_size, input_dim, 3), "conv1.bias": (cond_size,),
           "conv2.weight": (g, cond_size, 3), "conv2.bias": (g,)}
    for name in GRUS:
        out.update({f"{name}.weight_ih_l0": (3 * g, g), f"{name}.weight_hh_l0": (3 * g, g),
                    f"{name}.bias_ih_l0": (3 * g,), f"{name}.bias_hh_l0": (3 * g,)})
    out.update({"dense_out.weight": (output_dim, 4 * g), "dense_out.bias": (output_dim,),
                "vad_dense.weight": (1, 4 * g), "vad_dense.bias": (1,)})
    return out


@contextlib.contextmanager
def precision(tf32: bool):
    """Both TF32 flags set to ``tf32`` inside the block, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _gru(p, name, x):
    """torch.nn.GRU (batch_first, one layer) over (B, T, n) from a zero state."""
    w_ih, w_hh = p[f"{name}.weight_ih_l0"], p[f"{name}.weight_hh_l0"]
    b_ih, b_hh = p[f"{name}.bias_ih_l0"], p[f"{name}.bias_hh_l0"]
    gi = torch.matmul(x, w_ih.t()) + b_ih
    h = x.new_zeros((x.shape[0], w_hh.shape[1]))
    hs = []
    for gi_t in gi.unbind(1):  # a frame taken by indexing would add a whole-sequence gradient a step
        i_r, i_z, i_n = gi_t.chunk(3, 1)
        h_r, h_z, h_n = (torch.matmul(h, w_hh.t()) + b_hh).chunk(3, 1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        h = (1.0 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs, 1)


def forward(p: dict, f: torch.Tensor):
    """(B, T, 65) features -> (gains (B, T - 4, 32), vad (B, T - 4, 1))."""
    c = torch.tanh(F.conv1d(f.permute(0, 2, 1), p["conv1.weight"], p["conv1.bias"]))
    c = torch.tanh(F.conv1d(c, p["conv2.weight"], p["conv2.bias"])).permute(0, 2, 1)
    g1 = _gru(p, "gru1", c)
    g2 = _gru(p, "gru2", g1)
    g3 = _gru(p, "gru3", g2)
    cat = torch.cat([c, g1, g2, g3], -1)
    gains = torch.sigmoid(torch.matmul(cat, p["dense_out.weight"].t()) + p["dense_out.bias"])
    vad = torch.sigmoid(torch.matmul(cat, p["vad_dense.weight"].t()) + p["vad_dense.bias"])
    return gains, vad


def loss_fn(p: dict, batch: dict):
    """train_rnnoise.py's loss of one batch."""
    pred_gain, pred_vad = forward(p, batch["features"])
    gain, vad = batch["gains"][:, 3:-1], batch["vad"][:, 3:-1]
    target = torch.clamp(gain, min=0)
    target = target * torch.tanh(8 * target) ** 2
    e = pred_gain**GAMMA - target**GAMMA
    mask = torch.clamp(gain + 1, max=1)
    gain_loss = torch.mean((1 + 5.0 * vad) * mask * e**2)
    vad_loss = torch.mean(torch.abs(2 * vad - 1) * (-vad * torch.log(0.01 + pred_vad)
                                                    - (1 - vad) * torch.log(1.01 - pred_vad)))
    return gain_loss + 0.001 * vad_loss


def train(params0: dict, data: dict, batches: list, lr: float = 1e-3, lr_decay: float = 5e-5,
          tf32: bool = False):
    """AdamW steps from ``params0`` on the rows ``batches[i]`` of ``data``.
    Returns (losses, gradient of the first step, parameters after the
    last), each a float32 value or dict of leaves."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2 = BETAS
    losses, first_grad = [], None
    with precision(tf32):
        for step, idx in enumerate(batches, start=1):
            batch = {k: t.index_select(0, idx) for k, t in data.items()}
            loss = loss_fn(p, batch)
            grads = torch.autograd.grad(loss, list(p.values()))
            losses.append(loss.detach())
            lr_t = lr / (1.0 + lr_decay * (step - 1))
            with torch.no_grad():
                if first_grad is None:
                    first_grad = {k: g.clone() for k, g in zip(p, grads)}
                for (k, w), g in zip(p.items(), grads):
                    w.mul_(1.0 - lr_t * WEIGHT_DECAY)
                    m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                    m_hat = m[k] / (1.0 - b1**step)
                    v_hat = v2[k] / (1.0 - b2**step)
                    w.sub_(lr_t * m_hat / (torch.sqrt(v_hat) + ADAM_EPS))
            del loss, grads
    return torch.stack(losses), first_grad, {k: w.detach() for k, w in p.items()}
