"""The plain reference of the train step: xiph/rnnoise training/rnn_train.py
(Keras GRUs with ``reset_after=False``, losses ``mycost`` and
``my_crossentropy`` weighted 10 : 0.5 with per-sequence sample weights,
l2(1e-6) on the GRU kernels, Adam, WeightClip(0.499)) in plain PyTorch.

It imports nothing of the program.  Each layer runs over the whole
sequence before the next (the input products of a layer are one product
over all frames), autograd takes the gradient, and Adam is written out.
"""

from __future__ import annotations

import torch

from . import tables as tb

# (inputs, neurons, activation) of the trained topology, rnn_train.py:65-77
META = {
    "input_dense": (42, 24, tb.TANH),
    "vad_gru": (24, 24, tb.TANH),
    "noise_gru": (90, 48, tb.RELU),
    "denoise_gru": (114, 96, tb.TANH),
    "denoise_output": (96, 22, tb.SIGMOID),
    "vad_output": (24, 1, tb.SIGMOID),
}
CLIP = 0.499
GRU_L2 = 1e-6
EPS = 1e-7
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def leaf_names() -> list:
    """``"<layer>.<name>"`` of every parameter, in layer order."""
    return [f"{layer}.{k}" for layer in tb.LAYERS for k in (("wi", "wr", "b") if layer in tb.GRUS else ("w", "b"))]


def leaf_shapes() -> dict:
    out = {}
    for layer in tb.LAYERS:
        n_in, n, _ = META[layer]
        if layer in tb.GRUS:
            out.update({f"{layer}.wi": (n_in, 3 * n), f"{layer}.wr": (n, 3 * n), f"{layer}.b": (3 * n,)})
        else:
            out.update({f"{layer}.w": (n_in, n), f"{layer}.b": (n,)})
    return out


def _act(x, act):
    return torch.tanh(x) if act == tb.TANH else torch.sigmoid(x) if act == tb.SIGMOID else torch.relu(x)


def _dense(p, layer, x):
    return _act(x @ p[f"{layer}.w"] + p[f"{layer}.b"], META[layer][2])


def _gru(p, layer, x):
    """A Keras reset_after=False GRU over (B, T, in) from a zero state."""
    n, act = META[layer][1], META[layer][2]
    xw = x @ p[f"{layer}.wi"] + p[f"{layer}.b"]
    wzr, wh = p[f"{layer}.wr"][:, : 2 * n], p[f"{layer}.wr"][:, 2 * n :]
    h = x.new_zeros((x.shape[0], n))
    hs = []
    for t in range(x.shape[1]):
        zr = torch.sigmoid(xw[:, t, : 2 * n] + h @ wzr)
        z, r = zr[:, :n], zr[:, n:]
        h = z * h + (1.0 - z) * _act(xw[:, t, 2 * n :] + (r * h) @ wh, act)
        hs.append(h)
    return torch.stack(hs, 1)


def forward(p: dict, f: torch.Tensor):
    """(B, T, 42) features -> (gains (B, T, 22), vad (B, T, 1))."""
    d = _dense(p, "input_dense", f)
    hv = _gru(p, "vad_gru", d)
    hn = _gru(p, "noise_gru", torch.cat([d, hv, f], -1))
    hd = _gru(p, "denoise_gru", torch.cat([hv, hn, f], -1))
    return _dense(p, "denoise_output", hd), _dense(p, "vad_output", hv)


def _bce(t, y):
    y = torch.clamp(y, EPS, 1.0 - EPS)
    t = torch.clamp(t, 0.0, 1.0)
    return -(t * torch.log(y) + (1.0 - t) * torch.log(1.0 - y))


def loss_fn(p, batch, weights):
    """10 mycost + 0.5 my_crossentropy, the weighted mean over the batch's
    frames, plus the GRUs' l2.  ``weights``: (B,) per-sequence weights."""
    g_true, v_true = batch["gains"], batch["vad"]
    g_pred, v_pred = forward(p, batch["features"])
    d = torch.sqrt(torch.clamp(g_pred, min=0.0)) - torch.sqrt(torch.clamp(g_true, min=0.0))
    d2 = d * d
    mask = torch.clamp(g_true + 1.0, max=1.0)
    gain = (mask * (10.0 * d2 * d2 + d2 + 0.01 * _bce(g_true, g_pred))).mean(-1)
    vad = (2.0 * torch.abs(v_true - 0.5) * _bce(v_true, v_pred)).mean(-1)
    w = weights[:, None].expand(gain.shape)
    loss = ((10.0 * gain + 0.5 * vad) * w).sum() / torch.clamp(w.sum(), min=1e-6)
    l2 = sum((p[f"{g}.{k}"] ** 2).sum() for g in tb.GRUS for k in ("wi", "wr"))
    return loss + GRU_L2 * l2


def train(params0: dict, data: dict, seq_weights: torch.Tensor, batches: list, lr: float = 1e-3):
    """Adam steps from ``params0`` on the rows ``batches[i]`` of ``data``.
    Returns (losses, gradient of the first step, parameters after the
    last), each a float32 value or dict of leaves."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2 = BETAS
    losses, first_grad = [], None
    for step, idx in enumerate(batches, start=1):
        batch = {k: t.index_select(0, idx) for k, t in data.items()}
        loss = loss_fn(p, batch, seq_weights.index_select(0, idx))
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(loss.detach())
        with torch.no_grad():
            if first_grad is None:
                first_grad = {k: g.clone() for k, g in zip(p, grads)}
            for (k, w), g in zip(p.items(), grads):
                m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                m_hat = m[k] / (1.0 - b1**step)
                v_hat = v2[k] / (1.0 - b2**step)
                w.sub_(lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS))
                w.clamp_(-CLIP, CLIP)
    return torch.stack(losses), first_grad, {k: w.detach() for k, w in p.items()}
