"""Table-based activation approximations (reference src/util.rs:29-53).

The reference evaluates tanh/sigmoid through a 201-entry table with a cubic
correction; output parity needs that approximation, not ``torch.tanh``.
"""

from __future__ import annotations

import functools

import torch

from ..tables import TANSIG_TABLE


@functools.lru_cache(maxsize=8)
def tansig_table(device: torch.device) -> torch.Tensor:
    """The 201-entry table on ``device``, uploaded once (kernel K5 reads
    it too)."""
    return torch.as_tensor(TANSIG_TABLE, device=device)


def tansig_approx(x: torch.Tensor) -> torch.Tensor:
    """Elementwise tanh approximation, exactly the reference's math.

    Clamps to ±1 outside (-8, 8); NaN maps to 1.0 (the reference's reversed
    comparisons catch NaNs in the first branch).
    """
    x = x.to(torch.float32)
    sign = torch.where(x < 0.0, -1.0, 1.0)
    ax = torch.clamp(torch.nan_to_num(x, nan=0.0).abs(), max=7.99)
    i = torch.floor(0.5 + 25.0 * ax)
    frac = ax - 0.04 * i
    y = tansig_table(x.device)[i.to(torch.int64)]
    dy = 1.0 - y * y
    y = y + frac * dy * (1.0 - y * frac)
    out = sign * y
    # Reference order: `if !(x < 8) return 1` (catches NaN), `if !(x > -8) return -1`.
    out = torch.where(x > -8.0, out, -1.0)
    return torch.where(x < 8.0, out, 1.0)


def sigmoid_approx(x: torch.Tensor) -> torch.Tensor:
    """0.5 + 0.5 * tansig(0.5 * x) (reference util.rs:47-49)."""
    return 0.5 + 0.5 * tansig_approx(0.5 * x)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0.0)
