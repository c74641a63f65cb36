"""The work of RNNoise 0.2's train step from its shapes alone
(``configs/rnnoise-0.2-train.json``): multiply-adds a frame of the forward
by ``rnnoise.py``'s layers, a step as 3 x 2 x those over batch x frames
(the forward, and a backward of twice the forward)."""

from __future__ import annotations


def macs(input_dim: int = 65, cond_size: int = 128, gru_size: int = 384, output_dim: int = 32) -> int:
    """Multiply-adds a frame: the two k=3 convolutions, three GRUs (input
    and recurrent products of 3 gates each) and the two heads over the
    1,536-wide concatenation."""
    conv = 3 * input_dim * cond_size + 3 * cond_size * gru_size
    grus = 3 * 2 * 3 * gru_size * gru_size
    head = 4 * gru_size * (output_dim + 1)
    return conv + grus + head


def train_step_flops(batch: int, frames: int, **widths) -> float:
    """3 x (2 x forward MACs) a frame, over batch x frames frames."""
    return 3.0 * 2.0 * macs(**widths) * batch * frames
