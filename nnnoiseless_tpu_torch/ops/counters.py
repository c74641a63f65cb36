"""The kernel wrappers' launch counters, read and added to by kernel name."""

from __future__ import annotations

from . import fft, frame_kernel, gru_reset_after, gru_seq, pitch_kernel, rnn_kernel, window

# The kernel wrappers' launch counters, by the names the tools print.
COUNTERS = {
    "K1": (pitch_kernel, "launches"),
    "K2": (frame_kernel, "launches"),
    "K3": (pitch_kernel, "stacked_launches"),
    "K4": (frame_kernel, "cand_launches"),
    "K5": (rnn_kernel, "launches"),
    "K6": (window, "launches"),
    "K7": (gru_seq, "launches"),  # forward and backward
    "K7 backward": (gru_seq, "backward_launches"),
    "K8": (gru_reset_after, "launches"),  # forward and backward
    "K8 backward": (gru_reset_after, "backward_launches"),
    "probe": (fft, "launches"),
}


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel name."""
    return {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}


def add_counts(counts: dict) -> None:
    """Add ``counts`` (kernel name -> launches) to the wrappers' counters."""
    for name, n in counts.items():
        mod, attr = COUNTERS[name]
        setattr(mod, attr, getattr(mod, attr) + n)
