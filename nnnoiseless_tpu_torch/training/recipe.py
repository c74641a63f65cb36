"""What the trainer asks of a training topology: its :class:`Recipe`, which
the topology's own module defines (``network.RECIPE``, ``rn02.RECIPE``) and
``train.TOPOLOGIES`` names, and the optimizer plumbing the recipes share.
A topology is added by its module and one line in ``TOPOLOGIES``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch


@dataclass(frozen=True)
class Recipe:
    meta: Any  # the published widths; ``fit`` given widths of this type takes this recipe at them
    init: Callable  # (generator, meta) -> the model on the CPU, its weights drawn from generator
    optimizer: Callable  # (model, learning_rate, cosine_steps, lr_decay) -> its optimizer
    sample_weights: Callable  # (gains, device) -> per-sequence weights on device, or None
    load: Callable  # (path, window) -> (features, gains, vad), sequence-major
    numpy_params: Callable  # model -> its parameters as numpy arrays
    write: Callable  # (numpy params, path) -> None: the file the command line writes
    batch_size: int  # the command line's default
    out: str  # the command line's default output file
    check: Callable = lambda mesh, lr_schedule: None  # raises ValueError on what the recipe refuses


def adam_for_device(opt: torch.optim.Adam, schedule: Callable | None) -> torch.optim.Adam:
    """Adam's settings and state for its parameters' device: capturable on a
    card only, the learning rate a 0-d float32 tensor there, each
    parameter's state present (zero before the first update) with its
    update count a 0-d float32 tensor on that device.  ``schedule`` becomes
    ``opt.schedule``, which every step applies (``train._apply_schedule``):
    a group's learning rate, a device tensor, from the group's settings and
    its update count; None keeps the rate constant."""
    opt.schedule = schedule
    for group in opt.param_groups:
        dev = group["params"][0].device
        group["capturable"] = dev.type == "cuda"
        group["lr"] = torch.tensor(float(group["lr"]), dtype=torch.float32, device=dev)
        for p in group["params"]:
            state = opt.state[p]
            state["step"] = torch.tensor(float(state.get("step", 0.0)), dtype=torch.float32, device=dev)
            for key in ("exp_avg", "exp_avg_sq"):
                if key not in state:
                    state[key] = torch.zeros_like(p, memory_format=torch.preserve_format)
    return opt
