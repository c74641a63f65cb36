"""The comparison that decides ``correct`` for the serving cells.

Each checked stream-segment is run through the plain reference from a
reset, over its whole input; its first ``frames`` frames (those the window
finished) are compared with what the program produced:

* ``out_rel``: the median over the checked stream-segments of each one's
  squared error over its squared reference output, summed over its
  samples (the golden clip's measure);
* ``vad_err``: the median over them of each one's mean absolute VAD
  difference;
* ``<number>_far``, for each number the limits' ``far`` names: how many
  stream-segments read above the limit given there, each held on its own.

A pitch-lag decision that flips at a near-tie between two lags of the
search (the kernels' f32 sums in another order), or a silence gate that
flips where the HP filter's tail crosses its threshold, moves one
stream-segment by much and rarely (on the card, 2 of 8,192 segments of a
seed above 1e-3, 29 above 1e-4, the median 7.7e-8): the medians do not
move with it, while a lower precision moves every segment.  A fault in
some of the streams or segments (a tile's edge, a carry in some lanes, one
of the buffers) moves those alone: the ``_far`` counts see it, and allow
only the few rare flips.

The control is the reference computed with TF32 products
(``run_reference(..., control=True)``), put in the program's place.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def tf32(on: bool):
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def run_reference(ref, pairs: list, block: int = 128, control: bool = False):
    """The reference's (out, vad) of every pair, in blocks of streams."""
    outs, vads = [], []
    with tf32(control):
        for i in range(0, len(pairs), block):
            frames = torch.stack([p["input"] for p in pairs[i : i + block]])
            o, v = ref.run(frames)
            outs.extend(o.unbind(0))
            vads.extend(v.unbind(0))
    return outs, vads


def per_segment(pairs: list, got_out: list, got_vad: list, ref_out: list, ref_vad: list):
    """Each stream-segment's (relative squared error, mean |VAD difference|)."""
    rel, vad = [], []
    for p, go, gv, ro, rv in zip(pairs, got_out, got_vad, ref_out, ref_vad):
        n = p["frames"]
        ro = ro[:n].double()
        err, energy = (go[:n].double() - ro).pow(2).sum(), ro.pow(2).sum()
        rel.append(float(err / energy) if energy > 0 else (0.0 if err == 0 else float("inf")))
        vad.append(float((gv[:n].double() - rv[:n].double()).abs().mean()))
    return rel, vad


def numbers(pairs: list, got_out: list, got_vad: list, ref_out: list, ref_vad: list, far: dict) -> dict:
    """The medians, and for each ``far`` entry (``out_rel`` or ``vad_err``:
    a segment's limit) the count of segments above it."""
    each = dict(zip(("out_rel", "vad_err"), per_segment(pairs, got_out, got_vad, ref_out, ref_vad)))
    vals = {k: float(np.median(v)) for k, v in each.items()}
    for k, lim in far.items():
        vals[f"{k}_far"] = float(sum(v > lim for v in each[k]))
    return vals


def compared(limits: dict) -> dict:
    """The numbers compared and their limits (all but ``far``)."""
    return {k: float(lim) for k, lim in limits.items() if k != "far"}


def compare(ref, pairs: list, limits: dict) -> list:
    """[(name, value, limit)] of the program's outputs against the
    reference, for each number the cell's limits name."""
    ref_out, ref_vad = run_reference(ref, pairs)
    vals = numbers(pairs, [p["out"] for p in pairs], [p["vad"] for p in pairs], ref_out, ref_vad,
                   limits.get("far", {}))
    return [(k, vals[k], lim) for k, lim in compared(limits).items()]
