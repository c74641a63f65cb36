"""Profiling harness for the denoise engine.

The reference's only performance harness is a criterion micro-benchmark
over 1 s of a 440 Hz sine (benches/sin.rs).  Here:

* ``sine_bench()`` runs the same workload (fresh state, 100 frames of a
  440 Hz sine) through :class:`StreamBatch`, at a batch of identical
  streams, on one device, and reports wall time and realtime factor;
* ``--trace DIR`` wraps the timed run in ``torch.profiler`` and writes a
  Chrome trace (``DIR/trace.json``) of every kernel and op.

Usage::

    python -m nnnoiseless_tpu_torch.tools.profile                  # B=1 on cuda
    python -m nnnoiseless_tpu_torch.tools.profile --batch 4096
    python -m nnnoiseless_tpu_torch.tools.profile --trace out_dir  # + trace
"""

from __future__ import annotations

import argparse
import contextlib
import pathlib
import sys
import time

import numpy as np
import torch


def sine_signal(seconds: float = 1.0, freq: float = 440.0) -> np.ndarray:
    """48 kHz mono sine in the i16 range, like benches/sin.rs:9-14."""
    n = int(48_000 * seconds)
    t = np.arange(n, dtype=np.float64) / 48_000.0
    return (np.sin(2 * np.pi * freq * t) * 16_000).astype(np.float32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def maybe_trace(trace_dir, device: torch.device):
    """Profile the body with torch.profiler (CPU ops, and the card's
    kernels on a CUDA device) and export ``trace_dir/trace.json``."""
    if not trace_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    out = pathlib.Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))


def sine_bench(batch: int = 1, seconds: float = 1.0, trace_dir=None, device="cuda") -> dict:
    """Run the sine workload on ``device``; returns timing stats (kernel
    build and warm-up excluded).  The timed call includes the host copies
    in and out, as a caller of :meth:`StreamBatch.process` sees them."""
    from ..constants import FRAME_SIZE
    from ..denoise import StreamBatch

    device = torch.device(device)
    sig = sine_signal(seconds)
    t = len(sig) // FRAME_SIZE
    frames = np.broadcast_to(
        sig[: t * FRAME_SIZE].reshape(1, t, FRAME_SIZE), (batch, t, FRAME_SIZE)
    ).copy()

    sb = StreamBatch(batch, device=device)
    sb.process(frames)  # kernel build + warm-up
    sb.reset()
    _sync(device)

    with maybe_trace(trace_dir, device):
        t0 = time.perf_counter()
        sb.process(frames)
        _sync(device)
        dt = time.perf_counter() - t0

    frames_total = batch * t
    return {
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "batch": batch,
        "frames": t,
        "seconds_audio": frames_total / 100.0,
        "wall_s": dt,
        "frames_per_sec": frames_total / dt,
        "realtime_factor": frames_total / dt / 100.0,
        "us_per_frame": dt / frames_total * 1e6,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--trace", default=None, help="write a torch.profiler Chrome trace here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(f"error: --device {args.device}: no CUDA device is available", file=sys.stderr)
        return 1
    stats = sine_bench(args.batch, args.seconds, args.trace, args.device)
    for k, v in stats.items():
        print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
