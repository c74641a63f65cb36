"""One stream, frame by frame: closed loop, ``DenoiseState.process_frame``
on one 480-sample numpy frame at a time, back to back.

Calls come in segments of ``segment_frames`` frames, then ``reset()``.  The
audio of ``segments`` segments is made in set-up (on the device, by the
benchmark's generator) and kept on the host; segment g plays segment
g mod ``segments``.  Every output of the window is kept on the host; the
check runs the reference over ``check_segments`` segments of the window
drawn from the seed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..reference.denoise import Reference
from ..trace import traced
from ..traffic import make_audio
from . import serve_check

FRAME = 480


class Cell:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        tr = cell.traffic
        self.seg_frames, self.n_audio = tr["segment_frames"], tr["segments"]
        self.rng = np.random.default_rng(seed)

    def setup(self):
        from nnnoiseless_tpu_torch.denoise import DenoiseState
        from nnnoiseless_tpu_torch.model import RnnModel

        tr = self.cell.traffic
        model = RnnModel.from_file(self.cell.repo / self.cell.config["model_file"])
        self.state = DenoiseState(model, device=self.device)
        audio = make_audio(self.n_audio, self.seg_frames * FRAME, self.seed, self.device, tr)
        self.audio = audio.cpu().numpy().reshape(self.n_audio, self.seg_frames, FRAME)
        for i in range(tr["warmup_frames"]):
            self.state.process_frame(self.audio[0, i])
        self.state.reset()

    def window(self, seconds: float) -> dict:
        """Every call's output, VAD and latency go to host blocks of one
        segment each, allocated as the window reaches them."""
        blocks = []  # (out (segment_frames, 480), vad, latency) a segment
        n = 0
        process = self.state.process_frame
        t0 = time.perf_counter()
        while True:
            g, f = divmod(n, self.seg_frames)
            if f == 0:
                blocks.append((np.empty((self.seg_frames, FRAME), np.float32),
                               np.empty(self.seg_frames, np.float32), np.empty(self.seg_frames)))
            out_b, vad_b, lat_b = blocks[g]
            frame = self.audio[g % self.n_audio, f]
            c0 = time.perf_counter()
            out, vad = process(frame)
            lat_b[f] = time.perf_counter() - c0
            out_b[f], vad_b[f] = out, vad
            n += 1
            if f == self.seg_frames - 1:
                self.state.reset()
            if c0 - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        self.calls = n
        self.out = np.concatenate([b[0] for b in blocks])
        self.vad = np.concatenate([b[1] for b in blocks])
        lat_ms = np.concatenate([b[2] for b in blocks])[:n] * 1e3
        return {"attempted": n, "failed": 0, "calls": n, "seconds": wall,
                "frame_p95_ms": float(np.percentile(lat_ms, 95))}

    def traced(self):
        """``trace_frames`` calls from a reset."""
        self.state.reset()
        frames = self.audio[0]
        return traced(lambda i: self.state.process_frame(frames[i]), self.cell.traffic["trace_frames"], self.device)

    def program_stats(self) -> dict:
        prog = self.state.program.program
        return {"warmup_s": prog.warmup_s, "capture_s": prog.capture_s}

    def release(self):
        segs = -(-self.calls // self.seg_frames)
        pick = self.rng.choice(segs, size=min(self.cell.traffic["check_segments"], segs), replace=False)
        self.pairs = []
        for g in sorted(pick):
            lo, hi = g * self.seg_frames, min((g + 1) * self.seg_frames, self.calls)
            self.pairs.append({
                "input": torch.as_tensor(self.audio[g % self.n_audio], device=self.device),
                "out": torch.as_tensor(self.out[lo:hi], device=self.device),
                "vad": torch.as_tensor(self.vad[lo:hi], device=self.device),
                "frames": hi - lo,
            })
        del self.state, self.out, self.vad
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list:
        ref = Reference(self.cell.repo / self.cell.config["model_file"], self.device)
        return serve_check.compare(ref, self.pairs, self.cell.limits)
