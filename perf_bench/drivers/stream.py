"""Many streams through one ``StreamBatch``: closed loop, one
``process_tensor`` call a chunk, chunks back to back.

Each stream is a segment of ``segment_chunks`` chunks; then the batch is
reset and the next segments start.  The inputs of ``buffers`` segments are
made on the device in set-up, chunk-major, and segment g reads buffer
g mod ``buffers``; inputs and outputs stay on the card.  The window copies
the output and VAD of ``sample_streams`` streams of each segment, drawn
from the seed anywhere in the batch, into slots on the card allocated 64
chunks at a time (a new allocation each chunk would stall the loop in
``cudaMalloc``); the check runs the reference over ``check_streams`` of
those stream-segments drawn from the seed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..reference.denoise import Reference
from ..traffic import make_audio
from ..trace import traced
from . import serve_check

FRAME = 480
SLOTS = 64


class Cell:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        tr = cell.traffic
        self.b, self.t, self.seg_chunks = tr["streams"], tr["chunk_frames"], tr["segment_chunks"]
        self.rng = np.random.default_rng(seed)
        self.saved = []  # (segment, chunk, streams, slot index)
        self.slots = []  # blocks of SLOTS chunks: out (SLOTS, k, T, 480), vad (SLOTS, k, T)

    def setup(self):
        from nnnoiseless_tpu_torch.denoise import StreamBatch
        from nnnoiseless_tpu_torch.model import RnnModel

        tr, dev = self.cell.traffic, self.device
        model = RnnModel.from_file(self.cell.repo / self.cell.config["model_file"])
        self.batch = StreamBatch(self.b, model=model, device=dev)
        n = self.seg_chunks * self.t * FRAME
        self.bufs = []
        for k in range(tr["buffers"]):
            audio = make_audio(self.b, n, self.seed + 7919 * k, dev, tr)
            buf = torch.empty((self.seg_chunks, self.b, self.t, FRAME), device=dev)
            buf.copy_(audio.view(self.b, self.seg_chunks, self.t, FRAME).transpose(0, 1))
            del audio
            self.bufs.append(buf)
        for c in range(tr["warmup_chunks"]):
            self.batch.process_tensor(self.bufs[0][c])
        self.batch.reset()
        self.ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) \
            if dev.type == "cuda" else None
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _pick(self) -> tuple:
        """``sample_streams`` distinct streams, as a list and as an index on the card."""
        ids = sorted(self.rng.choice(self.b, size=self.cell.traffic["sample_streams"], replace=False).tolist())
        return ids, torch.tensor(ids, device=self.device)

    def _slot(self, i: int) -> tuple:
        if i // SLOTS == len(self.slots):
            k = self.cell.traffic["sample_streams"]
            self.slots.append((torch.empty((SLOTS, k, self.t, FRAME), device=self.device),
                               torch.empty((SLOTS, k, self.t), device=self.device)))
        out, vad = self.slots[i // SLOTS]
        return out[i % SLOTS], vad[i % SLOTS]

    def _chunk(self, seg: int, c: int):
        return self.batch.process_tensor(self.bufs[seg % len(self.bufs)][c])

    def window(self, seconds: float) -> dict:
        lat = []
        seg = c = done = 0
        ids, index = self._pick()
        self._slot(0)
        t0 = time.perf_counter()
        while True:
            if self.ev is not None:
                self.ev[0].record()
            out, vad = self._chunk(seg, c)
            if self.ev is not None:
                self.ev[1].record()
            out_slot, vad_slot = self._slot(done)
            torch.index_select(out, 0, index, out=out_slot)
            torch.index_select(vad, 0, index, out=vad_slot)
            self.saved.append((seg, c, ids, done))
            if self.ev is not None:
                self.ev[1].synchronize()
                lat.append(self.ev[0].elapsed_time(self.ev[1]))
            del out, vad
            done += 1
            c += 1
            if c == self.seg_chunks:
                seg, c = seg + 1, 0
                self.batch.reset()
                ids, index = self._pick()
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        wall = time.perf_counter() - t0
        frames = done * self.b * self.t
        return {
            "attempted": done * self.b, "failed": 0, "chunks": done, "frames": frames, "seconds": wall,
            "realtime_x": frames * 0.01 / wall,
            "chunk_p95_ms": float(np.percentile(lat, 95)) if lat else float("nan"),
        }

    def traced(self):
        """One whole segment from a reset, ``segment_chunks`` chunks."""
        self.batch.reset()
        return traced(lambda i: self._chunk(0, i), self.seg_chunks, self.device)

    def program_stats(self) -> dict:
        return {}

    def release(self):
        """Keep each sampled stream-segment's input and the program's
        outputs; free the program and the rest of its inputs."""
        by = {}
        for seg, c, ids, i in self.saved:
            out, vad = self._slot(i)
            for j, s in enumerate(ids):
                by.setdefault((seg, s), []).append((c, out[j], vad[j]))
        keys = sorted(by)
        pick = self.rng.choice(len(keys), size=min(self.cell.traffic["check_streams"], len(keys)), replace=False)
        self.pairs = []
        for i in sorted(pick):
            seg, s = keys[i]
            parts = sorted(by[(seg, s)], key=lambda p: p[0])
            n = len(parts) * self.t
            self.pairs.append({
                "input": self.bufs[seg % len(self.bufs)][:, s].reshape(-1, FRAME).clone(),
                "out": torch.cat([p[1] for p in parts]), "vad": torch.cat([p[2] for p in parts]), "frames": n,
            })
        del self.saved, self.slots, self.bufs, self.batch
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list:
        ref = Reference(self.cell.repo / self.cell.config["model_file"], self.device)
        return serve_check.compare(ref, self.pairs, self.cell.limits)
