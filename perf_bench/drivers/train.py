"""Training: one ``programs.TrainProgram`` of
``training.train.train_step_indexed``, built as ``fit(mesh=None)`` builds
it (``make_optimizer``: Adam, capturable on a card, the learning rate a
device tensor), replayed a step at a time.

Set-up makes the dataset and the initial weights on the device from the
seed, builds the program and drives it through its first ``check_steps``
steps through the window's own call (the first call warms up and captures
the graph); the losses, the gradient Adam took at the first step (its
first moment over 1 - beta1) and the parameters after the last are kept
for the check.  Each step copies the next ``batch`` indices of a seeded
epoch permutation into the program's index vector, as ``fit`` does; the
window runs on from there, one synchronised step at a time.
"""

from __future__ import annotations

import time

import torch

from ..reference import train as ref_train
from ..trace import traced
from ..traffic import init_params, make_train_rows, sample_weights
from . import train_check


class Cell:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        tr = cell.traffic
        self.n_seq, self.frames, self.batch = tr["sequences"], tr["sequence_frames"], tr["batch"]
        self.gen = torch.Generator(device=device).manual_seed((int(seed) + 2) % (1 << 63))
        self.perm, self.at = None, 0

    def _next(self) -> torch.Tensor:
        if self.perm is None or self.at + self.batch > self.n_seq:
            self.perm = torch.randperm(self.n_seq, generator=self.gen, device=self.device)
            self.at = 0
        self.at += self.batch
        return self.perm[self.at - self.batch : self.at]

    def setup(self):
        from nnnoiseless_tpu_torch.programs import TrainProgram
        from nnnoiseless_tpu_torch.training import train as trainer
        from nnnoiseless_tpu_torch.training.network import DEFAULT_META, TrainableModel

        tr, dev = self.cell.traffic, self.device
        self.data = make_train_rows(self.n_seq, self.frames, self.seed, dev, tr["unknown_share"], tr["vad_switch"])
        self.seq_w = sample_weights(self.data["gains"])
        self.p0 = init_params(ref_train.leaf_shapes(), self.seed + 1, dev)
        model = TrainableModel(DEFAULT_META, device=dev)
        model.load_state_dict(self.p0)
        opt = trainer.make_optimizer(model, self.cell.config["learning_rate"])
        data, seq_w = self.data, self.seq_w
        self.program = TrainProgram(lambda idx: trainer.train_step_indexed(model, opt, data, idx, seq_w),
                                    model, opt, self.batch)
        self.model, self.opt = model, opt
        self._first_steps()

    def _first_steps(self):
        """The first ``check_steps`` steps, through the window's own call."""
        model, opt = self.model, self.opt
        self.batches, losses = [], []
        beta1 = opt.param_groups[0]["betas"][0]
        for s in range(self.cell.traffic["check_steps"]):
            idx = self._next()
            self.batches.append(idx.clone())
            losses.append(self.program(idx).clone())
            if s == 0:
                self.grad1 = {n: opt.state[p]["exp_avg"] / (1.0 - beta1) for n, p in model.named_parameters()}
        self.losses = torch.stack(losses)
        self.p_end = {n: p.detach().clone() for n, p in model.named_parameters()}
        self._sync()

    def reseed(self, seed: int):
        """The state of a fresh set-up at ``seed`` written into this cell's
        program in place (dataset, weights, Adam's state, permutation), then
        its first steps: a program built and captured once serves many seeds
        (``perf_bench/control.py``)."""
        tr, dev = self.cell.traffic, self.device
        self.seed = seed
        with torch.no_grad():
            rows = make_train_rows(self.n_seq, self.frames, seed, dev, tr["unknown_share"], tr["vad_switch"])
            for k, v in rows.items():
                self.data[k].copy_(v)
            del rows
            self.seq_w.copy_(sample_weights(self.data["gains"]))
            self.p0 = init_params(ref_train.leaf_shapes(), seed + 1, dev)
            for n, p in self.model.named_parameters():
                p.copy_(self.p0[n])
                for t in self.opt.state[p].values():
                    t.zero_()
        self.gen.manual_seed((int(seed) + 2) % (1 << 63))
        self.perm, self.at = None, 0
        self._first_steps()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> dict:
        steps = 0
        t0 = time.perf_counter()
        while True:
            self.program(self._next())
            self._sync()
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        return {"attempted": steps, "failed": 0, "steps": steps, "seconds": wall,
                "train_step_ms": wall / steps * 1e3, "batch": self.batch, "sequence_frames": self.frames}

    def traced(self):
        """One replay."""
        return traced(lambda i: self.program(self._next()), 1, self.device)

    def program_stats(self) -> dict:
        prog = self.program.program
        return {"warmup_s": prog.warmup_s, "capture_s": prog.capture_s}

    def keep_rows(self):
        """Copy out the rows of the checked steps."""
        rows = torch.cat(self.batches)
        self.rows = {k: v.index_select(0, rows) for k, v in self.data.items()}
        self.rows_w = self.seq_w.index_select(0, rows)
        n = self.batch
        self.local = [torch.arange(i * n, (i + 1) * n, device=self.device) for i in range(len(self.batches))]

    def release(self):
        """Keep the checked steps' rows; free the program, its state and the dataset."""
        self.keep_rows()
        del self.program, self.model, self.opt, self.data
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list:
        ref = ref_train.train(self.p0, self.rows, self.rows_w, self.local, self.cell.config["learning_rate"])
        return train_check.compare((self.losses, self.grad1, self.p_end), ref, self.p0, self.cell.limits)
