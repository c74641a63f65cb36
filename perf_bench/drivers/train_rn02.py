"""Training RNNoise 0.2 (xiph/rnnoise v0.2's network and recipe): one
``programs.TrainProgram`` of ``training.train.train_step_indexed`` over an
``Rn02Model``, built as ``fit(topology="rnnoise-0.2")`` builds it
(``make_adamw``: AdamW, capturable on a card, the learning rate a device
tensor that the step decays), replayed a step at a time.

As ``drivers/train.py`` for the 2018 network, whose ``Cell`` this one
extends: the dataset and the initial weights are made on the device from
the seed, the first ``check_steps`` steps run through the window's own call
(the first call warms up and captures the graph) and are kept for the
check, and each step copies the next ``batch`` indices of a seeded epoch
permutation into the program's index vector.  Here the rows are 65
features, 32 gains and one VAD, the widths come from the configuration,
the weights are torch's default initialisation, there are no sample
weights, and the check runs ``reference/rn02_train.py``.  The traced
stretch is one replay alone, so that its device operations are the graph's
nodes, which ``program_stats()`` hands the readers with each phase's share.

The window is the 2018 cell's: ``train_step_ms`` is its wall time over its steps.
"""

from __future__ import annotations

import math

import torch

from ..reference import rn02_train as ref
from ..trace import traced
from ..traffic import _generator
from . import train, train_check


def widths(config: dict) -> dict:
    """The configuration's widths, by ``rnnoise.py``'s names."""
    return {k: config[k] for k in ("input_dim", "cond_size", "gru_size", "output_dim")}


def make_rows(n_seq: int, frames: int, seed: int, device, dims: dict, unknown_share: float,
              vad_switch: float) -> dict:
    """{features (N, T, input_dim), gains (N, T, output_dim), vad (N, T, 1)}
    float32 on ``device``, drawn as ``traffic.make_train_rows`` draws the
    2018 rows: standard Gaussian features; gains u^e with e = exp(N(0, 1))
    a sequence and a share at -1; VAD 0 or 1 in runs whose ends come with
    probability ``vad_switch`` a frame."""
    n_in, n_out = dims["input_dim"], dims["output_dim"]
    dev = torch.device(device)
    g = _generator(seed, dev)
    feats = torch.randn((n_seq, frames, n_in), generator=g, device=dev)
    expo = torch.exp(torch.randn((n_seq, 1, 1), generator=g, device=dev))
    gains = torch.rand((n_seq, frames, n_out), generator=g, device=dev) ** expo
    unknown = torch.rand((n_seq, frames, n_out), generator=g, device=dev) < unknown_share
    gains = torch.where(unknown, -1.0, gains)
    flips = (torch.rand((n_seq, frames), generator=g, device=dev) < vad_switch).long()
    start = torch.randint(0, 2, (n_seq, 1), generator=g, device=dev)
    vad = ((flips.cumsum(1) + start) % 2).float()[..., None]
    return {"features": feats, "gains": gains, "vad": vad}


def init_params(shapes: dict, seed: int, device) -> dict:
    """torch's default initialisation of Conv1d, GRU and Linear from one draw
    on the device: each tensor uniform in +-1/sqrt(fan), fan the input
    channels times the kernel, the hidden size, or the input features."""
    g = _generator(seed, device)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.rand(total, generator=g, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, shape in shapes.items():
        layer = name.split(".")[0]
        fan = math.prod((shapes.get(f"{layer}.weight_hh_l0") or shapes[f"{layer}.weight"])[1:])
        size = math.prod(shape)
        out[name] = flat[at : at + size].reshape(shape) / math.sqrt(fan)
        at += size
    return out


class Cell(train.Cell):
    def _fill(self, seed: int):
        """The dataset and the initial weights of ``seed``."""
        tr, dims = self.cell.traffic, widths(self.cell.config)
        rows = make_rows(self.n_seq, self.frames, seed, self.device, dims, tr["unknown_share"], tr["vad_switch"])
        return rows, init_params(ref.leaf_shapes(**dims), seed + 1, self.device)

    def setup(self):
        from nnnoiseless_tpu_torch.programs import TrainProgram
        from nnnoiseless_tpu_torch.training import train as trainer
        from nnnoiseless_tpu_torch.training.rn02 import Rn02Meta, Rn02Model

        cfg = self.cell.config
        self.data, self.p0 = self._fill(self.seed)
        model = Rn02Model(Rn02Meta(**widths(cfg)), device=self.device)
        model.load_state_dict(self.p0)
        opt = trainer.make_adamw(model, cfg["learning_rate"], cfg["lr_decay"])
        data = self.data
        self.program = TrainProgram(lambda idx: trainer.train_step_indexed(model, opt, data, idx, None),
                                    model, opt, self.batch)
        self.model, self.opt = model, opt
        self._first_steps()

    def reseed(self, seed: int):
        """The state of a fresh set-up at ``seed`` written into this cell's
        program in place, then its first steps (``perf_bench/control_rn02.py``)."""
        self.seed = seed
        with torch.no_grad():
            rows, self.p0 = self._fill(seed)
            for k, v in rows.items():
                self.data[k].copy_(v)
            del rows
            for n, p in self.model.named_parameters():
                p.copy_(self.p0[n])
                for t in self.opt.state[p].values():
                    t.zero_()
        self.gen.manual_seed((int(seed) + 2) % (1 << 63))
        self.perm, self.at = None, 0
        self._first_steps()

    def traced(self):
        """One replay; its index vector is filled before the profiler starts."""
        self.program.idx.copy_(self._next())
        return traced(lambda i: self.program.program(), 1, self.device)

    def program_stats(self) -> dict:
        prog = self.program.program
        return {"warmup_s": prog.warmup_s, "capture_s": prog.capture_s, "graph_nodes": prog.graph_nodes,
                "phase_nodes": dict(prog.phase_nodes)}

    def keep_rows(self):
        """Copy out the rows of the checked steps."""
        rows = torch.cat(self.batches)
        self.rows = {k: v.index_select(0, rows) for k, v in self.data.items()}
        n = self.batch
        self.local = [torch.arange(i * n, (i + 1) * n, device=self.device) for i in range(len(self.batches))]

    def reference(self, batches=None, tf32: bool = False):
        """The reference's first steps from this cell's weights on its rows."""
        cfg = self.cell.config
        return ref.train(self.p0, self.rows, self.local if batches is None else batches,
                         cfg["learning_rate"], cfg["lr_decay"], tf32)

    def check(self) -> list:
        return train_check.compare((self.losses, self.grad1, self.p_end), self.reference(), self.p0,
                                   self.cell.limits)
