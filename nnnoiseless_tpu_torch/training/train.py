"""Training loop: Adam + weight clipping, on one device or data-parallel
over a 1-D ``torch.distributed`` device mesh.

The counterpart of ``nnnoiseless_tpu/training/train.py``, the equivalent of
train/rnn_train.py (same topology, losses, loss weights, sequence length
2000, batch 32, sample reweighting by mean gain tertile).  A second
topology, RNNoise 0.2's network (:mod:`.rn02`), trains by its own recipe
(xiph/rnnoise v0.2 ``torch/rnnoise/train_rnnoise.py``: its loss, AdamW
with the learning rate ``lr / (1 + d step)``, batch 128, no sample
weights, no l2, no clip) on one device:
``fit(..., topology="rnnoise-0.2")``.  What differs between topologies
is each one's :class:`recipe.Recipe`, in its own module, named in
:data:`TOPOLOGIES`; nothing here asks which topology it trains.  The dataset goes
to the device once; each step gathers its batch there from a (B,) index
vector (:func:`train_step_indexed`).  Over a mesh every rank holds the
whole dataset and takes its slice of each step's index vector, and one
all-reduce a step makes the step that of the global batch
(:func:`train_step_dp`).  Either step runs as a ``programs.TrainProgram``:
on a card one captured CUDA graph a step (Adam ``capturable``; over a mesh
the NCCL all-reduce is inside the graph), on the CPU the eager step.

Usage::

    python -m nnnoiseless_tpu_torch.training.train --data training.h5 \
        --epochs 20 --out weights.rnn --device cuda
    python -m nnnoiseless_tpu_torch.training.train --topology rnnoise-0.2 \
        --data features.f32 --epochs 20 --out weights.pth --device cuda
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pathlib
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import tracing
from ..denoise import check_device
from ..programs import TrainProgram
from . import network, rn02
from .losses import l2_regularization, total_loss
from .network import sequence_forward
from .recipe import Recipe, adam_for_device

make_optimizer, make_adamw = network.make_optimizer, rn02.make_adamw  # perf_bench's drivers build them here
TOPOLOGIES = {"rnnoise-2018": network.RECIPE, "rnnoise-0.2": rn02.RECIPE}  # name: recipe at published widths


def recipe_of(topology) -> Recipe:
    """The recipe of a name of :data:`TOPOLOGIES`, or of widths: the recipe
    whose published widths are of their type, at these widths."""
    if not isinstance(topology, str):
        by_type = {type(recipe.meta): recipe for recipe in TOPOLOGIES.values()}
        return dataclasses.replace(by_type[type(topology)], meta=topology)
    if topology not in TOPOLOGIES:
        raise ValueError(f"unknown topology {topology!r}; one of {', '.join(TOPOLOGIES)}")
    return TOPOLOGIES[topology]


def updates_taken(opt: torch.optim.Adam) -> int:
    """Adam's update count (its per-parameter ``step``), 0 before the first.
    A host read of the device: for checkpoints and tests, not for a step."""
    state = opt.state.get(opt.param_groups[0]["params"][0], {})
    return int(state["step"]) if "step" in state else 0


def _apply_schedule(opt: torch.optim.Adam) -> None:
    """Set each group's learning rate in place to ``opt.schedule`` (its
    factory's) of the update count, on the device (no host read, so a
    captured step recomputes it at every replay); a constant rate is left."""
    if opt.schedule is not None:
        for group in opt.param_groups:
            group["lr"].copy_(opt.schedule(group, opt.state[group["params"][0]]["step"]))


def train_step(model: torch.nn.Module, opt: torch.optim.Optimizer, batch: dict,
               sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One step on a batch {features, gains, vad}: the model's loss
    (``batch_loss``: for a :class:`TrainableModel` total_loss +
    l2_regularization, for an :class:`rn02.Rn02Model` the 0.2 loss), its
    gradient, the optimizer's update, then the model's ``post_step`` (the
    2018 weight clip; nothing for 0.2).  Returns the loss as a device
    scalar.  The phases are marked for a capture (``tracing.phase``)."""
    loss = model.batch_loss(batch, sample_weight)
    tracing.phase("loss")
    opt.zero_grad(set_to_none=True)
    loss.backward()
    tracing.phase("backward")
    _apply_schedule(opt)
    opt.step()
    model.post_step()
    tracing.phase("optimizer")
    return loss.detach()


def train_step_indexed(model: torch.nn.Module, opt: torch.optim.Optimizer, data: dict,
                       idx: torch.Tensor, seq_weights: Optional[torch.Tensor]) -> torch.Tensor:
    """One step on rows ``idx`` of a dataset on the device: the batch is
    gathered there, so only the (B,) index vector crosses per step.
    ``data`` holds the full {features, gains, vad} tensors (sequence-major),
    ``seq_weights`` the per-sequence sample weights (None for RNNoise 0.2,
    whose recipe has none)."""
    batch = {k: v.index_select(0, idx) for k, v in data.items()}
    sw = None if seq_weights is None else seq_weights.index_select(0, idx)[:, None].expand(batch["vad"].shape[:2])
    return train_step(model, opt, batch, sw)


def train_step_dp(model: network.TrainableModel, opt: torch.optim.Adam, data: dict, idx: torch.Tensor,
                  seq_weights: torch.Tensor, mesh) -> torch.Tensor:
    """One step of the global batch ``idx`` on this rank of the 1-D
    DeviceMesh ``mesh``: the rank gathers its contiguous slice of ``idx``
    (the same vector on every rank) from its whole copy of ``data``, and
    the step is the single-device step on all of ``idx``, up to rounding.

    The loss is a weighted mean over the global batch, so each rank's part
    is its weighted sum over the global weight total, which every rank
    computes from ``idx`` alone; the l2 term is rank 0's.  One all-reduce
    (SUM) of the flattened gradients and the loss gives each rank the
    global gradient, then every rank takes the same Adam update and
    ``post_step`` (the clip).  Averaging the ranks' own weighted means, as
    stock DDP would, is not that gradient when their weight sums differ.
    Returns the global loss.  The 2018 network's step: RNNoise 0.2's
    recipe refuses a mesh.
    """
    n, rank = mesh.size(), mesh.get_local_rank()
    b = idx.shape[0]
    mine = idx[rank * b // n : (rank + 1) * b // n]
    t = data["vad"].shape[1]
    weight_total = seq_weights.index_select(0, idx)[:, None].expand(b, t).sum()
    batch = {k: v.index_select(0, mine) for k, v in data.items()}
    sw = seq_weights.index_select(0, mine)[:, None].expand(batch["vad"].shape[:2])
    gains_pred, vad_pred = sequence_forward(model, batch["features"])
    loss = total_loss(batch["gains"], gains_pred, batch["vad"], vad_pred, sw, weight_total)
    if rank == 0:
        loss = loss + l2_regularization(model)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    params = list(model.parameters())
    flat = torch.cat([p.grad.reshape(-1) for p in params] + [loss.detach().reshape(1)])
    dist.all_reduce(flat, group=mesh.get_group())
    for p, g in zip(params, flat[:-1].split([p.numel() for p in params])):
        p.grad.copy_(g.view_as(p))
    _apply_schedule(opt)
    opt.step()
    model.post_step()
    return flat[-1]


def save_checkpoint(path, model: torch.nn.Module, opt: torch.optim.Adam, step: int) -> pathlib.Path:
    """Write the full training state (weights, Adam's state and settings,
    the step) with ``torch.save`` to its own ``step_<n:08d>`` file under the
    directory ``path`` (mid-training resume: the reference only saves final
    weights, rnn_train.py:131-135).

    Nothing else in the directory is ever touched or deleted: the state is
    written to a hidden temporary file and renamed over this step's own
    file, so an interrupted save cannot clobber an earlier checkpoint.
    These checkpoints are this package's own format; it does not read the
    JAX package's orbax checkpoints.
    """
    d = pathlib.Path(path).resolve()
    d.mkdir(parents=True, exist_ok=True)
    final = d / f"step_{step:08d}"
    tmp = d / f".{final.name}.tmp"
    torch.save({"step": step, "model": model.state_dict(), "optimizer": opt.state_dict()}, tmp)
    os.replace(tmp, final)
    return final


def latest_checkpoint(path) -> Optional[pathlib.Path]:
    """The newest ``step_<n>`` checkpoint under ``path``, or None."""
    steps = sorted(pathlib.Path(path).resolve().glob("step_*"))
    return steps[-1] if steps else None


def restore_checkpoint(path, model: torch.nn.Module, opt: torch.optim.Adam) -> int:
    """Load a checkpoint into ``model`` and ``opt``; returns its step.
    ``path`` is one ``step_<n>`` file or a directory of them written by
    :func:`save_checkpoint` (the newest wins).

    A checkpoint resumes only under the optimizer configuration it was
    saved with: a constant learning rate against a cosine schedule, or
    another topology, raises ValueError instead of mis-restoring.  Adam's
    settings, the learning rate and the schedule come from the checkpoint,
    but ``capturable`` from the device (a checkpoint written on a card
    resumes on the CPU, and one written on the CPU can be captured on a
    card).  Restore before building a ``TrainProgram`` over ``opt``: the
    load replaces Adam's state tensors.
    """
    p = pathlib.Path(path).resolve()
    if not p.name.startswith("step_"):
        newest = latest_checkpoint(p)
        if newest is None:
            raise FileNotFoundError(f"no step_* checkpoints under {p}")
        p = newest
    ckpt = torch.load(p, map_location=next(model.parameters()).device, weights_only=True)
    saved = [g.get("cosine_steps") is None for g in ckpt["optimizer"]["param_groups"]]
    want = [g["cosine_steps"] is None for g in opt.param_groups]
    if saved != want:
        raise ValueError(
            f"checkpoint {p} was saved with another learning-rate schedule (constant: {saved}, "
            f"expected {want}); resume with the settings it was written under"
        )
    try:
        model.load_state_dict(ckpt["model"])
        opt.load_state_dict(ckpt["optimizer"])
    except (KeyError, RuntimeError, ValueError) as e:
        raise ValueError(f"checkpoint {p} does not match the current training configuration: {e}") from e
    adam_for_device(opt, opt.schedule)
    return int(ckpt["step"])


def fit(
    features: np.ndarray,
    gains: np.ndarray,
    vad: np.ndarray,
    *,
    epochs: int = 20,
    batch_size: int = 32,
    learning_rate: float = 1e-3,
    seed: int = 0,
    topology="rnnoise-2018",
    lr_decay: float = rn02.LR_DECAY,
    log_every: int = 10,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 500,
    resume_from: Optional[str] = None,
    lr_schedule: Optional[str] = None,
    total_steps: Optional[int] = None,
    history: Optional[list] = None,
    device="cuda",
    mesh=None,
) -> dict:
    """Train on ``device`` and return float params as numpy arrays in the
    JAX package's layout.

    ``topology``: a name of :data:`TOPOLOGIES` at its published widths, or
    the widths themselves, whose type names the topology (:func:`recipe_of`):
    a ``ModelMeta`` is the 2018 network of :mod:`.network`, an
    :class:`rn02.Rn02Meta` RNNoise 0.2's (:mod:`.rn02`: rows of 65
    features, 32 gains and 1 VAD; its recipe: :func:`rn02.make_adamw` with
    ``lr_decay``, no sample weights, no clip; returned as its state dict's
    numpy arrays; one device, no ``lr_schedule``).  The recipe builds the
    model, the optimizer and the sample weights and returns the params.

    ``lr_schedule``: None (constant) or "cosine" (cosine decay to 0 over
    ``total_steps``, by default the whole run).  ``history`` (if given)
    collects (step, loss) pairs, read back from the device once at the end.
    A run resumed from a checkpoint takes its epochs again from the saved
    step.

    Each step is one call of a :class:`programs.TrainProgram`, built once a
    call, of :func:`train_step_indexed` or, over a mesh,
    :func:`train_step_dp`: on a card a CUDA graph captured at the first
    step and replayed (a capture or replay that fails raises), on the CPU
    the eager step.  Each epoch's permutation is uploaded once; a step
    copies its slice into the program's index vector.

    ``mesh``: a 1-D ``torch.distributed`` DeviceMesh with the dim name
    "dp" for data parallelism, one process a rank (gloo on the CPU, NCCL
    on cards, each rank on its own ``device``, e.g. ``cuda:<local_rank>``
    under torchrun).  Every rank runs this call with the same arguments:
    the dataset, the weights and the permutation are whole on each, rank r
    takes the r-th contiguous slice of each step's ``batch_size`` indices
    (divisible by the mesh size), and :func:`train_step_dp` makes the step
    the global batch's.  ``history`` and the log lines hold the global
    loss, and only rank 0 logs and writes checkpoints, between steps;
    every rank resumes from them.  On cards each rank captures its step,
    its all-reduce inside, at its first step, so every rank must take that
    step: the warm-up step before the capture is the group's first
    collective if nothing ran one before, and creates NCCL's communicator.
    """
    device = check_device(device)
    recipe = recipe_of(topology)
    recipe.check(mesh, lr_schedule)
    rank = 0
    if mesh is not None:
        if mesh.ndim != 1 or mesh.mesh_dim_names != ("dp",):
            raise ValueError(f"mesh must be 1-D with the dim name 'dp', got {mesh.mesh_dim_names}")
        if mesh.device_type != device.type:
            raise ValueError(f"mesh is of {mesh.device_type} devices, device is {device}")
        if batch_size % mesh.size() != 0:
            raise ValueError(f"batch_size {batch_size} must be divisible by the mesh size {mesh.size()}")
        rank = mesh.get_local_rank()
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    if lr_schedule == "cosine":
        cosine_steps = total_steps or epochs * max(len(features) // batch_size, 1)
    elif lr_schedule is None:
        cosine_steps = None
    else:
        raise ValueError(f"unknown lr_schedule {lr_schedule!r}")
    model = recipe.init(torch.Generator().manual_seed(seed), recipe.meta).to(device)
    opt = recipe.optimizer(model, learning_rate, cosine_steps, lr_decay)
    step = 0
    if resume_from:
        step = restore_checkpoint(resume_from, model, opt)
        if rank == 0:
            print(f"resumed from {resume_from} at step {step}")
    seq_w = recipe.sample_weights(gains, device)
    n = len(features)
    rng = np.random.RandomState(seed)
    data = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in (("features", features), ("gains", gains), ("vad", vad))}
    if mesh is None:
        step_fn = lambda idx: train_step_indexed(model, opt, data, idx, seq_w)
    else:
        step_fn = lambda idx: train_step_dp(model, opt, data, idx, seq_w, mesh)
    program = TrainProgram(step_fn, model, opt, batch_size)

    pending: list = []
    done = 0
    for epoch in range(epochs):
        perm = torch.as_tensor(rng.permutation(n), device=device)
        for i in range(0, n - batch_size + 1, batch_size):
            loss = program(perm[i : i + batch_size])
            if done % log_every == 0 and rank == 0:
                print(f"epoch {epoch} step {done} loss {float(loss):.5f}")
            if history is not None:
                pending.append((done, loss.clone()))  # the program's loss is overwritten by the next step
            done += 1
            step += 1
            if checkpoint_dir and done % checkpoint_every == 0 and rank == 0:
                save_checkpoint(checkpoint_dir, model, opt, step)
    if history is not None and pending:
        losses = torch.stack([l for _, l in pending]).cpu().numpy()
        history.extend((s, float(l)) for (s, _), l in zip(pending, losses))
    if checkpoint_dir and rank == 0:
        save_checkpoint(checkpoint_dir, model, opt, step)
    if mesh is not None and checkpoint_dir:
        # no rank returns before the last checkpoint exists
        dist.barrier(group=mesh.get_group(), device_ids=[device.index] if device.type == "cuda" else None)
    return recipe.numpy_params(model)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train a denoise model")
    ap.add_argument("--topology", default="rnnoise-2018", choices=tuple(TOPOLOGIES),
                    help="the 2018 network (default) or RNNoise 0.2's, by its own recipe")
    ap.add_argument("--data", required=True,
                    help="training.h5 (87-col schema); for rnnoise-0.2 a raw float32 file of 98-float frames")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=None, help="default 32; 128 for rnnoise-0.2")
    ap.add_argument("--window", type=int, default=2000)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--lr-decay", type=float, default=rn02.LR_DECAY,
                    help="rnnoise-0.2: the learning rate is lr / (1 + decay * step)")
    ap.add_argument("--out", default=None,
                    help="weights.rnn (int8 export; default), or for rnnoise-0.2 weights.pth (torch state dict)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None, help="checkpoint directory (torch.save)")
    ap.add_argument("--checkpoint-every", type=int, default=500)
    ap.add_argument("--resume", default=None, help="checkpoint dir to resume from")
    ap.add_argument(
        "--lr-schedule", default=None, choices=["cosine"],
        help="cosine-decay the lr to 0 over the run (default: constant)",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    check_device(args.device)
    recipe = TOPOLOGIES[args.topology]
    features, gains, vad = recipe.load(args.data, args.window)
    print(f"{len(features)} sequences of {args.window} frames")
    params = fit(
        features,
        gains,
        vad,
        epochs=args.epochs,
        batch_size=args.batch_size or recipe.batch_size,
        learning_rate=args.lr,
        seed=args.seed,
        topology=args.topology,
        lr_decay=args.lr_decay,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        resume_from=args.resume,
        lr_schedule=args.lr_schedule,
        device=args.device,
    )
    out = args.out or recipe.out
    recipe.write(params, out)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
