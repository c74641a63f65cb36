"""Device-mesh data parallelism for the denoise engine.

The counterpart of ``nnnoiseless_tpu/parallel/mesh.py``.  The workload is
embarrassingly parallel across streams (the reference's only concurrency
axis is one DenoiseState per channel), so:

* a :class:`Mesh` is a 1-D list of devices with the axis name ``"dp"``;
* the stream axis of the frames and of every carry leaf is split over it,
  one contiguous slice an entry, and the model's weights are on every
  device (one :class:`~nnnoiseless_tpu_torch.denoise.Engine` a device,
  its int8 weights packed once);
* there are **no collectives**: streams never couple, so each shard runs
  the one-device engine (:func:`denoise.process_chunk`: the two-phase
  engine, K1 then K2, for the standard model; the scan engine, K1, K5 and
  K6, otherwise) on its own device, and only ``out`` and ``vad`` are
  copied to the mesh's first device.

Where the JAX package needs ``shard_map`` because XLA cannot partition a
Pallas call, per-shard execution is the native form here: one process
issues every shard in turn, with no synchronisation between them.

Data-parallel training over devices is ``training.train.fit(mesh=...)``,
which takes a ``torch.distributed`` DeviceMesh: one process a card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from ..constants import FRAME_SIZE
from ..denoise import Engine, check_device, process_chunk
from ..model import RnnModel
from ..pipeline import DenoiseCarry


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the devices of its entries, in order, and the axis name.

    An entry's device may repeat: torch has one CPU device, and one card
    can hold several shards, so ``[cpu] * 8`` or ``[cuda:0] * 4`` stand for
    8 or 4 devices (the role of XLA's virtual host devices in the JAX
    package's tests)."""

    devices: tuple
    axis_name: str = "dp"

    @property
    def size(self) -> int:
        return len(self.devices)


def _resolve(device) -> torch.device:
    device = check_device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"a mesh entry must be a CPU or CUDA device, got {device}")
    return device


def make_mesh(devices: Optional[Sequence] = None, axis_name: str = "dp") -> Mesh:
    """1-D mesh over ``devices`` (default: every CUDA card present,
    ``cuda:0`` ... ``cuda:{n-1}``).  Without a card the default raises, as
    :func:`denoise.check_device` does; it never falls back to the CPU.  A
    device may appear more than once (see :class:`Mesh`)."""
    if devices is None:
        check_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(_resolve(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devices, axis_name)


def _map(fn, tree, path: str = "carry"):
    """``fn(path, leaf)`` over every tensor of nested NamedTuples."""
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    return type(tree)(*(_map(fn, v, f"{path}.{k}") for k, v in zip(tree._fields, tree)))


def shard_batch(carry: DenoiseCarry, mesh: Mesh) -> tuple:
    """Split every leaf of ``carry`` along its leading (stream) axis, one
    contiguous slice an entry of ``mesh``, each copied to that entry's
    device.  Returns the sharded carry: one DenoiseCarry an entry.

    Every leaf must carry the batch as its leading axis; 0-d leaves cannot
    be sharded and are rejected explicitly.
    """
    n = mesh.size

    def check(path, leaf):
        if leaf.ndim == 0:
            raise ValueError(
                f"leaf {path} is 0-d and cannot carry a sharded batch axis; batch it (shape (B, ...)) first"
            )
        if leaf.shape[0] % n != 0:
            raise ValueError(
                f"stream batch {leaf.shape[0]} of leaf {path} must be divisible by the mesh size {n}; "
                "pad with silent streams or resize"
            )

    _map(check, carry)

    def piece(i, device):
        def take(_, leaf):
            s = leaf.shape[0] // n
            return leaf[i * s : (i + 1) * s].to(device, copy=True)

        return _map(take, carry)

    return tuple(piece(i, d) for i, d in enumerate(mesh.devices))


@functools.lru_cache(maxsize=64)
def _engine_on(model: RnnModel, device: torch.device) -> Engine:
    """One Engine a (model, device): the weights go to each device once."""
    return Engine(model, device)


def _on(device: torch.device):
    """Make ``device`` current for the launches of its shard: the kernels
    set their attributes on, and launch into, the current device."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def sharded_process_frames(model: RnnModel, carry, frames, mesh: Optional[Mesh] = None):
    """Run a batched chunk with the stream axis sharded over the mesh.

    ``frames``: (B, T, 480), a numpy array or a tensor, B divisible by the
    mesh size; each shard's slice goes straight to its entry's device.
    ``carry``: the sharded carry of :func:`shard_batch` (a DenoiseCarry of
    all B streams is sharded first).  Returns (carry', out (B, T, 480),
    vad (B, T)): the carry still sharded, ``out`` and ``vad`` on the mesh's
    first device.
    """
    mesh = mesh if mesh is not None else make_mesh()
    if not isinstance(frames, torch.Tensor):
        frames = np.asarray(frames, np.float32)
    if frames.ndim != 3 or frames.shape[2] != FRAME_SIZE:
        raise ValueError(f"frames must be (B, T, {FRAME_SIZE}), got {tuple(frames.shape)}")
    n, b = mesh.size, frames.shape[0]
    if b % n != 0:
        raise ValueError(
            f"stream batch {b} must be divisible by the mesh size {n}; pad with silent streams or resize the batch"
        )
    if isinstance(carry, DenoiseCarry):
        carry = shard_batch(carry, mesh)
    if len(carry) != n:
        raise ValueError(f"the carry has {len(carry)} shards, the mesh {n} entries")
    s = b // n
    # Every shard's frames are on its device before any shard computes: an
    # upload from pageable host memory waits for the work queued before it.
    parts = [
        torch.as_tensor(frames[i * s : (i + 1) * s], dtype=torch.float32, device=d)
        for i, d in enumerate(mesh.devices)
    ]
    results = []
    for d, c, f in zip(mesh.devices, carry, parts):
        with _on(d):
            results.append(process_chunk(_engine_on(model, d), c, f))
    first = mesh.devices[0]
    out = torch.cat([r[1].to(first) for r in results])
    vad = torch.cat([r[2].to(first) for r in results])
    return tuple(r[0] for r in results), out, vad
