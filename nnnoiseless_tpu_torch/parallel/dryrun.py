"""The multi-device dry run on the CPU, the counterpart of
``__graft_entry__.py::dryrun_multichip`` of the JAX package.

    python -m nnnoiseless_tpu_torch.parallel.dryrun --devices N

1. N CPU processes joined by gloo (spawned by ``torch.multiprocessing``,
   meeting at a ``FileStore`` in a temporary directory: no network) take one
   data-parallel training step at b=2N, t=16 through ``fit(mesh=...)``: the
   loss must be finite and the parameters equal on every rank.
2. :func:`~nnnoiseless_tpu_torch.parallel.mesh.sharded_process_frames`
   over N CPU entries at B=2N, T=3 against the unsharded engine: max |delta|
   at most 0.1 i16 units.

It prints one line.  :func:`run_ranks` is the process launcher: any
importable function ``fn(mesh, *args)`` runs on every rank of an N-process
gloo group with a 1-D "dp" DeviceMesh.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import queue as queue_mod
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh

from ..denoise import Engine, init_batch_carry, process_frames
from ..model import RnnModel
from ..training.train import fit
from .mesh import make_mesh, shard_batch, sharded_process_frames

DRYRUN_BAR = 0.1  # i16 units: the JAX dry run's bar (__graft_entry__.py:132)


def _rank_main(rank: int, n: int, store_path: str, fn, args: tuple, results) -> None:
    # the n ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    dist.init_process_group("gloo", store=dist.FileStore(store_path, n), rank=rank, world_size=n)
    try:
        mesh = init_device_mesh("cpu", (n,), mesh_dim_names=("dp",))
        results.put((rank, True, fn(mesh, *args)))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def run_ranks(n: int, fn, *args, timeout: float = 300.0) -> list:
    """``fn(mesh, *args)`` on each rank of ``n`` spawned CPU processes
    joined by gloo; returns the ranks' results in rank order.  ``fn`` must
    be importable by name (a spawned process imports its module).  A rank
    that raises or exits, or a run past ``timeout`` seconds, raises here,
    and every process still running is terminated."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(r, n, store, fn, args, results), daemon=True)
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(got) < n:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0) and r not in got]
                    if dead:
                        raise RuntimeError(f"ranks {dead} exited without a result") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{n - len(got)} of {n} ranks gave no result in {timeout:g} s") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                got[rank] = value
        finally:
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0) if len(got) == n else 0)
                if p.is_alive():
                    p.terminate()
                    p.join(5)
    return [got[r] for r in range(n)]


def _fit_rank(mesh, features, gains, vad, kwargs: dict):
    """``fit`` on this rank on the CPU, its log line silenced: (params,
    history)."""
    history: list = []
    with contextlib.redirect_stdout(io.StringIO()):
        params = fit(features, gains, vad, mesh=mesh, history=history, device="cpu", **kwargs)
    return params, history


def dryrun_multichip(n_devices: int) -> str:
    """Run both checks on ``n_devices`` CPU ranks and entries; returns the
    line it prints.  Raises on a failed check."""
    b, t = 2 * n_devices, 16
    rng = np.random.RandomState(0)
    features = rng.randn(b, t, 42).astype(np.float32)
    gains = rng.rand(b, t, 22).astype(np.float32)
    vad = (rng.rand(b, t, 1) > 0.5).astype(np.float32)
    ranks = run_ranks(n_devices, _fit_rank, features, gains, vad,
                      dict(epochs=1, batch_size=b))
    loss = ranks[0][1][0][1]
    if not np.isfinite(loss):
        raise RuntimeError(f"training loss is not finite: {loss}")
    for r, (params, history) in enumerate(ranks[1:], 1):
        same = all(np.array_equal(a, params[layer][k]) for layer, leaves in ranks[0][0].items()
                   for k, a in leaves.items())
        if not same or history[0][1] != loss:
            raise RuntimeError(f"rank {r}'s parameters or loss differ from rank 0's")

    model = RnnModel.default()
    mesh = make_mesh(["cpu"] * n_devices)
    frames = (rng.randn(b, 3, 480) * 3000).astype(np.float32)
    _, out, _ = sharded_process_frames(model, shard_batch(init_batch_carry(model.meta, b, "cpu"), mesh),
                                       frames, mesh)
    _, want, _ = process_frames(Engine(model, "cpu"), init_batch_carry(model.meta, b, "cpu"), frames)
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("inference produced non-finite output")
    d = float((out - want).abs().max())
    if d > DRYRUN_BAR:
        raise RuntimeError(f"the sharded engine deviates from the unsharded one: {d}")
    line = (f"dryrun_multichip OK on {n_devices} devices: loss={loss:.4f}, parameters equal on "
            f"{n_devices} gloo CPU ranks; sharded engine over {n_devices} CPU entries against the "
            f"unsharded (max |delta| {d:.2e})")
    print(line)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Data-parallel training step and sharded engine on CPU ranks")
    ap.add_argument("--devices", type=int, default=8, help="gloo ranks and mesh entries (default 8)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.devices)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
