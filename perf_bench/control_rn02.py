"""The readings that the limits of RNNoise 0.2's training cell are set
from, on many seeds in one process (the benchmark's own runs never run
this).

    python3 perf_bench/control_rn02.py --seeds 11,12,... --control-seeds 11,12 \
        [--workload rn02-train-128x2000]

For each seed: the program's first steps against the plain reference (the
lower readings); on the control seeds, the control (the reference computed
with TF32 products in the program's place) and the fault of half of each
batch left out, planted in the reference put in the program's place (the
upper readings).  One program is built and captured once and refilled in
place for each seed.  One JSON line a seed, then the largest program
reading and the least control and fault readings of each number.
"""

import argparse
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent


def seed_numbers(run, control: bool) -> dict:
    from perf_bench.drivers import train_check

    run.keep_rows()
    want = run.reference()
    out = {"program": train_check.numbers((run.losses, run.grad1, run.p_end), want, run.p0)}
    if control:
        out["control"] = train_check.numbers(run.reference(tf32=True), want, run.p0)
        half = [idx[: len(idx) // 2] for idx in run.local]
        out["half_batch"] = train_check.numbers(run.reference(half), want, run.p0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="rn02-train-128x2000")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    from perf_bench import run as bench
    from perf_bench.drivers.train_rn02 import Cell

    cell = bench.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    rows, run = [], None
    for seed in seeds:
        t0 = time.perf_counter()
        if run is None:
            run = Cell(cell, seed, torch.device(args.device))
            run.setup()
        else:
            run.reseed(seed)
        r = seed_numbers(run, seed in controls)
        r["seed"], r["seconds"] = seed, time.perf_counter() - t0
        rows.append(r)
        print(json.dumps(r), flush=True)
    summary = {}
    for kind, pick in (("program", max), ("control", min), ("half_batch", min)):
        got = [r[kind] for r in rows if kind in r]
        if got:
            summary[kind] = {k: pick(g[k] for g in got) for k in got[0]}
    print(json.dumps({"workload": cell.name, "summary": summary, "limits": cell.limits}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
