"""The readings that a cell's limits are set from, on many seeds in one
process (the benchmark's own runs never run this).

    python3 perf_bench/control.py --workload <cell> --seeds 11,12,... \
        --control-seeds 11,12,13 [--seconds 2]

For each seed: the program's numbers against the plain reference (the
lower readings), and on the control seeds the numbers of the control, the
reference computed with TF32 products in the program's place (upper
readings).  A training cell also reads the fault of half of each batch
left out, planted in the reference put in the program's place.  A
serving cell runs a short window at its own load; a training cell its
first steps, one program captured once and refilled in place for each
seed.  One JSON line a seed, then the largest program reading and the
least control and fault readings of each number.
"""

import argparse
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent


def tails(per_segment: tuple) -> dict:
    """Each per-segment number's quantiles and its counts above 1e-4,
    1e-3 and 1e-2: what a ``far`` limit is set from."""
    import numpy as np

    out = {}
    for name, v in zip(("out_rel", "vad_err"), per_segment):
        v = np.asarray(v)
        out[name] = {"n": len(v), "q50_q90_q99_max": [float(np.quantile(v, q)) for q in (0.5, 0.9, 0.99, 1.0)],
                     "over_1e-4_1e-3_1e-2": [int((v > t).sum()) for t in (1e-4, 1e-3, 1e-2)]}
    return out


def serve_seed(cell, seed, seconds, control, device) -> dict:
    import importlib

    import torch

    from perf_bench.drivers import serve_check
    from perf_bench.reference.denoise import Reference

    driver = importlib.import_module(f"perf_bench.drivers.{cell.traffic['driver']}")
    run = driver.Cell(cell, seed, device)
    run.setup()
    run.window(seconds)
    run.release()
    ref = Reference(cell.repo / cell.config["model_file"], device)
    pairs, far = run.pairs, cell.limits.get("far", {})
    ref_out, ref_vad = serve_check.run_reference(ref, pairs)
    got = ([p["out"] for p in pairs], [p["vad"] for p in pairs])
    out = {"program": serve_check.numbers(pairs, *got, ref_out, ref_vad, far),
           "tails": tails(serve_check.per_segment(pairs, *got, ref_out, ref_vad))}
    if control:
        c_out, c_vad = serve_check.run_reference(ref, pairs, control=True)
        out["control"] = serve_check.numbers(pairs, c_out, c_vad, ref_out, ref_vad, far)
        out["control_tails"] = tails(serve_check.per_segment(pairs, c_out, c_vad, ref_out, ref_vad))
    del run, ref
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def train_seed(run, seed, control, first) -> dict:
    from perf_bench.drivers import serve_check, train_check
    from perf_bench.reference import train as ref_train

    if not first:
        run.reseed(seed)
    run.keep_rows()
    lr = run.cell.config["learning_rate"]
    want = ref_train.train(run.p0, run.rows, run.rows_w, run.local, lr)
    out = {"program": train_check.numbers((run.losses, run.grad1, run.p_end), want, run.p0)}
    if control:
        with serve_check.tf32(True):
            tf = ref_train.train(run.p0, run.rows, run.rows_w, run.local, lr)
        out["control"] = train_check.numbers(tf, want, run.p0)
        half = [idx[: len(idx) // 2] for idx in run.local]
        out["half_batch"] = train_check.numbers(ref_train.train(run.p0, run.rows, run.rows_w, half, lr), want, run.p0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    from perf_bench import run as bench

    cell = bench.load_cell(args.workload)
    device = torch.device(args.device)
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    train_run = None
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        if cell.traffic["driver"] == "train":
            if train_run is None:
                from perf_bench.drivers.train import Cell

                train_run = Cell(cell, seed, device)
                train_run.setup()
            r = train_seed(train_run, seed, seed in controls, i == 0)
        else:
            r = serve_seed(cell, seed, args.seconds, seed in controls, device)
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
