"""The benchmark of ``nnnoiseless_tpu_torch``: one run of one cell.

    python3 perf_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of ``workloads`` in ``BENCHMARK.json``: a configuration
(``perf_bench/configs/<config>.json``) under a traffic mix
(``perf_bench/workloads/<traffic>.json``, whose ``driver`` names the kind of
work: ``stream``, ``frame`` or ``train``, in ``perf_bench/drivers/``).  The
run builds the cell's inputs from the seed, sets up and warms up the
program (``setup_s``, from the process's start), measures for ``--seconds``,
and with ``--trace 1`` traces a stretch more and reads the per-layer
metrics (``perf_bench/metrics/<metric>.py``, one reader a metric).  Then it
frees the program's state and compares what the window produced with the
plain reference (``perf_bench/reference/``) by the cell's limits
(``perf_bench/limits/<cell>.json``).  The last line of standard output is
one JSON object; the numbers compared are also the last lines of standard
error.  Without a CUDA card, with fewer cards than the cell asks for, or
with a module of JAX or of the JAX package loaded, it exits with 1 and
prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "nnnoiseless_tpu")


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, repo=REPO) -> SimpleNamespace:
    """The cell ``name`` of ``<repo>/BENCHMARK.json`` with its
    configuration, traffic mix, limits and the metrics it reports."""
    repo = pathlib.Path(repo)
    bench = load_json(repo / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {repo / 'BENCHMARK.json'}")
    cell = cells[name]
    base = repo / "perf_bench"
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    missing = [m["name"] for m in bench["per_layer"] if "workloads" not in m]
    if missing:
        raise KeyError(f"per-layer metrics without a 'workloads' list: {', '.join(missing)}")
    layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return SimpleNamespace(
        name=name,
        chips=cell["chips"],
        config=load_json(base / "configs" / f"{cell['config']}.json"),
        traffic=load_json(base / "workloads" / f"{cell['traffic']}.json"),
        limits=load_json(base / "limits" / f"{name}.json"),
        end_to_end=e2e,
        per_layer=layer,
        repo=repo,
    )


def load_reader(name: str, repo=REPO):
    """The ``read(ctx)`` of ``perf_bench/metrics/<name>.py``."""
    path = pathlib.Path(repo) / "perf_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perf_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_state() -> dict:
    """The card's power limit, SM clock and temperature as ``nvidia-smi``
    reads them (taken as the window closes)."""
    keys = ("power_limit", "sm_clock", "temperature")
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit,clocks.sm,temperature.gpu",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=30, check=True)
        return dict(zip(keys, (v.strip() for v in out.stdout.strip().splitlines()[0].split(","))))
    except (OSError, subprocess.SubprocessError, IndexError):
        return dict.fromkeys(keys, "unknown")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def execute(cell: SimpleNamespace, seed: int, seconds: float, trace: bool, device) -> dict:
    """Set up, measure, trace and check one run of ``cell`` on ``device``;
    returns the result object (without the device fields)."""
    import torch

    driver = importlib.import_module(f"perf_bench.drivers.{cell.traffic['driver']}")
    run = driver.Cell(cell, seed, torch.device(device))
    run.setup()
    setup_s = time.perf_counter() - T_START
    stats = run.window(seconds)
    stats["setup_s"] = setup_s
    card = card_state() if torch.device(device).type == "cuda" else {}
    result = {"correct": False, "attempted": stats["attempted"], "failed": stats["failed"]}
    peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
    if trace:
        tr = run.traced()
        ctx = {"trace": tr, "window": stats, "cell": cell, "program": run.program_stats()}
        metrics = {}
        for m in cell.per_layer:
            value = load_reader(m["name"], cell.repo)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        result["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": tr.gaps[:10]}
        result["trace"] = {"busy_s": tr.busy_s, "window_s": tr.window_s}
    else:
        metrics = {m["name"]: {"value": float(stats[m["name"]]), "unit": m["unit"]} for m in cell.end_to_end}
    result["metrics"] = metrics
    result["memory_peak_bytes"] = peak
    result["card"] = card
    run.release()
    t0 = time.perf_counter()
    numbers = run.check()
    result["check_s"] = time.perf_counter() - t0
    result["correct"] = all(v <= lim for _, v, lim in numbers)
    result["compared"] = {n: {"value": v, "limit": lim} for n, v, lim in numbers}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"error: the cell {cell.name} needs {cell.chips} CUDA card(s); {have} available", file=sys.stderr)
        return 1
    out = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda:0")
    found = forbidden_modules()
    if found:
        print(f"error: modules of JAX or the JAX package were loaded: {', '.join(found)}", file=sys.stderr)
        return 1
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": out.pop("memory_peak_bytes"), **out.pop("card")}
    tr = out.pop("trace", None)
    if tr is not None:
        device.update(tr)
    compared = out.pop("compared")
    out["device"] = device
    out["compared"] = compared
    for name, c in compared.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
