"""Compare two checkouts' kernels K5 (RNN cell) and K6 (pitch-lag window)
on one CUDA card: device times and SASS instruction counts.

    python3 kernel_ab.py BASE [CHANGE]

BASE and CHANGE are roots of checkouts of this repository (CHANGE defaults
to this file's directory), for example an earlier commit unpacked with
``git archive`` into a git-ignored directory.  Each runs in a process of
its own, in the order BASE, CHANGE, CHANGE, BASE, so that a drift of the
card shows as a difference between the two runs of one checkout.  A run
builds its checkout's kernels, holds each against its plain version on
seeded inputs (K5 within 2e-5, K6 bit-exact), times it at B = 4096, 1061,
1024, 64 and 1 with chip_smoke.py's timers (calls replayed from a CUDA
graph: ``cold_ms``, every call on its own copy of the inputs, and warm,
every call on the same inputs), and counts the FFMA, LDS, I2F (with
I2FP), PRMT and FADD instructions in the SASS of each kernel function
(``cuobjdump -sass`` of the built library; static counts over the whole
function, not counts of executed instructions).  Prints each run's JSON
line, then a table of each checkout's mean times and the card's name and
power limit.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
BATCHES = (4096, 1061, 1024, 64, 1)
OPS = ("FFMA", "LDS", "I2F", "PRMT", "FADD")
KERNELS = ("rnn_kernel", "window_kernel")  # the kernel functions counted in the SASS


def _smoke():
    """chip_smoke.py beside this file, for its timers and card line."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sass_counts(sass: str) -> dict:
    """{function: {op: count}} over ``cuobjdump -sass`` text, for the
    functions whose (mangled) name holds one of KERNELS."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), dict.fromkeys(OPS, 0)) if any(
                k in m.group(1) for k in KERNELS) else None
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and cur is not None:
            op = "I2F" if m.group(1).startswith("I2F") else m.group(1)
            if op in cur:
                cur[op] += 1
    return out


def run_one(root: pathlib.Path) -> dict:
    """Build, check and time the kernels of the checkout at ``root``."""
    sys.path.insert(0, str(root))
    import torch

    import nnnoiseless_tpu_torch as nt
    from nnnoiseless_tpu_torch import _build
    from nnnoiseless_tpu_torch.ops import rnn_kernel as rk
    from nnnoiseless_tpu_torch.ops import window as wk
    from nnnoiseless_tpu_torch.ops.rnn import RnnState

    if pathlib.Path(nt.__file__).resolve().parent.parent != root:
        raise RuntimeError(f"imported {nt.__file__}, not the package under {root}")
    smoke = _smoke()
    dev = torch.device("cuda")
    engine = nt.Engine(nt.RnnModel.default(), dev)
    weights = getattr(engine, "rnn_weights", None) or engine.weights  # K5's layout, where it has its own
    rng = np.random.RandomState(7)
    big = max(BATCHES)
    rnn_in = [torch.as_tensor((rng.randn(big, n) * sc).astype(np.float32), device=dev)
              for n, sc in ((24, 0.5), (48, 0.5), (96, 0.5), (42, 2.0))]
    rnn_in[1] = rnn_in[1].clamp(min=0)
    mem = torch.as_tensor((rng.randn(big, 1728) * 1000).astype(np.float32), device=dev)
    lag = torch.as_tensor(rng.randint(0, 769, size=big).astype(np.int32), device=dev)
    k5 = lambda hv, hn, hd, f: rk.rnn_step_cuda(weights, hv, hn, hd, f)
    times = {}
    for name, kern, inputs in (("K5", k5, rnn_in), ("K6", wk.window_cuda, (mem, lag))):
        for b in BATCHES:
            args = tuple(a[:b] for a in inputs)
            got = kern(*args)
            if name == "K5":
                st, gains, vad = engine.rnn(RnnState(*args[:3]), args[3])
                ok = all(float((a - w).abs().max()) <= 2e-5 for a, w in zip(got, (*st, gains, vad)))
            else:
                ok = torch.equal(got, wk.barrel_shift_window(*args))
            if not ok:
                raise RuntimeError(f"{name} disagrees with its plain version at B={b} in {root}")
            reps = 20 if b == big else 200
            times[f"{name} B={b}"] = (smoke.cold_ms(torch, kern, args, reps),
                                      smoke.graph_ms(torch, lambda: kern(*args), reps))
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(_build.build())], check=True, capture_output=True,
                          text=True).stdout
    return {"root": str(root), "ms_cold_warm": times, "sass": sass_counts(sass)}


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(run_one(pathlib.Path(argv[1]).resolve())))
        return 0
    if not 1 <= len(argv) <= 2:
        print(__doc__, file=sys.stderr)
        return 2
    base, change = (pathlib.Path(p).resolve() for p in (argv + [str(HERE)])[:2])
    runs = []
    for root in (base, change, change, base):
        res = subprocess.run([sys.executable, __file__, "--one", str(root)], capture_output=True, text=True)
        if res.returncode:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]))
    print("kernel, B: ms on the device (cold, warm), mean of each checkout's two runs")
    for key in runs[0]["ms_cold_warm"]:
        mean = lambda rs: [sum(r["ms_cold_warm"][key][i] for r in rs) / 2 for i in (0, 1)]
        b_ms, c_ms = mean([runs[0], runs[3]]), mean(runs[1:3])
        print(f"{key}: base {b_ms[0]:.5f}, {b_ms[1]:.5f}; change {c_ms[0]:.5f}, {c_ms[1]:.5f}")
    print(_smoke().card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
