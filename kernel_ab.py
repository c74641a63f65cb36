"""Compare two checkouts' kernels K4 (candidate lanes), K5 (RNN cell) and
K6 (pitch-lag window) on one CUDA card: outputs, device times, registers
and SASS instruction counts.

    python3 kernel_ab.py BASE [CHANGE]

BASE and CHANGE are roots of checkouts of this repository (CHANGE defaults
to this file's directory), for example an earlier commit unpacked with
``git archive`` into a git-ignored directory.  Each runs in a process of
its own, in the order BASE, CHANGE, CHANGE, BASE, so that a drift of the
card shows as a difference between the two runs of one checkout.  A run
builds its checkout's kernels and holds each against its plain version on
seeded inputs: K5 within 2e-5, K6 bit-exact, K4 with its lag lanes exact
and every lane within 1e-5 relative, at R = 409,600, 4097, 100 and 1 rows
of seeded tables, with pitch indices drawn over the search's range
[181, 768) and over [0, 768) with 0-19 among them (off-table lookups).
It times each with chip_smoke.py's timers (calls replayed from a CUDA
graph: ``cold_ms``, every call on its own copy of the inputs, and warm,
every call on the same inputs; K5 and K6 at B = 4096, 1061, 1024, 64 and
1), hashes K4's outputs, reads each kernel function's registers and local
memory (``cuobjdump -res-usage``; local memory holds spills) and counts
the FFMA, LDS, I2F (with I2FP), PRMT, FADD, LDG, STG and STS instructions
in its SASS (``cuobjdump -sass`` of the built library; static counts over
the whole function, not counts of executed instructions).  Prints each
run's JSON line, then a table of each checkout's mean times, whether K4's
outputs are bit-equal across the runs, and the card's name and power
limit.
"""

from __future__ import annotations

import hashlib
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
K4_ROWS = (409600, 4097, 100, 1)
OPS = ("FFMA", "LDS", "I2F", "PRMT", "FADD", "LDG", "STG", "STS")
KERNELS = ("rnn_kernel", "window_kernel", "candidates_kernel")  # the kernel functions counted
RES = ("REG", "STACK", "SHARED", "LOCAL")  # of cuobjdump -res-usage


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


def res_usage(text: str) -> dict:
    """{function: {REG, STACK, SHARED, LOCAL}} over ``cuobjdump -res-usage``
    text, for the functions whose (mangled) name holds one of KERNELS."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function (\S+?):?\s*$", line)
        if m:
            cur = m.group(1) if any(k in m.group(1) for k in KERNELS) else None
            continue
        if cur is not None and "REG:" in line:
            out[cur] = {k: int(v) for k, v in re.findall(r"\b([A-Z]+):(\d+)", line) if k in RES}
            cur = None
    return out


def k4_inputs(torch, dev):
    """Seeded (409,600, 385) tables corr and yy (energies >= 0), xx, and
    the two kinds of pitch index, drawn on the card from one generator."""
    big = max(K4_ROWS)
    g = torch.Generator(device=dev).manual_seed(12)
    draw = lambda *shape: torch.randn(shape, generator=g, device=dev)
    corr, yy, xx = draw(big, 385) * 1e3, (draw(big, 385) * 1e4).abs(), (draw(big) * 1e4).abs()
    search = torch.randint(181, 768, (big,), generator=g, device=dev, dtype=torch.int32)
    drawn = torch.randint(0, 768, (big,), generator=g, device=dev, dtype=torch.int32)
    drawn[:20] = torch.arange(20, dtype=torch.int32, device=dev)
    return corr, yy, xx, {"search": search, "drawn": drawn}


def run_one(root: pathlib.Path) -> dict:
    """Build, check and time the kernels of the checkout at ``root``."""
    sys.path.insert(0, str(root))
    import torch

    import nnnoiseless_tpu_torch as nt
    from nnnoiseless_tpu_torch import _build
    from nnnoiseless_tpu_torch.ops import frame_kernel as fk
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
    del rnn_in, mem, lag
    corr, yy, xx, pidx_kinds = k4_inputs(torch, dev)
    digests = {}
    for r in K4_ROWS:
        for label, pidx in pidx_kinds.items():
            args = (corr[:r], yy[:r], xx[:r], pidx[:r])
            got, want = fk.candidates_cuda(*args), fk.candidates_plain(*args)
            if not (torch.equal(got[:, smoke.T_LANES], want[:, smoke.T_LANES])
                    and bool(((got - want).abs() <= 1e-5 * want.abs()).all())):
                raise RuntimeError(f"K4 disagrees with its plain version at R={r}, pidx {label} in {root}")
            digests[f"R={r} {label}"] = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
            del got, want
            reps = 10 if r == max(K4_ROWS) else 200
            times[f"K4 R={r} {label}"] = (smoke.cold_ms(torch, fk.candidates_cuda, args, reps),
                                          smoke.graph_ms(torch, lambda: fk.candidates_cuda(*args), reps))
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = str(_build.build())
    dump = lambda flag: subprocess.run([cuobjdump, flag, lib], check=True, capture_output=True, text=True).stdout
    return {"root": str(root), "ms_cold_warm": times, "k4_sha256": digests,
            "res": res_usage(dump("-res-usage")), "sass": sass_counts(dump("-sass"))}


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
    same = all(r["k4_sha256"] == runs[0]["k4_sha256"] for r in runs)
    print(f"K4 outputs bit-equal across the four runs, at every R and pidx kind: {same}")
    print(_smoke().card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
