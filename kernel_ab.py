"""Compare two checkouts' kernels K2 (the frame loop), K4 (candidate
lanes), K5 (RNN cell) and K6 (pitch-lag window) on one CUDA card: outputs,
device times, registers and SASS instruction counts.

    python3 kernel_ab.py [--kernels K2,K4,K5,K6] BASE [CHANGE]

BASE and CHANGE are roots of checkouts of this repository (CHANGE defaults
to this file's directory), for example an earlier commit unpacked with
``git archive`` into a git-ignored directory; ``--kernels`` picks the
kernels to run (all four by default).  Each checkout runs in a process of
its own, in the order BASE, CHANGE, CHANGE, BASE, so that a drift of the
card shows as a difference between the two runs of one checkout.  A run
builds its checkout's kernels and holds each against its plain version on
seeded inputs: K5 within 2e-5, K6 bit-exact, K4 with its lag lanes exact
and every lane within 1e-5 relative, at R = 409,600, 4097, 100 and 1 rows
of seeded tables, with pitch indices drawn over the search's range
[181, 768) and over [0, 768) with 0-19 among them (off-table lookups).
K2 runs two seeded chunks of T = 100 frames (chip_smoke.py's test frames)
at B = 4096, 1024 and 256 from a zeroed carry, the second from the
first's carries, and the two checkouts' K2 must agree bit for bit: a run
hashes its chunk inputs and each chunk's packed output and carries.
It times each with chip_smoke.py's timers (K4-K6: calls replayed from a
CUDA graph, ``cold_ms``, every call on its own copy of the inputs, and
warm, every call on the same inputs; K5 and K6 at B = 4096, 1061, 1024,
64 and 1; K2, which reads ~1.8 GB a call at B = 4096, the mean of
back-to-back calls on the second chunk), hashes K2's and K4's outputs,
reads each kernel function's registers and local memory (``cuobjdump
-res-usage``; local memory holds spills) and counts the FFMA, LDS, I2F
(with I2FP), PRMT, FADD, LDG, STG and STS instructions in its SASS
(``cuobjdump -sass`` of the built library; static counts over the whole
function, not counts of executed instructions).  Prints each run's JSON
line, then a table of each checkout's mean times, whether the hashed
outputs are bit-equal across the runs, K2's production instance's
registers, spills and SASS counts in each checkout, and the card's name
and power limit.
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
K2_BATCHES = (4096, 1024, 256)
K2_FRAMES = 100
K2_REPS = 10
ALL = ("K2", "K4", "K5", "K6")
OPS = ("FFMA", "LDS", "I2F", "PRMT", "FADD", "LDG", "STG", "STS")
KERNELS = ("frame_kernel", "rnn_kernel", "window_kernel", "candidates_kernel")  # the kernel functions counted
K2_PRODUCTION = "frame_kernelILi0E"  # K2's skip-mask-0 instance, in its mangled name
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


def sha256(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def k2_runs(torch, smoke, engine, dev) -> tuple[dict, dict]:
    """K2 at each of K2_BATCHES: ({"K2 B=b": (ms, ms)}, {"B=b ...": sha256})
    over two chunks from a zeroed carry.  The carry's weights are the
    engine's K2 layout: ``rnn_weights`` where K2 takes the tiled layout,
    ``weights`` where the checkout still has K2's own."""
    import nnnoiseless_tpu_torch as nt
    from nnnoiseless_tpu_torch.chunk import precompute_chunk
    from nnnoiseless_tpu_torch.ops import frame_kernel as fk

    weights = engine.weights if hasattr(engine, "weights") else engine.rnn_weights
    frames = torch.as_tensor(smoke.test_frames(max(K2_BATCHES), 2 * K2_FRAMES, 16), device=dev)
    times, digests = {}, {}
    for b in K2_BATCHES:
        carry = nt.init_batch_carry(engine.model.meta, b, dev)
        for i in range(2):
            chunk = frames[:b, i * K2_FRAMES : (i + 1) * K2_FRAMES]
            pre, hp = precompute_chunk(carry.feat.input_mem, carry.feat.hp_mem, chunk)
            ca = fk.carry_arrays(carry)
            packed, out = fk.frame_loop_cuda(engine.rnn, weights, ca, pre.filtered, pre.cand)
            digests[f"B={b} chunk {i} inputs"] = sha256((*ca, pre.filtered, pre.cand))
            digests[f"B={b} chunk {i} packed"] = sha256((packed,))
            digests[f"B={b} chunk {i} carries"] = sha256(out)
            if i == 0:
                del packed
                carry = fk.run_frame_loop(engine.rnn, carry, pre, weights)[0]
                carry = carry._replace(feat=carry.feat._replace(hp_mem=hp))
        del packed, out
        ms = smoke.cuda_ms(torch, lambda: fk.frame_loop_cuda(engine.rnn, weights, ca, pre.filtered, pre.cand),
                           K2_REPS)
        times[f"K2 B={b}"] = (ms, ms)
        del pre, ca
    return times, digests


def run_one(root: pathlib.Path, kernels: tuple = ALL) -> dict:
    """Build, check and time ``kernels`` of the checkout at ``root``."""
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
    times, digests = {}, {}
    if "K2" in kernels:
        times, digests = k2_runs(torch, smoke, engine, dev)
    rng = np.random.RandomState(7)
    big = max(BATCHES)
    rnn_in = [torch.as_tensor((rng.randn(big, n) * sc).astype(np.float32), device=dev)
              for n, sc in ((24, 0.5), (48, 0.5), (96, 0.5), (42, 2.0))]
    rnn_in[1] = rnn_in[1].clamp(min=0)
    mem = torch.as_tensor((rng.randn(big, 1728) * 1000).astype(np.float32), device=dev)
    lag = torch.as_tensor(rng.randint(0, 769, size=big).astype(np.int32), device=dev)
    k5 = lambda hv, hn, hd, f: rk.rnn_step_cuda(weights, hv, hn, hd, f)
    for name, kern, inputs in (("K5", k5, rnn_in), ("K6", wk.window_cuda, (mem, lag))):
        if name not in kernels:
            continue
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
    for r in K4_ROWS if "K4" in kernels else ():
        for label, pidx in pidx_kinds.items():
            args = (corr[:r], yy[:r], xx[:r], pidx[:r])
            got, want = fk.candidates_cuda(*args), fk.candidates_plain(*args)
            if not (torch.equal(got[:, smoke.T_LANES], want[:, smoke.T_LANES])
                    and bool(((got - want).abs() <= 1e-5 * want.abs()).all())):
                raise RuntimeError(f"K4 disagrees with its plain version at R={r}, pidx {label} in {root}")
            digests[f"R={r} {label}"] = sha256((got,))
            del got, want
            reps = 10 if r == max(K4_ROWS) else 200
            times[f"K4 R={r} {label}"] = (smoke.cold_ms(torch, fk.candidates_cuda, args, reps),
                                          smoke.graph_ms(torch, lambda: fk.candidates_cuda(*args), reps))
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = str(_build.build())
    dump = lambda flag: subprocess.run([cuobjdump, flag, lib], check=True, capture_output=True, text=True).stdout
    return {"root": str(root), "ms_cold_warm": times, "sha256": digests,
            "res": res_usage(dump("-res-usage")), "sass": sass_counts(dump("-sass"))}


def k2_summary(run: dict) -> str:
    """K2's production instance: registers, local memory and SASS counts,
    with LDS, LDG, I2F and PRMT per FFMA."""
    res = next((v for k, v in run["res"].items() if K2_PRODUCTION in k), {})
    ops = next((v for k, v in run["sass"].items() if K2_PRODUCTION in k), {})
    per = {op: round(ops[op] / max(ops.get("FFMA", 0), 1), 3) for op in ("LDS", "LDG", "I2F", "PRMT") if op in ops}
    return f"registers {res.get('REG')}, local {res.get('LOCAL')} B; SASS {ops}; per FFMA {per}"


def main(argv: list[str]) -> int:
    kernels = ALL
    if argv[:1] == ["--kernels"]:
        kernels = tuple(argv[1].split(","))
        if set(kernels) - set(ALL):
            print(f"kernels are among {ALL}", file=sys.stderr)
            return 2
        argv = argv[2:]
    if argv[:1] == ["--one"]:
        print(json.dumps(run_one(pathlib.Path(argv[1]).resolve(), kernels)))
        return 0
    if not 1 <= len(argv) <= 2:
        print(__doc__, file=sys.stderr)
        return 2
    base, change = (pathlib.Path(p).resolve() for p in (argv + [str(HERE)])[:2])
    runs = []
    for root in (base, change, change, base):
        res = subprocess.run([sys.executable, __file__, "--kernels", ",".join(kernels), "--one", str(root)],
                             capture_output=True, text=True)
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
    same = all(r["sha256"] == runs[0]["sha256"] for r in runs)
    print(f"outputs bit-equal across the four runs ({', '.join(k for k in kernels if k in ('K2', 'K4'))}"
          f" at every shape; K2's chunk inputs, packed outputs and carries): {same}")
    if not same:
        for key in runs[0]["sha256"]:
            if len({r["sha256"].get(key) for r in runs}) > 1:
                print(f"  differs: {key}")
    if "K2" in kernels:
        for label, run in (("base", runs[0]), ("change", runs[1])):
            print(f"K2 {label}: {k2_summary(run)}")
    print(_smoke().card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
