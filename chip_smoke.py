"""Drive nnnoiseless_tpu_torch's main path on one CUDA card, in phases.

    python3 chip_smoke.py

1. environment: the card (nvidia-smi), torch/CUDA versions, TF32 flags;
2. build: compile csrc/*.cu with nvcc (sm_90a) and print the build time;
3. K1 (pitch kernel) against its plain version, B=256, T=20;
4. K2 (frame kernel) against its plain version, B=130 (a ragged tile), T=20;
5. golden: tests/data/testing.raw broadcast to B=128 through process_frames,
   against tests/data/reference_output.raw;
6. real size: StreamBatch(4096) on 100-frame chunks, one warm-up and three
   timed chunks, and each kernel's time beside its plain version's.

Any failure exits non-zero before the last line.  The last two lines are a
JSON object with each kernel's launches, error and times, and
{"ok": true, "device": {...}}.  Needs a CUDA card: without one it exits 1.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"
FRAME = 480
DEVICE = "cuda:0"
K1_SHAPE = (256, 20)  # (B, T) of phase 3; phase 4 takes K2_BATCH of its streams
K2_BATCH = 130
GOLDEN_BATCH = 128
REAL_SHAPE = (4096, 100)
TIMED_CHUNKS = 3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 1) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` runs (after one
    warm-up), timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def test_frames(batch: int, t_count: int, seed: int) -> np.ndarray:
    """(batch, t_count, 480) f32 frames: even streams are slices of the
    golden clip at seeded offsets and gains, odd streams seeded harmonic
    tones in noise."""
    rng = np.random.RandomState(seed)
    clip = np.fromfile(DATA / "testing.raw", "<i2").astype(np.float32)
    n = t_count * FRAME
    t = np.arange(n) / 48000.0
    out = np.empty((batch, n), np.float32)
    for b in range(batch):
        if b % 2 == 0:
            start = rng.randint(0, len(clip) - min(n, len(clip)) + 1)
            seg = np.resize(clip[start:], n)
            out[b] = seg * rng.uniform(0.25, 2.0)
        else:
            f0 = rng.uniform(80, 400)
            sig = sum(np.sin(2 * np.pi * f0 * h * t + rng.rand() * 6) / h for h in range(1, 6))
            out[b] = sig * rng.uniform(100, 6000) + rng.randn(n) * rng.uniform(10, 800)
    return np.clip(out, -32768, 32767).reshape(batch, t_count, FRAME)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import nnnoiseless_tpu_torch as nt
    from nnnoiseless_tpu_torch import _build
    from nnnoiseless_tpu_torch.chunk import decimate, precompute_chunk
    from nnnoiseless_tpu_torch.ops import frame_kernel as fk
    from nnnoiseless_tpu_torch.ops import pitch_kernel as pk
    from nnnoiseless_tpu_torch.ops.biquad import biquad_filter_frames
    from nnnoiseless_tpu_torch.tables import BIQUAD_HP_A, BIQUAD_HP_B

    dev = torch.device(DEVICE)
    card = card_line()
    kind = torch.cuda.get_device_name(0)

    # ---- 1. environment ------------------------------------------------------
    print(f"[1] card: {card}")
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 must be off")

    # ---- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    print(f"[2] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.last_build_seconds:.1f} s)")
    for line in _build.last_build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("[2]   " + line.strip())

    engine = nt.Engine(nt.RnnModel.default(), dev)

    # ---- 3. K1 against its plain version --------------------------------------
    b3, t3 = K1_SHAPE
    frames = torch.as_tensor(test_frames(b3, t3, seed=3), device=dev)
    carry = nt.init_batch_carry(engine.model.meta, b3, dev)
    filtered, _ = biquad_filter_frames(frames, carry.feat.hp_mem, tuple(BIQUAD_HP_A), tuple(BIQUAD_HP_B))
    full = torch.cat([carry.feat.input_mem, filtered.reshape(b3, -1)], 1)
    ds, w0 = decimate(full, t3)
    cand_k, pidx_k = pk.pitch_analysis_cuda(ds, w0, t3)
    cand_p, pidx_p = pk.pitch_analysis_plain(ds, w0, t3)
    torch.cuda.synchronize()
    t_lanes = [0] + list(range(4, 18))
    differ = (pidx_k != pidx_p) | (cand_k[..., t_lanes] != cand_p[..., t_lanes]).any(-1)
    n_diff = int(differ.sum())
    worst = int((pidx_k - pidx_p).abs().max())
    same = ~differ
    rowscale = cand_p.abs().amax(-1, keepdim=True) + 1.0
    k1_rel = float(((cand_k - cand_p).abs() / rowscale)[same].max())
    k1_err = float((cand_k - cand_p).abs()[same].max())
    print(f"[3] K1 B={b3} T={t3}: {n_diff} of {differ.numel()} windows differ in pidx/t-lanes "
          f"(largest pidx step {worst}); matching windows: max abs {k1_err:.3g}, "
          f"row-scale {k1_rel:.3g}")
    if n_diff > 0.01 * differ.numel() or worst > 2:
        raise RuntimeError("K1 decisions disagree with the plain version")
    if k1_rel >= 5e-3:
        raise RuntimeError("K1 float lanes disagree with the plain version")

    # ---- 4. K2 against its plain version --------------------------------------
    b4 = K2_BATCH
    pre, _ = precompute_chunk(carry.feat.input_mem[:b4], carry.feat.hp_mem[:b4], frames[:b4])
    c4 = fk.carry_arrays(nt.init_batch_carry(engine.model.meta, b4, dev))
    packed_k, carry_k = fk.frame_loop_cuda(engine.rnn, engine.weights, c4, pre.filtered, pre.cand)
    packed_p, carry_p = fk.frame_loop_plain(engine.rnn, c4, pre.filtered, pre.cand)
    torch.cuda.synchronize()
    got = packed_k[..., :FRAME].double()
    want = packed_p[..., :FRAME].double()
    d = (got - want).abs()
    rel = float((d ** 2).sum() / (want ** 2).sum())
    k2_err = float(d.max())
    frac16 = float((d > 16).double().mean())
    per_agree = float((packed_k[..., fk.OFF_PERIOD] == packed_p[..., fk.OFF_PERIOD]).double().mean())
    vad_err = float((packed_k[..., fk.OFF_VAD] - packed_p[..., fk.OFF_VAD]).abs().max())
    print(f"[4] K2 B={b4} T={t3}: rel {rel:.3g}, max {k2_err:.3g}, >16: {frac16:.3%}, "
          f"periods agree {per_agree:.4%}, vad max {vad_err:.3g}")
    for (name, _), a, b in zip(fk.CARRY_SHAPES, carry_k, carry_p):
        print(f"[4]   carry {name}: max abs {float((a.double() - b.double()).abs().max()):.3g}")
    if not (rel < 1e-3 and k2_err <= 64 and frac16 <= 0.05 and per_agree >= 0.98):
        raise RuntimeError("K2 disagrees with the plain version")

    # ---- 5. golden through the engine --------------------------------------------
    clip = np.fromfile(DATA / "testing.raw", "<i2").astype(np.float32)
    ref = np.fromfile(DATA / "reference_output.raw", "<i2").astype(np.float64)
    t5 = len(clip) // FRAME
    g_frames = np.broadcast_to(clip[: t5 * FRAME].reshape(1, t5, FRAME), (GOLDEN_BATCH, t5, FRAME))
    pk.launches = fk.launches = 0
    _, out5, _ = nt.process_frames(engine, nt.init_batch_carry(engine.model.meta, GOLDEN_BATCH, dev),
                                   np.ascontiguousarray(g_frames))
    torch.cuda.synchronize()
    counts5 = (pk.launches, fk.launches)
    out5 = out5.cpu().numpy()
    worst_rel, worst_max = 0.0, 0.0
    for s in range(out5.shape[0]):
        g = np.clip(np.rint(out5[s].reshape(-1)[FRAME:].astype(np.float64)), -32768, 32767)
        w = ref[: len(g)]
        worst_rel = max(worst_rel, float(np.sum((w - g) ** 2) / np.sum(g ** 2)))
        worst_max = max(worst_max, float(np.abs(w - g).max()))
    print(f"[5] golden B={GOLDEN_BATCH} T={t5}: worst stream rel {worst_rel:.3g}, max per-sample "
          f"{worst_max:.0f}; launches K1 {counts5[0]}, K2 {counts5[1]}")
    if not (worst_rel < 1e-4 and worst_max <= 2):
        raise RuntimeError("golden bars failed through the engine")
    if min(counts5) == 0:
        raise RuntimeError("the engine did not launch both kernels")

    # ---- 6. real size ------------------------------------------------------------
    b6, t6 = REAL_SHAPE
    big = torch.as_tensor(test_frames(b6, t6 * (TIMED_CHUNKS + 1), seed=6), device=dev)
    batch = nt.StreamBatch(b6, engine, device=dev)
    pk.launches = fk.launches = 0
    batch.process_tensor(big[:, :t6])  # warm-up chunk
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    outs = [batch.process_tensor(big[:, (c + 1) * t6 : (c + 2) * t6])[0] for c in range(TIMED_CHUNKS)]
    end.record()
    end.synchronize()
    counts6 = (pk.launches, fk.launches)
    chunk_ms = start.elapsed_time(end) / TIMED_CHUNKS
    for o in outs:
        if o.shape != (b6, t6, FRAME) or not bool(torch.isfinite(o).all()):
            raise RuntimeError("real-size output is not finite or has the wrong shape")
    if min(counts6) == 0:
        raise RuntimeError("the real-size run did not launch both kernels")
    fps = b6 * t6 / (chunk_ms / 1e3)
    print(f"[6] StreamBatch B={b6} T={t6}: {chunk_ms:.2f} ms/chunk, {fps:,.0f} frames/s, "
          f"{fps * 0.01:,.0f}x realtime ({card})")

    # kernels at the main path's real shapes, plain / kernel / kernel / plain
    carry6 = nt.init_batch_carry(engine.model.meta, b6, dev)
    filt6, _ = biquad_filter_frames(big[:, :t6], carry6.feat.hp_mem, tuple(BIQUAD_HP_A), tuple(BIQUAD_HP_B))
    ds6, w06 = decimate(torch.cat([carry6.feat.input_mem, filt6.reshape(b6, -1)], 1), t6)
    pre6, _ = precompute_chunk(carry6.feat.input_mem, carry6.feat.hp_mem, big[:, :t6])
    ca6 = fk.carry_arrays(carry6)
    k1_plain = lambda: pk.pitch_analysis_plain(ds6, w06, t6)
    k1_kern = lambda: pk.pitch_analysis_cuda(ds6, w06, t6)
    k2_plain = lambda: fk.frame_loop_plain(engine.rnn, ca6, pre6.filtered, pre6.cand)
    k2_kern = lambda: fk.frame_loop_cuda(engine.rnn, engine.weights, ca6, pre6.filtered, pre6.cand)
    times = {}
    for name, plain, kern in (("k1", k1_plain, k1_kern), ("k2", k2_plain, k2_kern)):
        p1 = cuda_ms(torch, plain)
        k_1 = cuda_ms(torch, kern, 2)
        k_2 = cuda_ms(torch, kern, 2)
        p2 = cuda_ms(torch, plain)
        times[name] = ((k_1 + k_2) / 2, (p1 + p2) / 2)
        print(f"[6] {name} at B={b6} T={t6}: kernel {times[name][0]:.2f} ms, "
              f"plain {times[name][1]:.2f} ms ({card})")

    kernels = [
        {"name": "pitch_analysis_stream", "route": "cuda",
         "source": "nnnoiseless_tpu_torch/csrc/pitch_kernel.cu",
         "replaces": "nnnoiseless_tpu/ops/pitch_kernel.py:696",
         "launches": counts6[0], "max_abs_err": k1_err,
         "ms": times["k1"][0], "plain_ms": times["k1"][1]},
        {"name": "frame_loop_pallas", "route": "cuda",
         "source": "nnnoiseless_tpu_torch/csrc/frame_kernel.cu",
         "replaces": "nnnoiseless_tpu/ops/frame_kernel.py:769",
         "launches": counts6[1], "max_abs_err": k2_err,
         "ms": times["k2"][0], "plain_ms": times["k2"][1]},
    ]
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
