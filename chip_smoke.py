"""Drive nnnoiseless_tpu_torch's main path on one CUDA card, in phases.

    python3 chip_smoke.py

1. environment: the card (nvidia-smi), torch/CUDA versions, TF32 flags;
2. build: compile csrc/*.cu with nvcc (sm_90a) and print the build time;
3. K1 (pitch kernel) against its plain version, B=256, T=20;
4. K2 (frame kernel) against its plain version, B=130 (a ragged tile), T=20;
5. golden: tests/data/testing.raw broadcast to B=128 through process_frames,
   against tests/data/reference_output.raw;
6. real size: StreamBatch(4096) on 100-frame chunks, one warm-up and three
   timed chunks, and each kernel's time beside its plain version's; K1
   against its plain version on all 409,600 windows of that input, under
   phase 3's bars but for a pidx step over 2 on at most 0.01% of the
   windows, each a near-tie of the search (a float64 margin under 1e-4,
   printed): at this size f32 rounding meets such ties; one eager
   two-phase chunk (denoise.process_chunk) at B=4096 and at B=64, T=100:
   its wall time to the sync (mean and least of 20) and, by
   torch.profiler, its host launches, device operations and the device's
   busy share of that wall time;
7. K3 (stacked pitch), K5 (RNN cell) and K6 (pitch-lag window) against
   their plain versions at B=4096 and B=1 (K5 and K6 also at B=1061, a
   ragged last block of K5's 32-stream tile, 1024 and 64): each kernel's
   device time (calls replayed from a CUDA graph) cold (each call on its
   own copy of the inputs, cold_ms: the kernels line's time) and warm
   (every call on the same inputs), its time a call (launched from
   Python, host cost included), the earlier designs' times beside them,
   and the plain version's;
8. the per-frame path: the golden clip through DenoiseState.process_frame,
   one replay a call of the state's captured graph of frame_step (K3, K5
   and K6 once each a replay, K1 and K2 never; the warm-up step before the
   capture launches them once more), under the golden bars and bit-equal
   to a loop of the eager frame_step on the card; the graph's pool; the
   latency a call (median, p99, max, the share over the 10 ms frame)
   beside the eager loop's, one replay's device time, and a call's host
   launches, device operations and device busy time by torch.profiler,
   graphed and eager;
9. the scan engine at full width: StreamBatch(4096) with fused=False, one
   warm-up chunk (it captures the step graph) and one timed chunk, bit-equal
   to the eager frame loop (a loop of pipeline.frame_step_hoisted) from the
   same carry, K1 once and K5, K6 once a frame; both chunks' times, and a
   frame's host launches (CUDA runtime calls that put work on the card: at
   most 12 a frame for the graphed one), device operations and device
   busy time by torch.profiler; the lag-0 precompute's device time and one
   replay's; against the
   two-phase engine's chunk from
   the same carry with K2's plain version in phase 2 (the scan engine's
   dense transforms), under phase 4's bars; and K2 against that plain
   version at the main path's shape, B=4096, T=100: phase 4's bars, the
   64-unit one per stream on all but 0.1% of the streams (a near-tie of
   the comb filter's e > g test, where the FFT and the dense product round
   differently, flips a frame by tens of units), each such stream printed
   with the comb test's smallest margin near its worst sample;
10. a model of non-standard topology on the card: the scan engine serves
   it (K2 does not launch), against the same model on the CPU;
11. K4 (candidate lanes) against its plain version on the plain pitch
   chain's tables of the phase-6 input (R = 409,600 rows) and on 100 of
   them, with the search's pitch index and with a seeded one over [0, 768):
   t-lanes exact, every lane within 1e-5 relative; its device time cold,
   warm and a call, as phase 7 times, beside the earlier design's; at full
   size its sector floor (the distinct 32-byte sectors its reads touch,
   k4_sectors, plus xx, pidx and the lanes written, over 3.35 TB/s) and
   the gather alone (not the whole function): torch.gather of the same 88
   positions a row, timed cold;
12. the tools path: tools.attrib.main() at full size (golden, K3 against
   the old chain with K4, totals, the precompute's prefix attribution, K2's
   stage bisection through its skip knob);
13. the pitch trace of the golden clip on the card against the native C++
   engine (the lag-exact bar);
14. the CLI (torch engine on the card, and the native engine) and
   DenoiseSignal on the golden clip, and the sine benchmark at B=1 and
   B=4096;
15. K2's FFT alone (the probe entries nnt_rfft960 / nnt_irfft960) at the
   phase-6 shapes, R = 819,200 forward windows (each stream-frame's lag-0
   and pitch-lag windows) and 409,600 inverse rows, and the dense plain
   versions, each against torch.fft in float64 on the card; times beside
   the dense plain versions and torch.fft.rfft / irfft;
16. K1 by stage through its skip knob at B=4096, T=100: skip=() bit-equal
   to the production launch, then each stub against the plain version's
   stub on phase 3's input and bars, and its cost, production time minus
   the stub's (best of 3);
17. the training path (nnnoiseless_tpu_torch.training): a synthetic corpus
   (examples/train_synthetic.py, seed 0: 8 voices and 6 white, pink and
   band noises of 10 s); one generator chunk at w = 96 worlds, T = 625
   frames (K1 at B = 288, K6 at B = 96) through its programs.FeatureProgram
   (one replay a frame, K6 inside: K1 once, K6 once a replay plus the
   warm-up's, the graph's pool, warm-up and capture seconds), bit-equal to
   the eager frame loop on the card (features, ex, silence, every state
   field), ms a chunk of both, a frame's host launches (at most 12) and
   device operations by torch.profiler; the chunk through the plain
   versions (K1 under phase 6's bars on the combined streams, whose lanes
   the generator reads; ex within 1e-6 relative, silence equal, features
   within 1e-4 on all but 2 of the 96 combined streams, each printed where
   it parts with K1's pitch index flips and their float64 margins);
   generate at workers=96, chunk=625 for 120,000 rows after a warm-up
   (rows/s, device_s, host_s); the float network and its loss gradient at
   B=4, T=200 on the card against the CPU; fit at batch 32 x 2000 (60
   sequences of the rows) for 5 steps, its programs.TrainProgram kept:
   one warm-up and one replay a step, ms a step with its capture, the
   losses, the weight clip, the warm-up and capture seconds, the pool;
   that program put back to fit's first state, 3 replays bit-equal to 3
   eager steps (capturable Adam) from the same params, ms a step over 5
   replays beside the eager steps', one replay's host launches, device
   operations and kernels by torch.profiler; the same 3 steps at B=4,
   T=200, the card's graph against the CPU, within
   tests/test_torch_training.py's bars (losses 1e-5 relative, parameters
   rtol 1e-4 and atol 1e-5; the worst leaf's elements printed on a miss);
   the int8 export through denoise_audio (K1, K2) on a 2 s mix against
   the CPU under the golden bars;
18. the multi-device split (nnnoiseless_tpu_torch.parallel) at phase 6's
   size, B=4096, T=100, on phase 6's input: sharded_process_frames over
   make_mesh() (every card present) and over 2 and 4 entries on cuda:0,
   each against StreamBatch.process_tensor from the same zero carry for
   two chunks (the first from host memory, the second from the returned
   sharded carry) under tests/test_parallel.py's bars (out 1.0 i16 unit,
   vad 1e-3; bit-equality printed), K1 and K2 once a shard a chunk, every
   carry slice on its entry's device, and the time a chunk of each mesh
   beside the unsharded chunk's, timed before and after them (CUDA
   events, the mean of 3 after a warm-up); then fit on phase 17's rows at
   batch 32 x 2000 for 5 steps over a 1-rank NCCL DeviceMesh (a
   FileStore, no network; fit is the group's first user) against phase
   17's fit with mesh=None: one TrainProgram of train_step_dp, one warm-up
   step and one graph replay a step, the all-reduce inside the graph
   (warm-up and capture seconds, pool), parameters within 1e-6 of each
   leaf's scale (bit-equality and equal losses printed), fit's wall a step
   (capture included); then that program, its state put back to fit's
   first, replayed 3 times against 3 eager train_step_dp steps from the
   same state (bit-equal), ms a step over 5 replays beside the eager
   data-parallel steps' and phase 17's one-device program's, one replay's
   host launches (at most 3), device operations and NCCL kernels (at
   least 1) by torch.profiler;
19. kernel K7, the trainer's GRU recurrence over whole sequences
   (ops/gru_seq.py), for each of the 2018 network's three GRUs at
   train-32x2000's B = 32, T = 2000 from the trainer's init: one forward
   and one backward launch against the plain loops on the card (states
   and gates within 2e-5, dXW within 1e-4 of its largest magnitude), then
   each launch timed cold (3 calls, each on its own copy of the inputs)
   beside the plain loop's time, the roofline bound and the bound that
   holds, latency: T frames of two dependent mat-vecs, wr read once;
   each direction's launches counted from just before its own call (1
   each).  Phase 17 also reads the captured train step's K7 launches by
   direction (3 forward, 3 backward), which K7's rows carry;
20. kernel K8, RNNoise 0.2's reset-after GRU recurrence over whole
   sequences (ops/gru_reset_after.py), for each of its three GRUs at
   rn02-train-128x2000's B = 128, T = 1,996, n = 384 from the recipe's
   init: one forward and one backward launch against the plain loops on
   the host's CPU (states and gates within 2e-5; dXW, dHW, W_hh's and
   b_hh's gradients within 1e-4 of their largest magnitude), then each
   launch timed cold (3 calls, each on its own copy of the inputs) beside
   the bound (the recurrent products at the FP32 peak, 3.37 ms), the
   plain path's time on the card (rn02's per-frame gru_step loop and
   autograd's backward of it, as the trainer ran before K8) and
   torch.nn.GRU's (cuDNN, TF32 off, the whole layer with its input
   product, forward and backward); the clusters the card seats at once
   (cudaOccupancyMaxActiveClusters) and the sequences a cluster chosen;
   each direction's launches counted from just before its own call (1
   each); and the launches by direction (3 forward, 3 backward) of the
   rn02 train step captured at the cell's widths, B = 128 and 2,000-frame
   sequences, which K8's rows carry.  Alone: python -c "import
   torch, chip_smoke; chip_smoke.rn02_gru_phase(torch,
   torch.device('cuda:0'), chip_smoke.card_line())".

Any failure exits non-zero before the last line.  The last two lines are a
JSON object with each kernel's launches, error, times and bound, and
{"ok": true, "device": {...}}.  Needs a CUDA card: without one it exits 1.

Bounds: the least time the card could take for a kernel's work on this
run's shapes, the larger of its bytes (each input read once, each output
written once) over 3.35 TB/s and its operations over the FP32 peak of
67 TFLOP/s (H100 SXM, NVIDIA's data sheet, at a 700 W limit).  The peaks,
the FFT's flops and the bound are perf_bench/counts.py's; the counts are in
kernel_bounds().  A kernel timed below its bound fails the run:
its data came from the L2, not from memory.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from perf_bench.counts import PEAK_BYTES, PEAK_FLOPS, bound_s, fft960_flops

ROOT = pathlib.Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"
FRAME = 480
DEVICE = "cuda:0"
K1_SHAPE = (256, 20)  # (B, T) of phase 3; phase 4 takes K2_BATCH of its streams
K2_BATCH = 130
GOLDEN_BATCH = 128
REAL_SHAPE = (4096, 100)
TIMED_CHUNKS = 3
SMALL_CHUNK_BATCH = 64  # phase 6 also profiles an eager two-phase chunk at this B
WALL_CHUNKS = 20  # ... after timing this many on the host clock
LATENCY_PASSES = 2  # timed passes over the golden clip in phase 8
CUSTOM_SHAPE = (8, 20)  # (B, T) of phase 10
K4_SMALL = 100  # rows of phase 11's small shape
T_LANES = [0] + list(range(4, 18))  # candidate lanes holding lags
N_DS, DS_STEP = 864, 240  # a decimated pitch window, and its step a frame
PROBE_CHUNK = 65536  # rows per float64 reference chunk in phase 15
PROBE_BAR = 1e-5  # of the row scale
# times before the current designs (PERF.md section 6, NVIDIA H100 80GB HBM3,
# 700 W): K3 at R=1 before its register tiles, a call; K5 and K6 before
# theirs on the device, cold and warm as phase 7 times them (kernel_ab.py);
# K4 at R rows before its lane-a-candidate design, on the device
# (kernel_ab.py, on its seeded tables)
BEFORE = {("K3", 1): "direct-sum kernel 0.0192-0.0321 ms a call",
          ("K5", 4096): "scalar-load kernel 0.1224 ms cold, 0.1173 warm",
          ("K5", 64): "scalar-load kernel 0.1157 ms cold, 0.1156 warm",
          ("K5", 1): "scalar-load kernel 0.1137 ms cold, 0.1136 warm",
          ("K6", 4096): "scalar loads, 320 threads a stream: 0.0182 ms cold, 0.0134 warm",
          ("K6", 64): "scalar loads, 320 threads a stream: 0.0032 ms cold, 0.0018 warm",
          ("K6", 1): "scalar loads, 320 threads a stream: 0.0017 ms cold, 0.0017 warm",
          ("K4", 409600): "one thread a row, staged in shared memory: 0.8333 ms cold, 0.8347 warm "
                          "with pidx over [181, 768), 0.7694 and 0.7687 over [0, 768)",
          ("K4", 100): "one thread a row, staged in shared memory: 0.0230 ms cold, 0.0138 warm "
                       "with pidx over [181, 768), 0.0196 and 0.0134 over [0, 768)"}
# K5 and K6 also at these batches in phase 7: 1061 ends in a partial block
# of K5's 32-stream tile, 1024 and 64 run its one-stream tile
MID_BATCHES = (1061, 1024, 64)
RNN_WEIGHT_BYTES = 87503  # the standard model's int8 weights (ops/rnn_kernel.py::pack_weights)
PHASE9_MAX = 64  # K2 against its plain version at full size: max units a stream ...
PHASE9_OUTLIERS = 0.001  # ... on all but this share of the streams
NEAR_TIE = 1e-4  # pitch decisions: a float64 margin under which f32 rounding may flip the pick
NEAR_TIE_SHARE = 1e-4  # ... and the share of windows at full size that may flip by over 2
# phase 17: the generator's shape (w worlds, T frames a chunk: the measured
# best of docs/TRAINING_RUN.md), its rows, the trainer's batch, window and
# timed steps, and the gradient check's (B, T)
GEN_WORLDS, GEN_CHUNK, GEN_ROWS = 96, 625, 120_000
CORPUS = (8, 6, 10.0)  # voices, noises, seconds a file
TRAIN_BATCH, TRAIN_WINDOW, TRAIN_STEPS = 32, 2000, 5
GRAD_SHAPE = (4, 200)
GRAPH_STEPS = 3  # train steps of the graph held against the eager steps and the CPU
GEN_FEAT_BAR = 1e-4  # the CPU test's feature bar against the JAX generator
GEN_FLIP_STREAMS = 2  # combined streams whose features may part at a pitch decision flip
SERVE_SECONDS = 2.0
# phase 18: the meshes beyond make_mesh()'s (entries on cuda:0), the split's
# bars (tests/test_parallel.py's), the data-parallel trainer's bars
MESH_SHARDS = (2, 4)
SPLIT_OUT_BAR, SPLIT_VAD_BAR = 1.0, 1e-3
DP_BAR = 1e-6  # of each leaf's largest magnitude
DP_LAUNCH_BAR = 3  # host launches a replay of the data-parallel program
# phase 9: the CUDA runtime calls torch.profiler records that put work on
# the card, and the most of them the graphed scan engine may issue a frame
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                 "cudaMemcpyAsync", "cudaMemsetAsync", "cudaGraphLaunch", "cuGraphLaunch")
SCAN_LAUNCH_BAR = 12
PROFILED_CALLS = 20  # phase 8: process_frame calls under torch.profiler
# phase 19: kernel K7 at train-32x2000's (B, T), its cold calls, and its bars
# against the plain loops (tests/test_torch_gru_sequence.py's)
GRU_SHAPE = (32, 2000)
GRU_REPS = 3
GRU_H_BAR, GRU_GRAD_BAR = 2e-5, 1e-4
# phase 20: kernel K8 at rn02-train-128x2000's (B, T after the convolutions, n)
RN02_GRU_SHAPE = (128, 1996, 384)


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


def graph_ms(torch, fn, reps: int, keep: bool = False) -> float:
    """Device milliseconds of one call of ``fn``: ``reps`` calls captured
    in a CUDA graph, replayed once to warm up and once timed with CUDA
    events, so the host's cost of a call (the wrapper's checks and
    allocations, the launch) is out of the time.  With ``keep`` every
    call's output stays allocated until the graph is gone, so each call
    writes memory of its own."""
    fn()
    torch.cuda.synchronize()
    graph, kept = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        for _ in range(reps):
            out = fn()
            if keep:
                kept.append(out)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph, kept
    return start.elapsed_time(end) / reps


def cold_ms(torch, kern, args: tuple, reps: int) -> float:
    """graph_ms of ``kern(*args)`` with cold caches: each of the ``reps``
    calls reads its own copy of ``args`` and writes its own output.  Where
    the copies and outputs together pass the H100's 50 MB of L2 (B = 4096,
    1061, 1024 and 64 in phase 7), a call finds none of its data in L2 and
    moves it from memory, as a bound's bytes assume."""
    copies = iter([tuple(a.clone() for a in args) for _ in range(reps + 1)])
    return graph_ms(torch, lambda: kern(*next(copies)), reps, keep=True)


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


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): ``counts.bound_s`` and which of its
    two times it is."""
    return bound_s(n_bytes, flops) * 1e3, "bytes" if n_bytes / PEAK_BYTES >= flops / PEAK_FLOPS else "operations"


def kernel_bounds(b: int, t: int, r4: int, r_fwd: int, r_inv: int, band_nnz: int) -> dict:
    """Each kernel's (bytes, flops) at the shapes this run times them: K1
    and K2 at (b, t), K3, K5, K6 at b streams, K4 at r4 rows, the probes at
    r_fwd and r_inv rows.  ``band_nnz``: nonzeros of the band matrix."""
    windows = b * t
    # K1/K3 per window: the 385 x 480 correlation, the 147 x 240 coarse
    # correlation, the 5-lag autocorrelation and the 6-tap FIR over 864
    # samples, the energy table as a running sum (480 + 2 x 384)
    pitch_macs = 385 * 480 + 147 * 240 + 5 * 864 + 6 * 864 + 480 + 2 * 384
    # K5 and K2's RNN: dense 42x24, GRUs 24/48/96 with r pre-multiplied,
    # heads 96x22 and 24x1
    f, d, v, n, h, g = 42, 24, 24, 48, 96, 22
    rnn_macs = f * d + 3 * v * (d + v) + 3 * n * (d + v + f + n) + 3 * h * (v + n + f + h) + h * g + v
    carry_floats = 1728 + 480 + 8 * 22 + 24 + 48 + 96 + 22 + 2
    # K2 per stream-frame: three FFTs, the RNN, four band-sum passes (a
    # product and a multiply-add per nonzero, re and im), the comb filter
    # and gains over 962 lanes (13 flops), the two 22x22 DCTs and the 64
    # cepstral distances
    fft_flops = fft960_flops()
    k2_flops = 3 * fft_flops + 2 * rnn_macs + 4 * 6 * band_nnz + 13 * 962 + 2 * 2 * 22 * 22 \
        + 64 * 22 * 2
    return {
        "K1": (4 * (b * (864 + 240 * t) + windows * (1 + 105 + 1)), 2 * pitch_macs * windows),
        "K2": (4 * (windows * (480 + 105 + 512) + 2 * b * carry_floats), k2_flops * windows),
        "K3": (4 * b * (864 + 105 + 1), 2 * pitch_macs * b),
        # K4 reads 88 table values a row (2 for t0, 4 for each of 14 k,
        # 2 more for each of 15 candidates), xx and pidx; writes 105 lanes
        "K4": (r4 * (88 * 4 + 8 + 105 * 4), 0.0),
        # K5 reads the int8 weights and the tansig table once, besides
        # the states and features of b streams and their outputs
        "K5": (RNN_WEIGHT_BYTES + 4 * 201 + 4 * b * (24 + 48 + 96 + 42 + 24 + 48 + 96 + 22 + 1),
               2 * rnn_macs * b),
        "K6": (b * (4 + 2 * 4 * 960), 0.0),
        "rfft960": (4 * r_fwd * (960 + 962), fft_flops * r_fwd),
        "irfft960": (4 * r_inv * (962 + 960), fft_flops * r_inv),
    }


def k4_reads(torch, pidx):
    """The lags that K4 looks up for each row of (R,) int ``pidx``
    (csrc/candidate_lanes.cuh, t0 = min(pidx // 2, 383)): (R, 59) lags t of
    corr_at (t - 1, t, t + 1 of each candidate t0, t1_2 .. t1_15, then each
    t1b) and (R, 29) of yy_at (each candidate, then each t1b), 88 a row.
    corr_at(t) reads corr[384 - t] and yy_at(t) reads yy[t]; a lookup off
    [0, 385) reads nothing."""
    from nnnoiseless_tpu_torch.tables import SECOND_CHECK

    dev = pidx.device
    t0 = torch.clamp(pidx.to(torch.int64) // 2, max=383)[:, None]
    k = torch.arange(2, 16, device=dev)
    t1 = (2 * t0 + k) // (2 * k)
    second = (2 * torch.tensor(SECOND_CHECK[2:], device=dev) * t0 + k) // (2 * k)
    t1b = torch.where(k == 2, torch.where(t1 + t0 > 384, t0, t0 + t1), second)
    cand = torch.cat([t0, t1], 1)
    return torch.cat([cand - 1, cand, cand + 1, t1b], 1), torch.cat([cand, t1b], 1)


def k4_sectors(torch, pidx) -> int:
    """Distinct 32-byte sectors of the (R, 385) f32 tables corr and yy that
    K4's lookups touch for the pitch indices ``pidx`` (each table 32-byte
    aligned, its rows packed 1540 bytes apart): the least its reads can
    move from memory, since a lone 4-byte read moves a whole sector."""
    corr_t, yy_t = k4_reads(torch, pidx)
    first = torch.arange(pidx.shape[0], device=pidx.device)[:, None] * 385
    total = 0
    for idx in (384 - corr_t, yy_t):
        on = (idx >= 0) & (idx < 385)
        total += int(torch.unique(((first + idx) // 8)[on]).numel())
    return total


def pitch_margins(torch, windows):
    """Float64 margins of the plain pitch search on (n, 864) raw windows,
    from the plain version's f32 whitened window with every sum in f64:
    (coarse, fine).  coarse: the relative gap between the 2nd and 3rd
    coarse ratios xc^2 / max(1 + w, 1) (the top two pick the fine lags);
    fine: the relative gap between the best fine ratio and the next (a
    flip to a neighbouring lag moves the pitch index by up to 3 at the
    search's edge, where no interpolation applies).  inf where no rival
    qualifies.  A margin near f32 rounding (NEAR_TIE) is a decision that
    rounding may flip."""
    from nnnoiseless_tpu_torch.ops.pitch import sliding_dot, whiten, window_energies

    inf = float("inf")
    y = whiten(windows).double()
    ratio = lambda xc, w: torch.where(xc > 0, xc * xc / torch.clamp(1.0 + w, min=1.0), -inf)
    x4, y4 = y[:, 384::2][:, :240], y[:, 0::2][:, :387]
    r4, i4 = ratio(sliding_dot(x4, y4, 147), window_energies(y4, 240, 147)).sort(dim=-1, descending=True,
                                                                                  stable=True)
    coarse = torch.where(torch.isfinite(r4[:, 2]), (r4[:, 1] - r4[:, 2]) / r4[:, 1], inf)
    lags = torch.arange(294, device=y.device)
    near = ((lags - 2 * i4[:, :1]).abs() <= 2) | ((lags - 2 * i4[:, 1:2]).abs() <= 2)
    corr = sliding_dot(y[:, 384:], y, 294)
    r2 = ratio(torch.where(near, corr.clamp(min=-1.0), 0.0), window_energies(y, 480, 294))
    r2 = r2.sort(dim=-1, descending=True).values
    fine = torch.where(torch.isfinite(r2[:, 1]), (r2[:, 0] - r2[:, 1]) / r2[:, 0], inf)
    return coarse, fine


def raw_windows(torch, ds, w0):
    """The function from flat (t, b) window indices of K1's input (ds, w0)
    to their (n, 864) raw windows."""
    b_count = ds.shape[0]

    def windows(idx):
        t, b = idx // b_count, idx % b_count
        w = ds[b[:, None], DS_STEP * (t + 1)[:, None] + torch.arange(N_DS, device=ds.device)]
        w[:, 0] = w0[t, b]
        return w

    return windows


def pitch_bars(torch, kern, plain, lag_lanes: bool = True, windows=None) -> tuple[bool, float, str]:
    """Phase 3's bars on a pitch kernel's (cand, pidx) against its plain
    version's: at most 1% of the windows differ in pidx or (``lag_lanes``)
    the t-lanes, no pidx step over 2, and on the other windows every lane
    within 5e-3 of its row's scale.  With ``windows`` (flat window indices
    -> their (n, 864) raw windows) a step over 2 is allowed on at most
    NEAR_TIE_SHARE of the windows, each a near-tie: a float64 margin of the
    plain search (pitch_margins) under NEAR_TIE; each is printed.  Returns
    (ok, max abs error on the matching windows, message with the count of
    differing windows)."""
    (ck, pk_), (cp, pp) = kern, plain
    ck, cp = ck.reshape(-1, ck.shape[-1]), cp.reshape(-1, cp.shape[-1])
    pk_, pp = pk_.reshape(-1), pp.reshape(-1)
    differ = pk_ != pp
    if lag_lanes:
        differ |= (ck[:, T_LANES] != cp[:, T_LANES]).any(-1)
    n_diff, worst = int(differ.sum()), int((pk_ - pp).abs().max())
    same = ~differ
    rowscale = cp.abs().amax(-1, keepdim=True) + 1.0
    rel = float(((ck - cp).abs() / rowscale)[same].max()) if bool(same.any()) else 0.0
    err = float((ck - cp).abs()[same].max()) if bool(same.any()) else 0.0
    steps_ok = worst <= 2
    big = torch.nonzero((pk_ - pp).abs() > 2)[:, 0]
    ties = ""
    if windows is not None and len(big):
        coarse, fine = pitch_margins(torch, windows(big))
        margin = torch.minimum(coarse, fine)
        steps_ok = len(big) <= NEAR_TIE_SHARE * differ.numel() and bool((margin < NEAR_TIE).all())
        ties = "".join(f"\n      window {int(w)}: pidx {int(pk_[w])} against {int(pp[w])}; float64 "
                       f"margins coarse {float(c):.3g}, fine {float(f):.3g}"
                       for w, c, f in zip(big, coarse, fine))
    ok = n_diff <= 0.01 * differ.numel() and steps_ok and rel < 5e-3
    return ok, err, (f"{n_diff} of {differ.numel()} windows differ in pidx/t-lanes (largest pidx "
                     f"step {worst}, {len(big)} over 2); matching windows: max abs {err:.3g}, "
                     f"row-scale {rel:.3g}{ties}")


def eager_frames(torch, engine, dev, frames, passes: int):
    """The per-frame path without its graph, the reference phase 8 holds
    the graph to: a loop of the eager pipeline.frame_step at B=1 from a
    zero carry, each call uploading its frame and reading back its output
    and vad.  Returns (the first pass's outputs (T, 480), every call's wall
    ms over ``passes`` passes)."""
    from nnnoiseless_tpu_torch.pipeline import frame_step, init_carry

    ms, outs = [], []
    for p in range(passes):
        carry = init_carry(engine.model.meta, 1, dev)
        for f in frames:
            t0 = time.perf_counter()
            carry, out, vad = frame_step(engine.rnn, carry, torch.as_tensor(f[None], device=dev),
                                         engine.rnn_weights)
            o, _ = out[0].cpu().numpy(), float(vad[0])
            ms.append((time.perf_counter() - t0) * 1e3)
            if p == 0:
                outs.append(o)
    return np.stack(outs), ms


def eager_scan(torch, engine, carry, frames):
    """The scan engine without its graph, the reference phase 9 holds the
    graph to: the lag-0 precompute, then a loop of the eager
    pipeline.frame_step_hoisted.  Returns (out (B, T, 480), vad (B, T),
    periods (B, T))."""
    from nnnoiseless_tpu_torch.chunk import precompute_chunk
    from nnnoiseless_tpu_torch.pipeline import FramePre, frame_step_hoisted

    pre, _ = precompute_chunk(carry.feat.input_mem, carry.feat.hp_mem, frames, lag0=True)
    outs, vads, pers = [], [], []
    for t in range(frames.shape[1]):
        carry, out, vad = frame_step_hoisted(engine.rnn, carry, FramePre(*(f[t] for f in pre)),
                                             engine.rnn_weights)
        outs.append(out)
        vads.append(vad)
        pers.append(carry.feat.pitch_period)
    return torch.stack(outs, 1), torch.stack(vads, 1), torch.stack(pers, 1)


def eager_features(state, pre):
    """The generator's frame loop without its graph, the reference phase 17
    holds the graph to: a loop of the eager pipeline.analyze_frame_hoisted
    on the chunk precompute's slices (training.data._feature_chunk's
    ``frame_loop``)."""
    import torch

    from nnnoiseless_tpu_torch.pipeline import FramePre, analyze_frame_hoisted

    feats = []
    for t in range(pre.filtered.shape[0]):
        state, an = analyze_frame_hoisted(state, FramePre(*(f[t] for f in pre)))
        feats.append(an.features)
    return state, torch.stack(feats, 1)


def profile_run(torch, run, per: int):
    """``run()`` under torch.profiler, per one of ``per`` units (calls or
    frames): (the CUDA runtime calls of HOST_LAUNCHES by name, their sum,
    device operations, device busy ms).  Device busy is the sum of the
    device time of every operation the profiler saw on the card."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    host = {e.key: e.count for e in events if e.key in HOST_LAUNCHES}
    on_dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    return (host, sum(host.values()) / per, sum(e.count for e in on_dev) / per,
            sum(e.self_device_time_total for e in on_dev) / 1e3 / per)


def golden_worst(out: np.ndarray, ref: np.ndarray) -> tuple[float, float]:
    """Worst stream's (rel squared error, max per-sample error) of (S, n)
    outputs with the first frame, against the reference output."""
    worst_rel, worst_max = 0.0, 0.0
    for row in out:
        g = np.clip(np.rint(row[FRAME:].astype(np.float64)), -32768, 32767)
        w = ref[: len(g)]
        worst_rel = max(worst_rel, float(np.sum((w - g) ** 2) / np.sum(g ** 2)))
        worst_max = max(worst_max, float(np.abs(w - g).max()))
    return worst_rel, worst_max


def waveform_bars(torch, got, want, per_got, per_want) -> tuple[bool, str]:
    """Phase 4's bars on two engines' outputs: rel < 1e-3, max <= 64, > 16
    units on <= 5% of samples, periods agree on >= 98% of frames."""
    d = (got.double() - want.double()).abs()
    rel = float((d ** 2).sum() / (want.double() ** 2).sum())
    frac16 = float((d > 16).double().mean())
    agree = float((per_got == per_want).double().mean())
    ok = rel < 1e-3 and float(d.max()) <= 64 and frac16 <= 0.05 and agree >= 0.98
    return ok, (f"rel {rel:.3g}, max {float(d.max()):.3g}, >16: {frac16:.3%}, "
                f"periods agree {agree:.4%}")


def k2_full_bars(torch, got, want, per_got, per_want) -> tuple[bool, str, list]:
    """Phase 4's bars on (B, T, 480) outputs at full size, the max one per
    stream: rel < 1e-3, > 16 units on <= 5% of samples, periods agree on
    >= 98% of frames, and every stream within PHASE9_MAX units except at
    most PHASE9_OUTLIERS of them, each of those with its own rel < 1e-3.
    Returns (ok, message, [(stream, its max, the frame of its max)])."""
    d = (got.double() - want.double()).abs()
    w2 = want.double() ** 2
    rel = float((d ** 2).sum() / w2.sum())
    frac16 = float((d > 16).double().mean())
    agree = float((per_got == per_want).double().mean())
    stream_max = d.amax((1, 2))
    over = torch.nonzero(stream_max > PHASE9_MAX)[:, 0].tolist()
    outliers = [(s, float(stream_max[s]), int(d[s].amax(1).argmax())) for s in over]
    stream_rel = [float((d[s] ** 2).sum() / w2[s].sum()) for s in over]
    ok = (rel < 1e-3 and frac16 <= 0.05 and agree >= 0.98
          and len(over) <= PHASE9_OUTLIERS * got.shape[0] and all(r < 1e-3 for r in stream_rel))
    return ok, (f"rel {rel:.3g}, max {float(stream_max.max()):.3g}, >16: {frac16:.3%}, "
                f"periods agree {agree:.4%}, {len(over)} of {got.shape[0]} streams over "
                f"{PHASE9_MAX} units (at most {PHASE9_OUTLIERS:.1%}), their rel "
                f"{max(stream_rel, default=0.0):.3g} at most"), outliers


def comb_margins(torch, fk, rnn, carry, filt, cand):
    """Replay streams through K2's plain version: (T, n) the comb filter's
    smallest |e - g| over the bands in each frame, where e is the band's
    pitch correlation and g its gain (its e > g test; near 0 is a
    near-tie)."""
    seen = []
    inner = fk._pitch_filter

    def spy(x, p, ex, ep, exp, gains):
        seen.append((exp - gains).abs().amin(1))
        return inner(x, p, ex, ep, exp, gains)

    fk._pitch_filter = spy
    try:
        fk.frame_loop_plain(rnn, carry, filt, cand)
    finally:
        fk._pitch_filter = inner
    return torch.stack(seen)


def custom_model(nt, seed: int):
    """A valid model of non-standard topology (a 32-neuron vad GRU) with
    seeded int8-valued weights."""
    from nnnoiseless_tpu_torch.model import LayerMeta, ModelMeta

    rng = np.random.RandomState(seed)
    layers = (
        ("input_dense", 42, 24, 0), ("vad_gru", 24, 32, 1), ("noise_gru", 98, 48, 2),
        ("denoise_gru", 122, 96, 2), ("denoise_output", 96, 22, 1), ("vad_output", 32, 1, 1),
    )
    w = lambda *shape: rng.randint(-40, 41, size=shape).astype(np.float32)
    params = {
        name: ({"wi": w(n_in, 3 * n), "wr": w(n, 3 * n), "b": w(3 * n)} if name.endswith("gru")
               else {"w": w(n_in, n), "b": w(n)})
        for name, n_in, n, _ in layers
    }
    return nt.RnnModel(params, ModelMeta(*(LayerMeta(n_in, n, a) for _, n_in, n, a in layers)))


def kept_fit(torch, arrays: dict, **kw):
    """``fit(*arrays.values(), **kw)`` with the TrainProgram it builds kept
    after it returns: (params, history, the program, ms a step of fit's
    wall by CUDA events: init, upload, the capture and readback included).
    The program also holds ``model`` and ``start``, copies of the state it
    starts from, so that it can be replayed again from fit's first step."""
    from nnnoiseless_tpu_torch import programs
    from nnnoiseless_tpu_torch.training import train as train_mod

    built = []

    class KeptProgram(programs.TrainProgram):
        def __init__(self, step, model, opt, batch_size):
            super().__init__(step, model, opt, batch_size)
            self.model = model
            self.start = [t.detach().clone() for t in self.program.state]
            built.append(self)

    history = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    train_mod.TrainProgram = KeptProgram
    try:
        start.record()
        params = train_mod.fit(*arrays.values(), history=history, **kw)
        end.record()
        end.synchronize()
    finally:
        train_mod.TrainProgram = programs.TrainProgram
    if len(built) != 1:
        raise RuntimeError(f"fit built {len(built)} train programs, not one")
    return params, history, built[0], start.elapsed_time(end) / max(len(history), 1)


def replays_against_eager(torch, prog, eager_model, eager_step, step_idx) -> dict:
    """``prog`` (from kept_fit), its state put back to fit's first, replayed
    once for each of ``step_idx`` against ``eager_step`` (idx -> loss) of
    ``eager_model``, which starts from the same state; then TRAIN_STEPS
    replays timed and one under torch.profiler.  Returns {bit (losses and
    parameters equal), profile_s (the profiled replay's wall seconds,
    tracing and its reading included), losses, eager_ms, replay_ms, host
    (HOST_LAUNCHES by name), dev_ops, kernels, nccl (device operations
    named nccl), busy}."""
    with torch.no_grad():
        for t, s in zip(prog.program.state, prog.start):
            t.copy_(s)
    losses_g = torch.stack([prog(idx).clone() for idx in step_idx])
    params_g = [q.detach().clone() for q in prog.model.parameters()]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    losses_e, eager_ms = [], []
    for idx in step_idx:
        start.record()
        losses_e.append(eager_step(idx))
        end.record()
        end.synchronize()
        eager_ms.append(start.elapsed_time(end))
    bit = torch.equal(losses_g, torch.stack(losses_e)) and all(
        torch.equal(x, y) for x, y in zip(params_g, eager_model.parameters()))
    start.record()
    for k in range(TRAIN_STEPS):
        prog(step_idx[k % len(step_idx)])
    end.record()
    end.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        prog(step_idx[0])
        torch.cuda.synchronize()
    events = prof.key_averages()
    on_dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"bit": bit, "profile_s": time.perf_counter() - t0, "losses": losses_g, "eager_ms": eager_ms, "replay_ms": start.elapsed_time(end) / TRAIN_STEPS,
            "host": {e.key: e.count for e in events if e.key in HOST_LAUNCHES},
            "dev_ops": sum(e.count for e in on_dev),
            "kernels": sum(e.count for e in on_dev if not e.key.startswith(("Memcpy", "Memset"))),
            "nccl": sum(e.count for e in on_dev if "nccl" in e.key.lower()),
            "busy": sum(e.self_device_time_total for e in on_dev) / 1e3}


def training_phase(torch, dev, card: str, reset_counts, counts) -> dict:
    """Phase 17, the training path (see the module docstring).  Raises on
    any failed bar.  Returns what phase 18's data-parallel trainer is held
    to: the trainer's rows (``arrays``), ``fit``'s keywords, parameters and
    history, the graph steps' index vectors, and the one-device program's
    ms a step (replays, and the eager steps beside them)."""
    import copy
    import os
    from concurrent.futures import ThreadPoolExecutor

    import nnnoiseless_tpu_torch as nt
    from nnnoiseless_tpu_torch import chunk as chunk_mod
    from nnnoiseless_tpu_torch import pipeline as pipe_mod
    from nnnoiseless_tpu_torch import programs
    from nnnoiseless_tpu_torch.chunk import decimate
    from nnnoiseless_tpu_torch.ops import pitch_kernel as pk
    from nnnoiseless_tpu_torch.ops import window as wk
    from nnnoiseless_tpu_torch.ops.biquad import biquad_filter_frames
    from nnnoiseless_tpu_torch.tables import BIQUAD_HP_A, BIQUAD_HP_B
    from nnnoiseless_tpu_torch.tools.datagen_bench import _load_synth
    from nnnoiseless_tpu_torch.training import data as td
    from nnnoiseless_tpu_torch.training.losses import l2_regularization, total_loss
    from nnnoiseless_tpu_torch.training.network import (
        WEIGHT_CLIP, compute_sample_weights, export_model, init_train_params, make_optimizer, sequence_forward,
    )
    from nnnoiseless_tpu_torch.training.train import train_step_indexed

    ts = _load_synth()
    failures = []  # every bar is read before the phase fails, so that one run shows them all
    with tempfile.TemporaryDirectory() as tmp:
        # ---- the corpus ----
        t0 = time.perf_counter()
        rng = np.random.RandomState(0)
        n_voices, n_noises, seconds = CORPUS
        voices, noises = [], []
        for i in range(n_voices):
            voices.append(os.path.join(tmp, f"voice{i}.wav"))
            ts.write_wav(voices[-1], (ts.synth_voice if i < 6 else ts.synth_voice_varied)(rng, seconds=seconds))
        for i in range(n_noises):
            noises.append(os.path.join(tmp, f"noise{i}.wav"))
            ts.write_wav(noises[-1], ts.synth_noise(rng, ("white", "pink", "band")[i % 3], seconds=seconds))
        print(f"[17] corpus: {n_voices} voices, {n_noises} noises of {seconds:g} s, built in "
              f"{time.perf_counter() - t0:.1f} s; host cores {os.cpu_count()}")

        # ---- one generator chunk: the graph, the eager loop and the plain versions ----
        w, t = GEN_WORLDS, GEN_CHUNK
        with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
            frames_np, _, _ = td._mix_chunk(td._make_worlds(voices, noises, t, 0, w), t, pool)
        frames = torch.from_numpy(frames_np.reshape(2 * w, t, FRAME)).to(dev)
        states = pipe_mod.init_feature_state(3 * w, dev)
        gen_prog = programs.FeatureProgram(w, dev)
        reset_counts()
        st_k, feats_k, ex_k, sil_k = td._feature_chunk(states, frames, gen_prog)
        torch.cuda.synchronize()
        chunk_counts = counts()
        g17 = gen_prog.program
        print(f"[17] generator chunk w={w} T={t} through its graph: launches K1 {chunk_counts['K1']} (B={3 * w}), "
              f"K6 {chunk_counts['K6']} (B={w}); {g17.replays} replays, {g17.warmups} warm-up step, kernels "
              f"captured {g17.captured}, pool {g17.pool_bytes / 2 ** 20:.1f} MiB, warm-up {g17.warmup_s:.3f} s, "
              f"capture {g17.capture_s:.3f} s")
        if (chunk_counts["K1"] != 1 or g17.replays != t or g17.captured != {"K6": 1}
                or chunk_counts["K6"] != g17.replays + g17.warmups):
            failures.append("the generator chunk did not launch K1 once and replay K6 once a frame")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        st_e, feats_e, ex_e, sil_e = td._feature_chunk(states, frames, eager_features)
        end.record()
        end.synchronize()
        eager_chunk_ms = start.elapsed_time(end)
        start.record()
        td._feature_chunk(states, frames, gen_prog)
        end.record()
        end.synchronize()
        graph_chunk_ms = start.elapsed_time(end)
        bit17 = (all(torch.equal(x, y) for x, y in ((feats_k, feats_e), (ex_k, ex_e), (sil_k, sil_e)))
                 and all(torch.equal(x, y) for x, y in zip(st_k, st_e)))
        host, n_host, n_dev, busy = profile_run(torch, lambda: td._feature_chunk(states, frames, gen_prog), t)
        print(f"[17] the chunk's graph against the eager frame loop on the card: bit-equal {bit17} (features, ex, "
              f"silence, every state field); {graph_chunk_ms:.1f} ms a chunk graphed, {eager_chunk_ms:.1f} ms eager "
              f"(CUDA events); a frame graphed (torch.profiler over the chunk): host launches {n_host:.2f} {host}, "
              f"device operations {n_dev:.1f}, device busy {busy:.4f} ms ({card})")
        if not bit17:
            failures.append("the generator chunk's graph is not bit-equal to the eager frame loop")
        if not host.get("cudaGraphLaunch", 0) >= t or n_host > SCAN_LAUNCH_BAR:
            failures.append(f"the generator's graph issued {n_host:.2f} host launches a frame (at most {SCAN_LAUNCH_BAR})")
        del st_e, feats_e, ex_e, sil_e, st_k
        wrappers = (chunk_mod.pitch_analysis_stream, pipe_mod.window_at_lag)
        chunk_mod.pitch_analysis_stream, pipe_mod.window_at_lag = pk.pitch_analysis_plain, wk.barrel_shift_window
        try:
            reset_counts()
            _, feats_p, ex_p, sil_p = td._feature_chunk(states, frames, eager_features)
            torch.cuda.synchronize()
        finally:
            chunk_mod.pitch_analysis_stream, pipe_mod.window_at_lag = wrappers
        if counts()["K1"] or counts()["K6"]:
            failures.append("the plain run of the generator chunk launched a kernel")

        # K1 on the chunk's 3w streams against its plain version, held to
        # phase 6's bars on the combined streams: the generator reads their
        # pitch lanes only.  The clean and noise streams' lanes are computed
        # and never read.
        fr = frames.reshape(w, 2, t, FRAME)
        frames3 = torch.cat([fr, (fr[:, 0] + fr[:, 1])[:, None]], 1).reshape(3 * w, t, FRAME)
        filtered, _ = biquad_filter_frames(frames3, states.hp_mem, tuple(BIQUAD_HP_A), tuple(BIQUAD_HP_B))
        ds, w0 = decimate(torch.cat([states.input_mem, filtered.reshape(3 * w, -1)], 1), t)
        k1_k, k1_p = pk.pitch_analysis_cuda(ds, w0, t), pk.pitch_analysis_plain(ds, w0, t)
        windows = raw_windows(torch, ds, w0)
        comb = lambda out: (out[0][:, 2::3], out[1][:, 2::3])
        ok, _, msg = pitch_bars(torch, comb(k1_k), comb(k1_p),
                                windows=lambda i: windows(i // w * (3 * w) + 3 * (i % w) + 2))
        print(f"[17] K1 against its plain version at B={3 * w} T={t}, on the {w} combined streams: {msg}")
        if not ok:
            failures.append("K1 disagrees with its plain version on the generator's combined streams")

        ex_ok = torch.allclose(ex_k, ex_p, rtol=1e-6, atol=1e-12)
        sil_ok = torch.equal(sil_k, sil_p)
        d = (feats_k - feats_p).abs().amax(-1)  # (w, T)
        parted = torch.nonzero((d > GEN_FEAT_BAR).any(1))[:, 0].tolist()
        print(f"[17] the chunk through the kernels against the plain versions: ex (3w, T, 22) max abs "
              f"{float((ex_k - ex_p).abs().max()):.3g}, within 1e-6 relative {ex_ok}; silence equal {sil_ok}; "
              f"features (w, T, 42) max abs {float(d.max()):.3g}, {len(parted)} of {w} combined streams part "
              f"by over {GEN_FEAT_BAR:g} (at most {GEN_FLIP_STREAMS}, each at a pitch decision)")
        for j in parted:
            f0 = int(torch.nonzero(d[j] > GEN_FEAT_BAR)[0, 0])
            s = 3 * j + 2
            period = lambda f: int(round(float(f[j, f0, 40]) * 100 + 300))
            flips = torch.nonzero(k1_k[1][: f0 + 1, s] != k1_p[1][: f0 + 1, s])[:, 0]
            line = (f"[17]   combined stream {j}: features part at frame {f0}, period {period(feats_k)} "
                    f"against {period(feats_p)}")
            if len(flips):
                coarse, fine = pitch_margins(torch, windows(flips * (3 * w) + s))
                line += "; K1's pidx differs at frame " + ", ".join(
                    f"{int(f)} ({int(k1_k[1][f, s])} against {int(k1_p[1][f, s])}; float64 margins coarse "
                    f"{float(c):.3g}, fine {float(g):.3g})" for f, c, g in zip(flips, coarse, fine))
            else:
                line += "; K1's pidx agrees up to it (the octave removal's choice on lanes within K1's bar)"
            print(line)
        if not (ex_ok and sil_ok and len(parted) <= GEN_FLIP_STREAMS):
            failures.append("the generator chunk through the kernels misses its bars against the plain versions")
        del frames, frames3, filtered, ds, w0, k1_k, k1_p, feats_k, feats_p, ex_k, ex_p

        # ---- generator throughput ----
        gen = dict(workers=w, chunk=t, device=dev)
        td.generate(voices, noises, w * t, seed=99, **gen)  # warm-up at the same shape
        reset_counts()
        timing = {}
        t0 = time.perf_counter()
        data = td.generate(voices, noises, GEN_ROWS, seed=1, timing=timing, **gen)
        wall = time.perf_counter() - t0
        gen_counts = counts()
        print(f"[17] generate {GEN_ROWS} rows, workers={w} chunk={t}: {wall:.2f} s wall, "
              f"{GEN_ROWS / wall:,.0f} rows/s; device_s {timing['device_s']:.2f}, host_s {timing['host_s']:.2f}; "
              f"launches K1 {gen_counts['K1']}, K6 {gen_counts['K6']} ({card})")
        if data.shape != (GEN_ROWS, 87) or not np.isfinite(data).all():
            failures.append("the generator's rows are not finite or have the wrong shape")
        if gen_counts["K1"] == 0 or gen_counts["K6"] == 0:
            failures.append("the generator did not launch K1 and K6")

        # ---- the trainer at full width ----
        n_seq = GEN_ROWS // TRAIN_WINDOW
        rows = data[: n_seq * TRAIN_WINDOW].reshape(n_seq, TRAIN_WINDOW, -1)
        arrays = {"features": rows[..., :42], "gains": rows[..., 42:64], "vad": rows[..., 86:]}
        arrays = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
        gb, gt = GRAD_SHAPE
        model_cpu = init_train_params(torch.Generator().manual_seed(17))
        model_dev = copy.deepcopy(model_cpu).to(dev)
        res = {}
        for name, model, where in (("cpu", model_cpu, "cpu"), ("card", model_dev, dev)):
            x = {k: torch.as_tensor(v[:gb, :gt], device=where) for k, v in arrays.items()}
            g, v = sequence_forward(model, x["features"])
            (total_loss(x["gains"], g, x["vad"], v) + l2_regularization(model)).backward()
            res[name] = (g.detach().cpu(), v.detach().cpu(),
                         {n: p.grad.cpu() for n, p in model.named_parameters()})
        fwd_err = max(float((a - b).abs().max()) for a, b in zip(res["cpu"][:2], res["card"][:2]))
        grad_rel = {n: float((res["card"][2][n] - gc).abs().max() / gc.abs().max().clamp(min=1e-30))
                    for n, gc in res["cpu"][2].items()}
        worst = max(grad_rel, key=grad_rel.get)
        print(f"[17] sequence_forward and the loss's gradient at B={gb} T={gt}, the card against the CPU: "
              f"gains/vad max abs {fwd_err:.3g} (bar 1e-5); gradient max abs over the leaf's max, worst "
              f"{grad_rel[worst]:.3g} ({worst}; bar 1e-4)")
        if not (fwd_err <= 1e-5 and grad_rel[worst] <= 1e-4):
            failures.append("the trainer on the card disagrees with the CPU")

        # ---- fit at full width: one captured graph a step ----
        fit_kw = dict(batch_size=TRAIN_BATCH, seed=17, log_every=10 ** 6, device=dev)
        params, history, prog, step_ms = kept_fit(torch, arrays, epochs=TRAIN_STEPS, **fit_kw)
        tp = prog.program
        fit_calls = (tp.warmups, tp.replays)
        losses = [l for _, l in history]
        clip = max(float(np.abs(a).max()) for layer in params.values() for a in layer.values())
        print(f"[17] fit at batch {TRAIN_BATCH} x {TRAIN_WINDOW} on {n_seq} sequences: {step_ms:.1f} ms a step "
              f"(CUDA events around fit of {len(history)} steps: init, upload, the capture and readback included); "
              f"(warm-up steps, replays) {fit_calls}; losses {', '.join(f'{l:.4f}' for l in losses)}; largest "
              f"|weight| {clip:.4f} ({card})")
        if len(history) != TRAIN_STEPS or not np.all(np.isfinite(losses)) or clip > WEIGHT_CLIP:
            failures.append("the trainer's losses are not finite or a weight passed the clip")
        if fit_calls != (1, TRAIN_STEPS):
            failures.append(f"fit did not run one program replay a step: {fit_calls}")
        k7_step = {"backward": tp.captured.get("K7 backward", 0)}
        k7_step["forward"] = tp.captured.get("K7", 0) - k7_step["backward"]
        print(f"[17] the train step's captured launches: {tp.captured}; K7 forward {k7_step['forward']}, "
              f"backward {k7_step['backward']} (3 and 3)")
        if k7_step != {"forward": 3, "backward": 3}:
            failures.append(f"the train step did not capture 3 forward and 3 backward K7 launches: {tp.captured}")

        # its graph, put back to fit's first state, against eager capturable
        # steps from the same params (fit's first index vectors)
        on_dev = {k: torch.as_tensor(v, device=dev) for k, v in arrays.items()}
        seq_w = torch.as_tensor(compute_sample_weights(arrays["gains"]), device=dev)
        perm_rng = np.random.RandomState(17)
        step_idx = [torch.as_tensor(perm_rng.permutation(n_seq)[:TRAIN_BATCH], device=dev)
                    for _ in range(GRAPH_STEPS)]
        model_e = init_train_params(torch.Generator().manual_seed(17)).to(dev)
        opt_e = make_optimizer(model_e)
        r = replays_against_eager(torch, prog, model_e, lambda idx: train_step_indexed(model_e, opt_e, on_dev, idx, seq_w),
                                  step_idx)
        print(f"[17] the train step at batch {TRAIN_BATCH} x {TRAIN_WINDOW} as one CUDA graph (fit's): warm-up step "
              f"{tp.warmup_s:.2f} s, capture and instantiation {tp.capture_s:.2f} s, pool {tp.pool_bytes / 2 ** 20:.1f} "
              f"MiB; {r['replay_ms']:.1f} ms a step over {TRAIN_STEPS} replays (CUDA events), eager capturable steps "
              f"{', '.join(f'{m:.1f}' for m in r['eager_ms'])} ms; one replay by torch.profiler: host launches "
              f"{sum(r['host'].values())} {r['host']}, device operations {r['dev_ops'] or 'not traced'}, "
              f"{r['kernels']} of them kernels (the captured kernels), device busy {r['busy']:.1f} ms; profiled in "
              f"{r['profile_s']:.1f} s ({card})")
        print(f"[17] {GRAPH_STEPS} graph steps from fit's first state against {GRAPH_STEPS} eager capturable steps "
              f"from the same params: bit-equal {r['bit']} (losses {', '.join(f'{float(l):.6f}' for l in r['losses'])})")
        if not r["bit"]:
            failures.append("the train step's graph is not bit-equal to the eager capturable steps")
        if not r["dev_ops"]:
            failures.append("torch.profiler saw no device operation in a replay of the train step")
        trained = {"arrays": arrays, "fit_kw": fit_kw, "fit_params": params, "fit_history": history,
                   "step_idx": [idx.cpu() for idx in step_idx], "replay_ms": r["replay_ms"],
                   "eager_ms": r["eager_ms"], "k7_step": k7_step}
        del prog, tp, model_e, opt_e, on_dev, r
        torch.cuda.empty_cache()

        # 3 steps at GRAD_SHAPE, the card (its graph) against the CPU
        def trainer(where, data, weights, batch):
            model = init_train_params(torch.Generator().manual_seed(17)).to(where)
            opt = make_optimizer(model)
            prog = programs.TrainProgram(lambda idx: train_step_indexed(model, opt, data, idx, weights),
                                         model, opt, batch)
            return model, opt, prog

        sub = {k: np.ascontiguousarray(v[: GRAPH_STEPS * gb, :gt]) for k, v in arrays.items()}
        sub_w = compute_sample_weights(sub["gains"])
        small = {}
        for where in ("cpu", dev):
            data = {k: torch.as_tensor(v, device=where) for k, v in sub.items()}
            model, _, prog = trainer(where, data, torch.as_tensor(sub_w, device=where), gb)
            losses = [prog(torch.arange(k * gb, (k + 1) * gb, device=where)).clone() for k in range(GRAPH_STEPS)]
            small[str(where)] = (torch.stack(losses).cpu(), {n: q.detach().cpu() for n, q in model.named_parameters()})
        (l_cpu, p_cpu), (l_card, p_card) = small["cpu"], small[str(dev)]
        loss_rel = float(((l_card - l_cpu).abs() / l_cpu.abs()).max())
        excess = {n: float(((p_card[n] - w).abs() - (1e-5 + 1e-4 * w.abs())).max()) for n, w in p_cpu.items()}
        worst = max(excess, key=excess.get)
        print(f"[17] {GRAPH_STEPS} steps at B={gb} T={gt}, the card's graph against the CPU: losses max relative "
              f"{loss_rel:.3g} (bar 1e-5); parameters, worst leaf {worst}: max |d| "
              f"{float((p_card[worst] - p_cpu[worst]).abs().max()):.3g}, over rtol 1e-4 + atol 1e-5 by "
              f"{excess[worst]:.3g} (at most 0)")
        if not (loss_rel <= 1e-5 and excess[worst] <= 0):
            d = (p_card[worst] - p_cpu[worst]).abs() - (1e-5 + 1e-4 * p_cpu[worst].abs())
            for i in torch.nonzero(d > 0)[:8].tolist():
                print(f"[17]   {worst}{i}: card {float(p_card[worst][tuple(i)]):.9g}, CPU "
                      f"{float(p_cpu[worst][tuple(i)]):.9g}")
            failures.append("the train steps on the card miss the CPU test's bars")
        del small, model, prog

        # ---- export and serve ----
        blob = export_model(params).to_bytes()
        served = nt.RnnModel.from_bytes(blob)
        mix_rng = np.random.RandomState(12345)
        clean = ts.synth_voice(mix_rng, seconds=SERVE_SECONDS)
        noise = ts.synth_noise(mix_rng, "pink", seconds=SERVE_SECONDS)
        noisy = (clean + np.sqrt(np.dot(clean, clean) / (np.dot(noise, noise) * 10 ** 0.5)) * noise)
        noisy = noisy.astype(np.float32)
        reset_counts()
        out_card = nt.denoise_audio(noisy, served, device=dev)
        serve_counts = counts()
        out_cpu = nt.denoise_audio(noisy, served, device="cpu")
        got, want = (np.clip(np.rint(o.astype(np.float64)), -32768, 32767) for o in (out_card, out_cpu))
        rel = float(np.sum((want - got) ** 2) / np.sum(got ** 2))
        worst_units = float(np.abs(want - got).max())
        print(f"[17] exported {len(blob)} bytes; denoise_audio of a {SERVE_SECONDS:g} s synthetic mix on the card "
              f"against the CPU: rel {rel:.3g}, max {worst_units:.0f} units; launches K1 {serve_counts['K1']}, "
              f"K2 {serve_counts['K2']}")
        if not (rel < 1e-4 and worst_units <= 2):
            failures.append("the exported model on the card misses the golden bars against the CPU")
        if serve_counts["K1"] == 0 or serve_counts["K2"] == 0:
            failures.append("the exported model's inference did not launch K1 and K2")
    if failures:
        raise RuntimeError("phase 17: " + "; ".join(failures))
    return trained


def _map_leaves(fn, tree):
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(fn, sub) for sub in tree))
    return fn(tree)


def parallel_phase(torch, dev, card: str, engine, big, trained: dict, reset_counts, counts) -> None:
    """Phase 18, the multi-device split and data-parallel fit (see the
    module docstring).  ``big``: phase 6's input on the card, four chunks;
    ``trained``: what phase 17 returns.  Raises on any failed bar, after
    every bar is read."""
    import os

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import nnnoiseless_tpu_torch as nt
    from nnnoiseless_tpu_torch import programs
    from nnnoiseless_tpu_torch.chunk import decimate, precompute_chunk
    from nnnoiseless_tpu_torch.ops import frame_kernel as fk
    from nnnoiseless_tpu_torch.ops import pitch_kernel as pk
    from nnnoiseless_tpu_torch.ops.biquad import biquad_filter_frames
    from nnnoiseless_tpu_torch.parallel import make_mesh, shard_batch, sharded_process_frames
    from nnnoiseless_tpu_torch.tables import BIQUAD_HP_A, BIQUAD_HP_B
    from nnnoiseless_tpu_torch.training.network import compute_sample_weights, init_train_params, make_optimizer
    from nnnoiseless_tpu_torch.training.train import train_step_dp

    b, t = REAL_SHAPE
    chunk = lambda c: big[:, c * t : (c + 1) * t]
    failures = []
    ref = nt.StreamBatch(b, engine, device=dev)
    want = [ref.process_tensor(chunk(c)) for c in (0, 1)]
    host0 = chunk(0).cpu().numpy()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def chunk_ms(run) -> float:
        """Mean ms of TIMED_CHUNKS chunks of ``run(c)`` after a warm-up one."""
        run(0)
        torch.cuda.synchronize()
        start.record()
        for c in range(1, TIMED_CHUNKS + 1):
            run(c)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / TIMED_CHUNKS

    unsharded = lambda c: ref.process_tensor(chunk(c))
    base_ms = [chunk_ms(unsharded)]
    for mesh in [make_mesh()] + [make_mesh([dev] * n) for n in MESH_SHARDS]:
        n = mesh.size
        carry = shard_batch(nt.init_batch_carry(engine.model.meta, b, dev), mesh)
        errs, launches = [], []
        for frames, (want_out, want_vad) in zip((host0, chunk(1)), want):
            reset_counts()
            carry, out, vad = sharded_process_frames(engine.model, carry, frames, mesh)
            torch.cuda.synchronize()
            launches.append((counts()["K1"], counts()["K2"]))
            errs.append((float((out - want_out).abs().max()), float((vad - want_vad).abs().max()),
                         torch.equal(out, want_out) and torch.equal(vad, want_vad)))
            del out, vad
        placed = all(leaf.device == d for shard, d in zip(carry, mesh.devices) for leaf in programs.leaves(shard))
        state = [carry]

        def sharded(c):
            state[0] = sharded_process_frames(engine.model, state[0], chunk(c), mesh)[0]

        ms = chunk_ms(sharded)
        print(f"[18] split over {n} entr{'y' if n == 1 else 'ies'} ({', '.join(map(str, mesh.devices))}), "
              f"B={b} T={t}: {ms:.2f} ms a chunk; against StreamBatch, chunk 1 (from host memory) out max "
              f"{errs[0][0]:.3g}, vad max {errs[0][1]:.3g}, bit-equal {errs[0][2]}; chunk 2 (the sharded carry) "
              f"out max {errs[1][0]:.3g}, vad max {errs[1][1]:.3g}, bit-equal {errs[1][2]}; launches (K1, K2) a "
              f"chunk {launches}; carry slices on their entries' devices {placed} ({card})")
        if not all(o <= SPLIT_OUT_BAR and v <= SPLIT_VAD_BAR for o, v, _ in errs):
            failures.append(f"the split over {n} entries misses its bars against StreamBatch")
        if any(l != (n, n) for l in launches):
            failures.append(f"the split over {n} entries did not launch K1 and K2 once a shard a chunk")
        if not placed:
            failures.append(f"a carry slice of the split over {n} entries left its entry's device")
        del carry, state
    base_ms.append(chunk_ms(unsharded))
    print(f"[18] unsharded StreamBatch B={b} T={t}: {base_ms[0]:.2f} ms a chunk before the splits, "
          f"{base_ms[1]:.2f} ms after ({card})")
    del want, ref

    # where a split's time goes on one card: one shard's chunk, K1 and K2
    # alone at the shard's batch, each times the shard count
    carry0 = nt.init_batch_carry(engine.model.meta, b, dev)
    pre, _ = precompute_chunk(carry0.feat.input_mem, carry0.feat.hp_mem, chunk(0))
    filt, _ = biquad_filter_frames(chunk(0), carry0.feat.hp_mem, tuple(BIQUAD_HP_A), tuple(BIQUAD_HP_B))
    ds, w0 = decimate(torch.cat([carry0.feat.input_mem, filt.reshape(b, -1)], 1), t)
    arrays = fk.carry_arrays(carry0)
    for n in (1, *MESH_SHARDS):
        s = b // n
        shard = _map_leaves(lambda x: x[:s].contiguous(), carry0)
        one = chunk(0)[:s].contiguous()
        args1 = (ds[:s].contiguous(), w0[:, :s].contiguous(), t)
        args2 = (engine.rnn, engine.rnn_weights, tuple(a[:s].contiguous() for a in arrays),
                 pre.filtered[:, :s].contiguous(), pre.cand[:, :s].contiguous())
        shard_ms = cuda_ms(torch, lambda: nt.denoise.process_chunk(engine, shard, one), TIMED_CHUNKS)
        k1 = cuda_ms(torch, lambda: pk.pitch_analysis_cuda(*args1), TIMED_CHUNKS)
        k2 = cuda_ms(torch, lambda: fk.frame_loop_cuda(*args2), TIMED_CHUNKS)
        print(f"[18] a shard of B={s}: chunk {shard_ms:.2f} ms, K1 {k1:.2f} ms, K2 {k2:.2f} ms; x {n} shards: "
              f"{n * shard_ms:.2f}, {n * k1:.2f}, {n * k2:.2f} ms ({card})")
        del shard, one, args1, args2
    del carry0, pre, filt, ds, w0, arrays

    # ---- data-parallel fit over a 1-rank NCCL mesh, one graph replay a step ----
    arrays = trained["arrays"]
    on_dev = {k: torch.as_tensor(v, device=dev) for k, v in arrays.items()}
    seq_w = torch.as_tensor(compute_sample_weights(arrays["gains"]), device=dev)
    step_idx = [idx.to(dev) for idx in trained["step_idx"]]
    reduces = []  # each all_reduce call: was the current stream being captured?
    real_all_reduce = dist.all_reduce

    def counted_all_reduce(*args, **kwargs):
        reduces.append(torch.cuda.is_current_stream_capturing())
        return real_all_reduce(*args, **kwargs)

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        dist.all_reduce = counted_all_reduce
        try:
            mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("dp",))
            dp, history, prog, fit_ms = kept_fit(torch, arrays, epochs=TRAIN_STEPS, mesh=mesh, **trained["fit_kw"])
            tp = prog.program
            fit_calls = (tp.warmups, tp.replays)
            fit_reduces = (reduces.count(False), reduces.count(True))
            one = trained["fit_params"]
            rel = max(float(np.abs(dp[layer][k] - w).max() / max(float(np.abs(w).max()), 1e-30))
                      for layer, leaves in one.items() for k, w in leaves.items())
            bit = all(np.array_equal(dp[layer][k], w) for layer, leaves in one.items() for k, w in leaves.items())
            same_losses = history == trained["fit_history"]
            print(f"[18] fit at batch {TRAIN_BATCH} x {TRAIN_WINDOW} over a 1-rank NCCL DeviceMesh, {len(history)} "
                  f"steps: one TrainProgram, (warm-up steps, replays) {fit_calls}, all_reduce calls (eager, "
                  f"captured) {fit_reduces}; warm-up step {tp.warmup_s:.2f} s, capture and instantiation "
                  f"{tp.capture_s:.2f} s (torch.cuda.graph's default mode, global), pool "
                  f"{tp.pool_bytes / 2 ** 20:.1f} MiB; {fit_ms:.1f} ms a step of fit's wall (CUDA events around fit: "
                  f"init, upload, the capture and readback included, not a step time); against phase 17's fit with "
                  f"mesh=None: parameters max |d| over the leaf's max {rel:.3g} (bar {DP_BAR:g}), bit-equal {bit}, "
                  f"losses equal {same_losses} ({card})")
            if fit_calls != (1, TRAIN_STEPS) or fit_reduces != (1, 1):
                failures.append(f"fit over the mesh did not run one replay a step with the all-reduce captured: "
                                f"{fit_calls}, {fit_reduces}")
            if not rel <= DP_BAR:
                failures.append("fit over the 1-rank mesh parts from fit with mesh=None")

            model_e = init_train_params(torch.Generator().manual_seed(trained["fit_kw"]["seed"])).to(dev)
            opt_e = make_optimizer(model_e)
            del reduces[:]
            r = replays_against_eager(torch, prog, model_e,
                                      lambda idx: train_step_dp(model_e, opt_e, on_dev, idx, seq_w, mesh), step_idx)
            replay_reduces = len(reduces) - len(step_idx)  # all_reduce calls beyond the eager steps' own
            flat = torch.zeros(sum(q.numel() for q in model_e.parameters()) + 1, device=dev)
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                real_all_reduce(flat, group=mesh.get_group())
                torch.cuda.synchronize()
            eager_nccl = sum(e.count for e in prof.key_averages()
                             if e.device_type == torch.autograd.DeviceType.CUDA and "nccl" in e.key.lower())
            print(f"[18] the data-parallel program (fit's): {GRAPH_STEPS} replays from fit's first state against "
                  f"{GRAPH_STEPS} eager train_step_dp steps from it: bit-equal {r['bit']} (losses "
                  f"{', '.join(f'{float(l):.6f}' for l in r['losses'])}); {r['replay_ms']:.1f} ms a step over "
                  f"{TRAIN_STEPS} replays (CUDA events), eager data-parallel steps "
                  f"{', '.join(f'{m:.1f}' for m in r['eager_ms'])} ms; phase 17's one-device program "
                  f"{trained['replay_ms']:.1f} ms a replay, its eager steps "
                  f"{', '.join(f'{m:.1f}' for m in trained['eager_ms'])} ms; all_reduce calls from the host at the "
                  f"{GRAPH_STEPS + TRAIN_STEPS + 1} replays {replay_reduces}; one replay by torch.profiler: host "
                  f"launches {sum(r['host'].values())} {r['host']}, device operations {r['dev_ops'] or 'not traced'}, "
                  f"{r['nccl']} named nccl (an eager all_reduce of the {flat.numel()} floats on this 1-rank group: "
                  f"{eager_nccl}), device busy {r['busy']:.1f} ms; profiled in {r['profile_s']:.1f} s ({card})")
            if not r["bit"]:
                failures.append("the data-parallel program's replays are not bit-equal to eager train_step_dp steps")
            if replay_reduces:
                failures.append("a replay of the data-parallel program called all_reduce from the host")
            if sum(r["host"].values()) > DP_LAUNCH_BAR or not r["dev_ops"]:
                failures.append(f"a replay of the data-parallel program issued {sum(r['host'].values())} host "
                                f"launches (at most {DP_LAUNCH_BAR}) or no traced device operation")
            del prog, tp, model_e, opt_e, r, flat
            torch.cuda.synchronize()
        finally:
            dist.all_reduce = real_all_reduce
            dist.destroy_process_group()
    if failures:
        raise RuntimeError("phase 18: " + "; ".join(failures))


def per_frame_phase(torch, dev, card: str, clip_frames, ref, reset_counts, counts) -> dict:
    """Phase 8, the per-frame path (see the module docstring): the golden
    clip's frames ``clip_frames`` (T, 480) and the reference output
    ``ref``.  Returns the launches of the process_frame run.  Raises on a
    failed bar."""
    import nnnoiseless_tpu_torch as nt

    t5 = len(clip_frames)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    state = nt.DenoiseState(device=dev)
    reset_counts()
    out8 = np.stack([np.concatenate([state.process_frame(f)[0] for f in clip_frames])])
    torch.cuda.synchronize()
    counts8 = counts()
    prog8 = state.program.program
    worst_rel, worst_max = golden_worst(out8, ref)
    eager8, eager_ms = eager_frames(torch, state.engine, dev, clip_frames, LATENCY_PASSES + 1)
    bit8 = np.array_equal(out8[0], eager8.reshape(-1))
    print(f"[8] per-frame golden T={t5}: rel {worst_rel:.3g}, max per-sample {worst_max:.0f}; the graph "
          f"against the eager frame_step loop on the card: bit-equal {bit8}, max |d| "
          f"{float(np.abs(out8[0] - eager8.reshape(-1)).max()):.3g}; {prog8.replays} replays for {t5} calls, "
          f"{prog8.warmups} warm-up step, kernels captured {prog8.captured}, launches {counts8}; the "
          f"state's graph pool {prog8.pool_bytes / 2 ** 20:.1f} MiB")
    if not (worst_rel < 1e-4 and worst_max <= 2):
        raise RuntimeError("golden bars failed through DenoiseState.process_frame")
    if not bit8:
        raise RuntimeError("the graphed process_frame is not bit-equal to the eager frame_step loop")
    runs8 = prog8.replays + prog8.warmups
    if (prog8.replays != t5 or prog8.captured != {"K3": 1, "K5": 1, "K6": 1}
            or any(counts8[k] != runs8 for k in ("K3", "K5", "K6")) or counts8["K1"] or counts8["K2"]):
        raise RuntimeError("the per-frame path did not replay one graph a call with K3, K5 and K6 once each")
    call_ms = []
    for _ in range(LATENCY_PASSES):
        state.reset()
        for f in clip_frames:
            t0 = time.perf_counter()
            state.process_frame(f)
            call_ms.append((time.perf_counter() - t0) * 1e3)
    start.record()
    for _ in range(t5):
        prog8.graph.replay()
    end.record()
    end.synchronize()
    replay8_ms = start.elapsed_time(end) / t5
    for name, ms in (("graphed", call_ms), ("eager loop", eager_ms[t5:])):
        p50, p99 = np.percentile(ms, [50, 99])
        print(f"[8] process_frame latency, {name}, over {len(ms)} calls: median {p50:.3f} ms, p99 {p99:.3f} ms, "
              f"max {max(ms):.3f} ms, over 10 ms {np.mean(np.array(ms) > 10.0):.2%} ({card})")
    print(f"[8] one replay on the device (CUDA events over {t5} back-to-back replays): {replay8_ms:.4f} ms ({card})")
    calls = clip_frames[:PROFILED_CALLS]
    for name, run in (("graphed", lambda: [state.process_frame(f) for f in calls]),
                      ("eager loop", lambda: eager_frames(torch, state.engine, dev, calls, 1))):
        host, n_host, n_dev, busy = profile_run(torch, run, len(calls))
        print(f"[8] a call, {name} (torch.profiler over {len(calls)} calls): host launches {n_host:.2f} "
              f"{host}, device operations {n_dev:.1f}, device busy {busy:.4f} ms ({card})")
    return counts8


def scan_phase(torch, dev, card: str, engine, big, chunk_ms: float, reset_counts, counts) -> dict:
    """Phase 9, the scan engine at full width (see the module docstring):
    ``big`` phase 6's input on the card, ``chunk_ms`` phase 6's two-phase
    chunk.  Returns the launches of the timed chunk.  Raises on a failed
    bar."""
    import nnnoiseless_tpu_torch as nt
    from nnnoiseless_tpu_torch.chunk import precompute_chunk
    from nnnoiseless_tpu_torch.ops import frame_kernel as fk

    b6, t6 = REAL_SHAPE
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    scan_engine = nt.Engine(engine.model, dev, fused=False)
    batch9 = nt.StreamBatch(b6, scan_engine, device=dev)
    reset_counts()
    batch9.process_tensor(big[:, :t6])  # warm-up chunk: captures the step graph
    torch.cuda.synchronize()
    prog9 = scan_engine.scan_program(b6).program
    chunk9 = big[:, t6 : 2 * t6]
    reset_counts()
    start.record()
    _, out9, vad9, (per9, _) = nt.scan_chunk(scan_engine, batch9.carry, chunk9, return_trace=True)
    end.record()
    end.synchronize()
    counts9 = counts()
    scan_ms = start.elapsed_time(end)
    start.record()
    out9e, vad9e, per9e = eager_scan(torch, scan_engine, batch9.carry, chunk9)
    end.record()
    end.synchronize()
    eager9_ms = start.elapsed_time(end)
    bit9 = torch.equal(out9, out9e) and torch.equal(vad9, vad9e) and torch.equal(per9, per9e)
    del out9e, vad9e, per9e
    prof9 = {name: profile_run(torch, run, t6) for name, run in (
        ("graphed", lambda: nt.scan_chunk(scan_engine, batch9.carry, chunk9)),
        ("eager", lambda: eager_scan(torch, scan_engine, batch9.carry, chunk9)))}
    pre_ms = cuda_ms(torch, lambda: precompute_chunk(batch9.carry.feat.input_mem, batch9.carry.feat.hp_mem,
                                                     chunk9, lag0=True), 3)
    start.record()
    for _ in range(t6):
        prog9.graph.replay()
    end.record()
    end.synchronize()
    replay9_ms = start.elapsed_time(end) / t6
    print(f"[9] scan engine B={b6} T={t6}: graphed {scan_ms:.2f} ms/chunk, the eager frame loop {eager9_ms:.2f} "
          f"ms/chunk (two-phase {chunk_ms:.2f} ms); graphed against eager: bit-equal {bit9}; step graph "
          f"{prog9.replays} replays, kernels captured {prog9.captured}, pool {prog9.pool_bytes / 2 ** 20:.1f} MiB; "
          f"launches {counts9} ({card})")
    for name, (host, n_host, n_dev, busy) in prof9.items():
        print(f"[9] a frame, {name} (torch.profiler over a chunk of T={t6}): host launches {n_host:.2f} "
              f"{host}, device operations {n_dev:.1f}, device busy {busy:.4f} ms ({card})")
    print(f"[9] the lag-0 precompute {pre_ms:.3f} ms a chunk, one replay of the step {replay9_ms:.4f} ms "
          f"(CUDA events over {t6} back-to-back replays) ({card})")
    if not bit9:
        raise RuntimeError("the graphed scan engine is not bit-equal to the eager frame loop")
    if (counts9["K1"] != 1 or counts9["K2"] or counts9["K5"] != t6 or counts9["K6"] != t6
            or prog9.captured != {"K5": 1, "K6": 1}):
        raise RuntimeError("the scan engine did not launch K1 once and K5, K6 once a frame, without K2")
    host, n_host, _, _ = prof9["graphed"]
    if not host.get("cudaGraphLaunch", 0) >= t6 or n_host > SCAN_LAUNCH_BAR:
        raise RuntimeError(f"the graphed scan engine issued {n_host:.2f} host launches a frame "
                           f"(at most {SCAN_LAUNCH_BAR})")
    pre9, _ = precompute_chunk(batch9.carry.feat.input_mem, batch9.carry.feat.hp_mem, chunk9)
    packed_pl, _ = fk.frame_loop_plain(engine.rnn, fk.carry_arrays(batch9.carry), pre9.filtered, pre9.cand)
    out_pl = packed_pl[..., :FRAME].transpose(0, 1)
    per_pl = packed_pl[..., fk.OFF_PERIOD].transpose(0, 1).to(torch.int32)
    _, out_k2, _, (per_k2, _) = fk.run_frame_loop(engine.rnn, batch9.carry, pre9, engine.rnn_weights,
                                                  return_trace=True)
    ok, msg = waveform_bars(torch, out9, out_pl, per9, per_pl)
    print(f"[9] scan engine against the two-phase engine with K2's plain version: {msg}")
    if not ok or not bool(torch.isfinite(out9).all()):
        raise RuntimeError("the scan engine disagrees with the two-phase engine")
    ok, msg, outliers = k2_full_bars(torch, out_k2, out_pl, per_k2, per_pl)
    print(f"[9] K2 against its plain version B={b6} T={t6}: {msg}")
    if outliers:
        idx = torch.tensor([s for s, _, _ in outliers], device=dev)
        margins = comb_margins(torch, fk, engine.rnn, tuple(a[idx] for a in fk.carry_arrays(batch9.carry)),
                               pre9.filtered[:, idx].contiguous(), pre9.cand[:, idx].contiguous())
        for j, (s, worst, t_w) in enumerate(outliers):
            near = margins[max(t_w - 1, 0) : t_w + 1, j]
            print(f"[9]   stream {s}: max {worst:.3g} at frame {t_w}; the comb filter's e > g test, "
                  f"smallest |e - g| over the bands at frames {max(t_w - 1, 0)}..{t_w}: "
                  f"{float(near.min()):.3g} (over the chunk: median {float(margins[:, j].median()):.3g})")
    if not ok:
        raise RuntimeError("K2 disagrees with its plain version at the main path's shape")
    return counts9


def gru_sequence_phase(torch, dev, card: str, step_launches: dict | None = None) -> list:
    """Phase 19, kernel K7 (see the module docstring): the three GRUs of
    the 2018 network at train-32x2000's shape, each layer's forward and
    backward launch against the plain loops on the card and timed cold,
    beside the plain loops' time and the bound.  ``step_launches``: phase
    17's captured train step's K7 launches by direction, which the rows
    carry as their main-path launches (None when run alone).  Raises on a
    failed bar; returns the six launches' rows for the kernels line."""
    from nnnoiseless_tpu_torch.ops import gru_seq as G
    from nnnoiseless_tpu_torch.training.network import DEFAULT_META, init_train_params

    b, t = GRU_SHAPE
    model = init_train_params(torch.Generator().manual_seed(19)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(19)
    rows, failures = [], []
    for name in ("vad_gru", "noise_gru", "denoise_gru"):
        m, layer = getattr(DEFAULT_META, name), getattr(model, name)
        n, code = m.nb_neurons, m.activation
        with torch.no_grad():
            x = torch.randn(b, t, m.nb_inputs, generator=gen, device=dev)
            xw = (x @ layer["wi"] + layer["b"]).contiguous()
            wr = layer["wr"].detach().contiguous()
            dh = 0.01 * torch.randn(b, t, n, generator=gen, device=dev)
            # each direction's launches, each counted from just before its call
            before = (G.launches, G.backward_launches)
            h, gates = G.forward_cuda(xw, wr, code)
            launched = {"forward": (G.launches - before[0], G.backward_launches - before[1])}
            before = (G.launches, G.backward_launches)
            dxw = G.backward_cuda(dh, h, gates, wr, code)
            launched["backward"] = (G.launches - before[0], G.backward_launches - before[1])
            torch.cuda.synchronize()
            ph, pg = G.forward_plain(xw, wr, code)
            pdxw = G.backward_plain(dh, ph, pg, wr, code)
            h_err = max(float((h - ph).abs().max()), float((gates - pg).abs().max()))
            g_abs = float((dxw - pdxw).abs().max())
            g_rel = g_abs / float(pdxw.abs().max())
            fwd_ms = cold_ms(torch, lambda a, w: G.forward_cuda(a, w, code), (xw, wr), GRU_REPS)
            bwd_ms = cold_ms(torch, lambda d, hh, g, w: G.backward_cuda(d, hh, g, w, code), (dh, h, gates, wr),
                             GRU_REPS)
            plain_fwd = cuda_ms(torch, lambda: G.forward_plain(xw, wr, code))
            plain_bwd = cuda_ms(torch, lambda: G.backward_plain(dh, h, gates, wr, code))
        macs = 3 * n * n * b * t  # the recurrent products, either way
        for way, ms, plain_ms, abs_err, rel_err, n_bytes in (
            ("forward", fwd_ms, plain_fwd, h_err, None, 4 * (7 * n * b * t + 3 * n * n)),
            ("backward", bwd_ms, plain_bwd, g_abs, g_rel, 4 * (8 * n * b * t + 3 * n * n)),
        ):
            b_ms, b_by = bound(n_bytes, 2 * macs)
            # launches: the captured train step's of this direction (its three
            # layers, one each); here: this phase's (K7, K7 backward) deltas
            rows.append({"name": f"K7 {way} {name}", "route": "cuda",
                         "source": "nnnoiseless_tpu_torch/csrc/gru_seq_kernel.cu", "replaces": None,
                         "launches": step_launches and step_launches[way], "launches_here": launched[way],
                         "max_abs_err": abs_err, "max_rel_err": rel_err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                         "latency_bound": f"{t} frames x 2 dependent mat-vecs of {n}"})
            err = f"max abs {abs_err:.3g}" + ("" if rel_err is None else f", over the largest {rel_err:.3g}")
            print(f"[19] K7 {way} {name} (n={n}, B={b}, T={t}): {ms:.3f} ms cold ({ms / t * 1e3:.3f} us a frame), "
                  f"plain loop {plain_ms:.1f} ms; roofline bound {b_ms:.4f} ms by {b_by}, bound by latency: "
                  f"{t} x 2 dependent mat-vecs, wr's {12 * n * n} bytes read once; against the plain loop "
                  f"{err}; launches (K7, K7 backward) {launched[way]}, in the train step "
                  f"{step_launches and step_launches[way]} ({card})")
        if launched != {"forward": (1, 0), "backward": (1, 1)}:
            failures.append(f"{name}: launches (K7, K7 backward) {launched} for one forward and one backward")
        if not (h_err <= GRU_H_BAR and g_rel <= GRU_GRAD_BAR):
            failures.append(f"{name}: the kernels miss the plain loops' bars")
    if failures:
        raise RuntimeError("phase 19: " + "; ".join(failures))
    return rows


def rn02_step_launches(torch, dev) -> dict:
    """K8's launches by direction in the RNNoise 0.2 train step captured at
    rn02-train-128x2000's shape: the recipe's widths, a batch of 128
    sequences of 2,000 frames."""
    from nnnoiseless_tpu_torch.programs import TrainProgram
    from nnnoiseless_tpu_torch.training import rn02
    from nnnoiseless_tpu_torch.training import train as TT

    b, frames = RN02_GRU_SHAPE[0], RN02_GRU_SHAPE[1] + 4  # the two convolutions take 4 frames
    meta = rn02.RN02_META
    model = rn02.init_params(torch.Generator().manual_seed(20), meta).to(dev)
    opt = TT.make_adamw(model, 1e-3, 0.2)
    gen = torch.Generator(device=dev).manual_seed(20)
    data = {"features": torch.randn((b, frames, meta.input_dim), generator=gen, device=dev),
            "gains": torch.rand((b, frames, meta.output_dim), generator=gen, device=dev),
            "vad": (torch.rand((b, frames, 1), generator=gen, device=dev) < 0.5).float()}
    prog = TrainProgram(lambda idx: TT.train_step_indexed(model, opt, data, idx, None), model, opt, b)
    prog(torch.arange(b, device=dev))
    torch.cuda.synchronize()
    captured = prog.program.captured
    step = {"backward": captured.get("K8 backward", 0)}
    step["forward"] = captured.get("K8", 0) - step["backward"]
    print(f"[20] the rn02 train step captured at B={b}, {frames} frames, n={meta.gru_size}: launches {captured}; "
          f"K8 forward {step['forward']}, backward {step['backward']} (3 and 3)")
    del prog, model, opt, data
    torch.cuda.empty_cache()
    return step


def plain_gru_ms(torch, layer, xw, dh) -> dict:
    """Device ms on the card of the plain path K8 replaced: rn02's loop of
    ``gru_step`` over the frames of ``xw`` with autograd recording, and
    autograd's backward of it from ``dh`` to XW, W_hh and b_hh; each one
    call after a warm-up."""
    from nnnoiseless_tpu_torch.training import rn02

    leaves = {k: layer[k].detach().clone().requires_grad_() for k in ("weight_hh_l0", "bias_hh_l0")}
    xx = xw.detach().clone().requires_grad_()

    def forward():
        h = xx.new_zeros((xx.shape[0], xx.shape[2] // 3))
        hs = []
        for x in xx.unbind(1):
            h = rn02.gru_step(leaves, x, h)
            hs.append(h)
        return torch.stack(hs, 1)

    with torch.enable_grad():
        fwd = cuda_ms(torch, forward)
        out = forward()
        bwd = cuda_ms(torch, lambda: torch.autograd.grad(out, [xx, *leaves.values()], dh, retain_graph=True))
    return {"forward": fwd, "backward": bwd}


def library_gru_ms(torch, layer, x, dh) -> dict:
    """Device ms of ``torch.nn.GRU`` (cuDNN, TF32 off) on the same layer:
    its forward, the whole layer with its input product, and its backward
    from ``dh``, each the mean of GRU_REPS calls after a warm-up.  The
    port never calls it: a yardstick beside K8's launches."""
    n = x.shape[2]
    gru = torch.nn.GRU(n, n, batch_first=True).to(x.device)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            gru.load_state_dict({k: v.detach() for k, v in layer.items()})
        xx = x.detach().clone().requires_grad_()
        fwd = cuda_ms(torch, lambda: gru(xx), GRU_REPS)
        out = gru(xx)[0]
        bwd = cuda_ms(torch, lambda: torch.autograd.grad(out, [xx, *gru.parameters()], dh, retain_graph=True),
                      GRU_REPS)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return {"forward": fwd, "backward": bwd}


def rn02_gru_phase(torch, dev, card: str) -> list:
    """Phase 20, kernel K8 (see the module docstring): RNNoise 0.2's three
    GRUs at rn02-train-128x2000's shape, each layer's forward and backward
    launch against the plain loops on the host's CPU and timed cold on the
    card, beside the plain path's time on the card and the bound; the
    layout the card seats; the launches of the rn02 step captured at the
    cell's shape.  Raises on a failed bar; returns the six launches' rows
    for the kernels line."""
    import torch.nn.functional as F

    from nnnoiseless_tpu_torch.ops import gru_reset_after as G
    from nnnoiseless_tpu_torch.training import rn02

    step_launches = rn02_step_launches(torch, dev)
    b, t, n = RN02_GRU_SHAPE
    model = rn02.init_params(torch.Generator().manual_seed(20)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(20)
    x = torch.tanh(torch.randn(b, t, n, generator=gen, device=dev))  # as the second convolution's output
    rows, failures = [], []
    for name in rn02.GRUS:
        layer = getattr(model, name)
        with torch.no_grad():
            xw = F.linear(x, layer["weight_ih_l0"], layer["bias_ih_l0"]).contiguous()
            w, bh = layer["weight_hh_l0"].detach(), layer["bias_hh_l0"].detach()
            dh = 1e-3 * torch.randn(b, t, n, generator=gen, device=dev)
            # each direction's launches, each counted from just before its call
            before = (G.launches, G.backward_launches)
            h, gates = G.forward_cuda(xw, w, bh)
            launched = {"forward": (G.launches - before[0], G.backward_launches - before[1])}
            plans = {"forward": dict(G.last_plan)}
            before = (G.launches, G.backward_launches)
            dxw, dhw = G.backward_cuda(dh, h, gates, w)
            launched["backward"] = (G.launches - before[0], G.backward_launches - before[1])
            plans["backward"] = dict(G.last_plan)
            got = [a.cpu() for a in (h, gates, dxw, dhw, *G._weight_grads(dhw, h))]
            c_xw, c_w, c_bh, c_dh = (a.cpu() for a in (xw, w, bh, dh))
            ph, pg = G.forward_plain(c_xw, c_w, c_bh)
            pdxw, pdhw = G.backward_plain(c_dh, ph, pg, c_w)
            want = (ph, pg, pdxw, pdhw, *G._weight_grads(pdhw, ph))
            h_err = max(float((a - w_).abs().max()) for a, w_ in zip(got[:2], want[:2]))
            g_abs = max(float((a - w_).abs().max()) for a, w_ in zip(got[2:], want[2:]))
            g_rel = max(float((a - w_).abs().max()) / float(w_.abs().max()) for a, w_ in zip(got[2:], want[2:]))
            fwd_ms = cold_ms(torch, lambda a, ww, bb: G.forward_cuda(a, ww, bb), (xw, w, bh), GRU_REPS)
            bwd_ms = cold_ms(torch, lambda d, hh, g, ww: G.backward_cuda(d, hh, g, ww), (dh, h, gates, w),
                             GRU_REPS)
        lib_ms = library_gru_ms(torch, layer, x, dh)
        plain_ms = plain_gru_ms(torch, layer, xw, dh)
        macs = 3 * n * n * b * t  # the recurrent products, either way
        for way, ms, abs_err, rel_err, n_bytes in (
            ("forward", fwd_ms, h_err, None, 4 * (8 * n * b * t + 3 * n * n + 3 * n)),
            ("backward", bwd_ms, g_abs, g_rel, 4 * (12 * n * b * t + 3 * n * n)),
        ):
            b_ms, b_by = bound(n_bytes, 2 * macs)
            plan = plans[way]
            rows.append({"name": f"K8 {way} {name}", "route": "cuda",
                         "source": "nnnoiseless_tpu_torch/csrc/gru_ra_kernel.cu", "replaces": None,
                         "launches": step_launches[way], "launches_here": launched[way],
                         "max_abs_err": abs_err, "max_rel_err": rel_err, "ms": ms, "plain_ms": plain_ms[way],
                         "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms[way],
                         "library": "torch.nn.GRU (cuDNN, TF32 off), the whole layer with its input product",
                         "plan": plan, "latency_bound": f"{t} dependent frames of {b} x {3 * n} x {n} MACs"})
            err = f"max abs {abs_err:.3g}" + ("" if rel_err is None else f", over the largest {rel_err:.3g}")
            print(f"[20] K8 {way} {name} (n={n}, B={b}, T={t}): {ms:.3f} ms cold ({ms / t * 1e3:.3f} us a frame), "
                  f"bound {b_ms:.3f} ms by {b_by} ({b_ms / ms:.1%}); plain gru_step path on the card "
                  f"{plain_ms[way]:.1f} ms; torch.nn.GRU (cuDNN, the whole layer) {lib_ms[way]:.3f} ms; "
                  f"against the plain loops on the host's CPU {err}; clusters seated at once {plan['seated']}, {plan['sequences']} sequences "
                  f"a cluster, {plan['clusters']} launched; launches (K8, K8 backward) {launched[way]}, in the "
                  f"train step {step_launches[way]} ({card})")
        if launched != {"forward": (1, 0), "backward": (1, 1)}:
            failures.append(f"{name}: launches (K8, K8 backward) {launched} for one forward and one backward")
        if not (h_err <= GRU_H_BAR and g_rel <= GRU_GRAD_BAR):
            failures.append(f"{name}: the kernels miss the plain loops' bars")
        x = h  # the next layer reads these states
    if step_launches != {"forward": 3, "backward": 3}:
        failures.append(f"the rn02 train step did not capture 3 forward and 3 backward K8 launches: {step_launches}")
    if failures:
        raise RuntimeError("phase 20: " + "; ".join(failures))
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import nnnoiseless_tpu_torch as nt
    from nnnoiseless_tpu_torch import _build
    from nnnoiseless_tpu_torch.chunk import decimate, precompute_chunk
    from nnnoiseless_tpu_torch.ops.counters import COUNTERS, launch_counts
    from nnnoiseless_tpu_torch.ops import fft
    from nnnoiseless_tpu_torch.ops import frame_kernel as fk
    from nnnoiseless_tpu_torch.ops import pitch_kernel as pk
    from nnnoiseless_tpu_torch.ops import rnn_kernel as rk
    from nnnoiseless_tpu_torch.ops import window as wk
    from nnnoiseless_tpu_torch.ops.biquad import biquad_filter_frames
    from nnnoiseless_tpu_torch import cli
    from nnnoiseless_tpu_torch.ops.pitch import (
        doubling_tables, downsample_2x, pitch_chain, pitch_search, sliding_dot, whiten, window_energies,
    )
    from nnnoiseless_tpu_torch.tools import attrib
    from nnnoiseless_tpu_torch.tools.profile import sine_bench
    from nnnoiseless_tpu_torch.tools.trace import pitch_trace, pitch_trace_native
    from nnnoiseless_tpu_torch.ops.rnn import RnnState
    from nnnoiseless_tpu_torch.tables import BAND_CORR_MATRIX, BIQUAD_HP_A, BIQUAD_HP_B, VORBIS_WINDOW, WNORM

    def reset_counts():
        for mod, attr in COUNTERS.values():
            setattr(mod, attr, 0)

    counts = launch_counts

    dev = torch.device(DEVICE)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    def at(n):
        print(f"[{n}] starts {time.perf_counter() - t_start:.1f} s into the run")

    # ---- 1. environment ------------------------------------------------------
    print(f"[1] card: {card}")
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 must be off")
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True, check=True)
    print(f"[1] make: {shutil.which('make')}; {gxx.stdout.splitlines()[0]} (the native engine's build)")

    # ---- 2. build --------------------------------------------------------------
    at(2)
    t0 = time.perf_counter()
    _build.library()
    print(f"[2] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.last_build_seconds:.1f} s)")
    for line in _build.last_build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("[2]   " + line.strip())

    engine = nt.Engine(nt.RnnModel.default(), dev)

    # ---- 3. K1 against its plain version --------------------------------------
    at(3)
    b3, t3 = K1_SHAPE
    frames = torch.as_tensor(test_frames(b3, t3, seed=3), device=dev)
    carry = nt.init_batch_carry(engine.model.meta, b3, dev)
    filtered, _ = biquad_filter_frames(frames, carry.feat.hp_mem, tuple(BIQUAD_HP_A), tuple(BIQUAD_HP_B))
    full = torch.cat([carry.feat.input_mem, filtered.reshape(b3, -1)], 1)
    ds, w0 = decimate(full, t3)
    ok, _, msg = pitch_bars(torch, pk.pitch_analysis_cuda(ds, w0, t3), pk.pitch_analysis_plain(ds, w0, t3))
    print(f"[3] K1 B={b3} T={t3}: {msg}")
    if not ok:
        raise RuntimeError("K1 disagrees with the plain version")

    # ---- 4. K2 against its plain version --------------------------------------
    at(4)
    b4 = K2_BATCH
    pre, _ = precompute_chunk(carry.feat.input_mem[:b4], carry.feat.hp_mem[:b4], frames[:b4])
    c4 = fk.carry_arrays(nt.init_batch_carry(engine.model.meta, b4, dev))
    packed_p, carry_p = fk.frame_loop_plain(engine.rnn, c4, pre.filtered, pre.cand)
    packed_k, carry_k = fk.frame_loop_cuda(engine.rnn, engine.rnn_weights, c4, pre.filtered, pre.cand)
    torch.cuda.synchronize()
    want = packed_p[..., :FRAME].double()
    d = (packed_k[..., :FRAME].double() - want).abs()
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
    at(5)
    clip = np.fromfile(DATA / "testing.raw", "<i2").astype(np.float32)
    ref = np.fromfile(DATA / "reference_output.raw", "<i2").astype(np.float64)
    t5 = len(clip) // FRAME
    g_frames = np.broadcast_to(clip[: t5 * FRAME].reshape(1, t5, FRAME), (GOLDEN_BATCH, t5, FRAME))
    reset_counts()
    _, out5, _ = nt.process_frames(engine, nt.init_batch_carry(engine.model.meta, GOLDEN_BATCH, dev),
                                   np.ascontiguousarray(g_frames))
    torch.cuda.synchronize()
    counts5 = (pk.launches, fk.launches)
    worst_rel, worst_max = golden_worst(out5.cpu().numpy().reshape(GOLDEN_BATCH, -1), ref)
    print(f"[5] golden B={GOLDEN_BATCH} T={t5}: worst stream rel {worst_rel:.3g}, max per-sample "
          f"{worst_max:.0f}; launches K1 {counts5[0]}, K2 {counts5[1]}")
    if not (worst_rel < 1e-4 and worst_max <= 2):
        raise RuntimeError("golden bars failed through the engine")
    if min(counts5) == 0:
        raise RuntimeError("the engine did not launch both kernels")

    # ---- 6. real size ------------------------------------------------------------
    at(6)
    b6, t6 = REAL_SHAPE
    big = torch.as_tensor(test_frames(b6, t6 * (TIMED_CHUNKS + 1), seed=6), device=dev)
    batch = nt.StreamBatch(b6, engine, device=dev)
    reset_counts()
    batch.process_tensor(big[:, :t6])  # warm-up chunk
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    outs = [batch.process_tensor(big[:, (c + 1) * t6 : (c + 2) * t6])[0] for c in range(TIMED_CHUNKS)]
    end.record()
    end.synchronize()
    counts6 = (pk.launches, fk.launches, fft.launches)
    chunk_ms = start.elapsed_time(end) / TIMED_CHUNKS
    for o in outs:
        if o.shape != (b6, t6, FRAME) or not bool(torch.isfinite(o).all()):
            raise RuntimeError("real-size output is not finite or has the wrong shape")
    if min(counts6[:2]) == 0:
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
    k2_kern = lambda: fk.frame_loop_cuda(engine.rnn, engine.rnn_weights, ca6, pre6.filtered, pre6.cand)
    times = {}
    for name, plain, kern in (("k1", k1_plain, k1_kern), ("k2", k2_plain, k2_kern)):
        p1 = cuda_ms(torch, plain)
        k_1 = cuda_ms(torch, kern, 2)
        k_2 = cuda_ms(torch, kern, 2)
        p2 = cuda_ms(torch, plain)
        times[name] = ((k_1 + k_2) / 2, (p1 + p2) / 2)
        print(f"[6] {name} at B={b6} T={t6}: kernel {times[name][0]:.2f} ms, "
              f"plain {times[name][1]:.2f} ms ({card})")

    ok, k1_err, msg = pitch_bars(torch, k1_kern(), k1_plain(), windows=raw_windows(torch, ds6, w06))
    print(f"[6] K1 against its plain version at B={b6} T={t6}: {msg}")
    if not ok:
        raise RuntimeError("K1 disagrees with its plain version at the main path's shape")

    # the eager two-phase chunk (the precompute's plain ops, K1, K2): what the
    # host issues and how much of the chunk's wall time the device is busy
    for b in (b6, SMALL_CHUNK_BATCH):
        carry_b = nt.init_batch_carry(engine.model.meta, b, dev)
        frames_b = big[:b, :t6].contiguous()
        run = lambda: nt.denoise.process_chunk(engine, carry_b, frames_b)
        run()
        torch.cuda.synchronize()
        walls = []
        for _ in range(WALL_CHUNKS):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall_ms = sum(walls) / len(walls)
        host, n_host, n_dev, busy = profile_run(torch, run, 1)
        print(f"[6] one eager two-phase chunk at B={b} T={t6}: {wall_ms:.3f} ms wall (host clock to the sync, "
              f"mean of {WALL_CHUNKS}; least {min(walls):.3f}); by torch.profiler: host launches {n_host:.0f} "
              f"{host}, device operations {n_dev:.0f}, device busy {busy:.3f} ms, {busy / wall_ms:.1%} of the "
              f"mean wall, {busy / min(walls):.1%} of the least ({card})")
        if not n_dev:
            raise RuntimeError("torch.profiler saw no device operation in the two-phase chunk")
        del carry_b, frames_b

    # ---- 7. K3, K5 and K6 against their plain versions ---------------------------
    at(7)
    # K3 windows: each stream's decimated input history at frame 50 of the
    # phase-6 input (full[:, 480 (t + 1):][:1728]), as the per-frame path
    # hands them over
    hist = torch.cat([carry6.feat.input_mem, filt6.reshape(b6, -1)], 1)[:, 51 * FRAME : 51 * FRAME + 1728]
    wins = downsample_2x(hist)
    rng = np.random.RandomState(7)
    rnn_in = tuple(
        torch.as_tensor((rng.randn(b6, n) * sc).astype(np.float32), device=dev)
        for n, sc in ((24, 0.5), (48, 0.5), (96, 0.5), (42, 2.0))
    )
    rnn_in = (*rnn_in[:1], rnn_in[1].clamp(min=0), *rnn_in[2:])
    mem7 = torch.as_tensor((rng.randn(b6, 1728) * 1000).astype(np.float32), device=dev)
    lag7 = torch.as_tensor(rng.randint(0, 769, size=b6).astype(np.int32), device=dev)
    lag7[:2] = torch.tensor([0, 768], dtype=torch.int32)

    def k3_check(kern, plain):
        return pitch_bars(torch, kern, plain)

    def k5_check(kern, plain):
        st, gains, vad = plain
        err = max(float((a - b).abs().max()) for a, b in zip(kern, (*st, gains, vad)))
        return err <= 2e-5, err, f"max abs {err:.3g} over states, gains and vad"

    def k6_check(kern, plain):
        err = float((kern - plain).abs().max())
        return bool(torch.equal(kern, plain)), err, f"max abs {err:.3g} (bit-exact required)"

    # (inputs, kernel, plain version) of each kernel at b streams
    cases = {
        "K3": (lambda b: (wins[:b],), pk.pitch_analysis_stacked_cuda, pitch_chain),
        "K5": (lambda b: tuple(a[:b] for a in rnn_in),
               lambda *a: rk.rnn_step_cuda(engine.rnn_weights, *a),
               lambda hv, hn, hd, f: engine.rnn(RnnState(hv, hn, hd), f)),
        "K6": (lambda b: (mem7[:b], lag7[:b]), wk.window_cuda, wk.barrel_shift_window),
    }
    checks = {"K3": k3_check, "K5": k5_check, "K6": k6_check}

    results7 = {}
    for name, (inputs, kern_fn, plain_fn) in cases.items():
        for b in (b6, 1) if name == "K3" else (b6, *MID_BATCHES, 1):
            args = inputs(b)
            kern, plain = (lambda: kern_fn(*args)), (lambda: plain_fn(*args))
            ok, err, msg = checks[name](kern(), plain())
            torch.cuda.synchronize()
            reps = 20 if b == b6 else 200
            p_ms = cuda_ms(torch, plain, reps)
            call_ms = cuda_ms(torch, kern, reps)
            warm_ms = graph_ms(torch, kern, reps)
            k_ms = cold_ms(torch, kern_fn, args, reps)
            results7[name, b] = (err, k_ms, p_ms)
            before = f" (before: {BEFORE[name, b]})" if (name, b) in BEFORE else ""
            print(f"[7] {name} B={b}: {msg}; kernel on the device (CUDA graph) {k_ms:.4f} ms cold, "
                  f"{warm_ms:.4f} ms warm; {call_ms:.4f} ms a call{before}; plain {p_ms:.4f} ms ({card})")
            if not ok:
                raise RuntimeError(f"{name} disagrees with its plain version at B={b}")

    # ---- 8. the per-frame path ---------------------------------------------------
    at(8)
    counts8 = per_frame_phase(torch, dev, card, clip[: t5 * FRAME].reshape(t5, FRAME), ref, reset_counts, counts)

    # ---- 9. the scan engine at full width -------------------------------------------
    at(9)
    counts9 = scan_phase(torch, dev, card, engine, big, chunk_ms, reset_counts, counts)

    # ---- 10. a non-standard topology on the card ---------------------------------------
    at(10)
    b10, t10 = CUSTOM_SHAPE
    custom = custom_model(nt, seed=10)
    frames10 = test_frames(b10, t10, seed=10)
    reset_counts()
    c10, out10, _ = nt.process_frames(custom, nt.init_batch_carry(custom.meta, b10, dev), frames10, device=dev)
    torch.cuda.synchronize()
    counts10 = counts()
    c10c, out10c, _ = nt.process_frames(custom, nt.init_batch_carry(custom.meta, b10, "cpu"), frames10, device="cpu")
    ok, msg = waveform_bars(torch, out10.cpu(), out10c, c10.feat.pitch_period.cpu(), c10c.feat.pitch_period)
    print(f"[10] 32-neuron vad GRU, B={b10} T={t10}: against the CPU: {msg}; launches {counts10}")
    if not ok or counts10["K2"] or counts10["K5"] or min(counts10["K1"], counts10["K6"]) == 0:
        raise RuntimeError("the non-standard model was not served right by the scan engine")

    # ---- 11. K4 against its plain version -------------------------------------------
    at(11)
    wins11 = pk.window_stack(ds6, w06, t6).reshape(b6 * t6, -1)
    y11 = whiten(wins11)
    corr11 = sliding_dot(y11[:, 384:], y11, 385)
    en11 = window_energies(y11, 480, 385)
    pidx_search = (768 - pitch_search(y11, corr11, en11)).to(torch.int32)
    ctab, yytab, xx11 = (a.contiguous() for a in doubling_tables(y11, corr11, en11))
    del wins11, y11, corr11, en11
    rng11 = np.random.RandomState(11)
    pidx_draw = torch.as_tensor(rng11.randint(0, 768, size=b6 * t6).astype(np.int32), device=dev)
    k4_err = 0.0
    if any(a.data_ptr() % 32 for a in (ctab, yytab)):
        raise RuntimeError("K4's tables are not 32-byte aligned, as the sector count assumes")
    for rows in (b6 * t6, K4_SMALL):
        for label, pidx in (("search", pidx_search), ("drawn", pidx_draw)):
            args = (ctab[:rows], yytab[:rows], xx11[:rows], pidx[:rows])
            got, want = fk.candidates_cuda(*args), fk.candidates_plain(*args)
            torch.cuda.synchronize()
            t_ok = torch.equal(got[:, T_LANES], want[:, T_LANES])
            d = (got - want).abs()
            rel_ok = bool((d <= 1e-5 * want.abs()).all())
            err = float(d.max())
            k4_err = max(k4_err, err)
            del got, want, d
            # at full size the 1.26 GB of tables pass the 50 MB L2: warm is cold too
            reps = 200 if rows == K4_SMALL else 5
            call_ms = cuda_ms(torch, lambda: fk.candidates_cuda(*args), reps)
            warm_ms = graph_ms(torch, lambda: fk.candidates_cuda(*args), reps)
            k_ms = cold_ms(torch, fk.candidates_cuda, args, reps)
            p_ms = cuda_ms(torch, lambda: fk.candidates_plain(*args), min(reps, 20))
            before = f" (before: {BEFORE['K4', rows]})" if ("K4", rows) in BEFORE else ""
            print(f"[11] K4 R={rows} pidx {label}: t-lanes exact {t_ok}, max abs {err:.3g}, within 1e-5 "
                  f"relative {rel_ok}; kernel on the device (CUDA graph) {k_ms:.4f} ms cold, {warm_ms:.4f} "
                  f"ms warm; {call_ms:.4f} ms a call{before}; plain {p_ms:.4f} ms ({card})")
            if not (t_ok and rel_ok):
                raise RuntimeError(f"K4 disagrees with its plain version at R={rows}, pidx {label}")
            if rows == K4_SMALL:
                continue
            # the sector floor, and the gather of the same 88 positions a row
            sectors = k4_sectors(torch, pidx)
            floor_ms = (32 * sectors + rows * (8 + 4 * fk.N_CAND)) / PEAK_BYTES * 1e3
            corr_t, yy_t = k4_reads(torch, pidx)
            gather_args = (ctab, yytab, (384 - corr_t).clamp(0, 384), yy_t.clamp(0, 384))
            del corr_t, yy_t
            gather_ms = cold_ms(torch, lambda c, y, ci, yi: (c.gather(1, ci), y.gather(1, yi)), gather_args, reps)
            del gather_args
            print(f"[11] K4 R={rows} pidx {label}: {sectors / rows:.2f} distinct 32-byte sectors read a row; "
                  f"sector floor {floor_ms:.4f} ms (reads, xx, pidx and the 105 lanes written, over "
                  f"{PEAK_BYTES / 1e12:.2f} TB/s): the kernel at {floor_ms / k_ms:.1%} of it; the gather "
                  f"alone (not the whole function), torch.gather of the 88 positions a row, {gather_ms:.4f} "
                  f"ms cold ({card})")
            if label == "search":
                k4_row = {"ms": k_ms, "plain_ms": p_ms, "sector_floor_ms": floor_ms,
                          "gather_alone_ms": gather_ms}
    del ctab, yytab, xx11, pidx_search, pidx_draw

    # ---- 12. the tools path: attribution at full size ------------------------------------
    at(12)
    reset_counts()
    res12 = attrib.main(["--device", DEVICE])
    torch.cuda.synchronize()
    counts12 = counts()
    g12, p12, st12 = res12["golden"], res12["pitch"], res12["stages"]
    print(f"[12] attrib: golden rel {g12['rel']:.3g}, max {g12['max']:.0f}; K3 against the old chain "
          f"with K4: {p12['pidx_flips']} pidx flips of {p12['windows']} windows, "
          f"t-lane diffs {p12['t_lane_diffs']}, g1 max {p12['g1_max']:.3g}; launches {counts12}")
    print(f"[12] K2 stage costs at B={st12['batch']} T={t6} (production {st12['ms']['none']:.2f} ms): "
          + ", ".join(f"{k} {v:+.2f} ms" for k, v in st12["cost_ms"].items()) + f" ({card})")
    pre12 = res12["prefix"]
    print(f"[12] precompute prefix marginals at B={pre12['batch']}: "
          + ", ".join(f"{k} {v:+.3f} ms" for k, v in pre12["marginal_ms"].items())
          + f"; old chain with K4 {pre12['oldchain_ms']:.2f} ms ({card})")
    print(f"[12] totals: " + "; ".join(f"B={b}: precompute {v['precompute_ms']:.2f} ms, two-phase "
                                      f"{v['two_phase_ms']:.2f} ms" for b, v in res12["totals"].items()))
    if not (g12["rel"] < 1e-4 and g12["max"] <= 2):
        raise RuntimeError("golden bars failed in the attribution run")
    if p12["pidx_flips"] > 0.01 * p12["windows"]:
        raise RuntimeError("K3 and the old chain disagree on more than 1% of the windows")
    if not st12["skip_none_bit_equal"]:
        raise RuntimeError("K2 with skip=() is not bit-equal to the production launch")
    if not all(st12["launches"][k] >= 1 and st12["finite"][k] for k in st12["launches"]):
        raise RuntimeError(f"a skip variant did not launch K2 or gave non-finite output: {st12}")
    if counts12["K4"] == 0 or counts12["K3"] == 0:
        raise RuntimeError("the tools path did not launch K3 and K4")

    # ---- 13. the pitch trace against the native engine -------------------------------------
    at(13)
    pt, gt = pitch_trace(clip, device=dev)
    pn, gn = pitch_trace_native(clip)
    neq = pt != pn
    worst13 = int(np.abs(pt[neq].astype(int) - pn[neq].astype(int)).max()) if neq.any() else 0
    gain13 = float(np.abs(gt[~neq] - gn[~neq]).max())
    print(f"[13] pitch trace on the card against the native engine: {int(neq.sum())} of {len(pt)} "
          f"periods differ (largest step {worst13}); gains where they agree: max |d| {gain13:.3g}")
    if neq.sum() > 2 or worst13 > 2 or not gain13 < 5e-3:
        raise RuntimeError("the pitch trace misses the lag-exact bar against the native engine")

    # ---- 14. the CLI, the signal adapter and the sine benchmark ------------------------------
    at(14)
    with tempfile.TemporaryDirectory() as tmp:
        for extra in ([], ["--engine", "native"]):
            out_path = pathlib.Path(tmp) / "out.raw"
            reset_counts()
            t0 = time.perf_counter()
            rc = cli.main([str(DATA / "testing.raw"), str(out_path), "--device", DEVICE, *extra])
            cli_s = time.perf_counter() - t0
            got = np.fromfile(out_path, "<i2").astype(np.float64)
            n = min(len(got), len(ref))
            rel14 = float(np.sum((ref[:n] - got[:n]) ** 2) / np.sum(got[:n] ** 2))
            max14 = float(np.abs(ref[:n] - got[:n]).max())
            name14 = " ".join(extra) or "--engine torch"
            print(f"[14] CLI {name14} on testing.raw: rc {rc}, {cli_s:.3f} s wall, rel {rel14:.3g}, "
                  f"max {max14:.0f}; launches {counts()} ({card})")
            if rc != 0 or n != len(ref) or not (rel14 < 1e-4 and max14 <= 2):
                raise RuntimeError(f"the CLI ({name14}) misses the golden bars")
            if not extra and min(pk.launches, fk.launches) == 0:
                raise RuntimeError("the CLI did not launch K1 and K2 on the card")
    sig_out = np.fromiter(iter(nt.DenoiseSignal(clip / 32768.0, device=dev)), np.float64) * 32768.0
    o14 = sig_out[: len(ref)].astype(np.int16).astype(np.float64)
    rel_sig = float(np.sum((ref - o14) ** 2) / np.sum(o14 ** 2))
    print(f"[14] DenoiseSignal over the golden clip on the card: {len(sig_out)} samples, rel {rel_sig:.3g}")
    if len(sig_out) < len(ref) or not rel_sig < 1e-4:
        raise RuntimeError("DenoiseSignal misses the golden bar on the card")
    for b in (1, b6):
        st = sine_bench(batch=b, device=dev)
        print(f"[14] sine_bench B={b}: {st['wall_s'] * 1e3:.2f} ms wall for {st['frames']} frames, "
              f"{st['realtime_factor']:,.1f}x realtime ({card})")
        if not st["realtime_factor"] > 0:
            raise RuntimeError("sine_bench gave no rate")

    # ---- 15. K2's FFT alone, at the phase-6 shapes -------------------------------------------
    at(15)
    packed6, _ = k2_kern()
    per6 = packed6[..., fk.OFF_PERIOD].to(torch.int64).T  # (B, T)
    full6 = torch.cat([carry6.feat.input_mem, filt6.reshape(b6, -1)], 1).unfold(1, 960, 1)
    frame_off = 480 * torch.arange(1, t6 + 1, device=dev)[None, :] + 768  # hist(q) = full[480(t+1) + q]
    rows_b = torch.arange(b6, device=dev)[:, None]
    lag0_w = full6[rows_b, frame_off.expand(b6, -1)].reshape(-1, 960)
    pitch_w = full6[rows_b, frame_off - per6].reshape(-1, 960)
    fwd_in = torch.cat([lag0_w, pitch_w]).contiguous()  # (819,200, 960)
    del packed6, full6, lag0_w, pitch_w
    win64 = torch.as_tensor(VORBIS_WINDOW, dtype=torch.float64, device=dev)

    def row_err(got, want):
        """(max over rows of the row's max |got - want| over its max |want|,
        max |got - want|)."""
        scale = want.abs().amax(1)
        d = (got.double() - want).abs().amax(1)
        rel = torch.where(scale > 0, d / scale.clamp(min=1e-300), torch.where(d > 0, float("inf"), 0.0))
        return float(rel.max()), float(d.max())

    def rfft64(x):
        spec = torch.fft.rfft(x.double() * win64, dim=1) * float(WNORM)
        return torch.cat([spec.real, spec.imag], 1)

    def irfft64(packed):
        spec = torch.complex(packed[:, :481].double(), packed[:, 481:].double())
        spec[:, 0].imag.zero_()
        spec[:, 480].imag.zero_()
        return torch.fft.irfft(spec, 960, dim=1) * 480.0 * win64

    inv_in = torch.empty((b6 * t6, 962), dtype=torch.float32, device=dev)
    errs = {"rfft960": [(0.0, 0.0)] * 2, "irfft960": [(0.0, 0.0)] * 2}  # (probe, dense plain)
    reset_counts()
    for i in range(0, fwd_in.shape[0], PROBE_CHUNK):
        x = fwd_in[i : i + PROBE_CHUNK]
        want = rfft64(x)
        for j, got in enumerate((fft.rfft960(x), fft.forward_transform(x))):
            errs["rfft960"][j] = tuple(map(max, errs["rfft960"][j], row_err(got, want)))
        if i < inv_in.shape[0]:
            spec = want[: inv_in.shape[0] - i].float()
            inv_in[i : i + spec.shape[0]] = spec
            want_y = irfft64(spec)
            for j, got in enumerate((fft.irfft960(spec), fft.inverse_transform(spec))):
                errs["irfft960"][j] = tuple(map(max, errs["irfft960"][j], row_err(got, want_y)))
    torch.cuda.synchronize()
    probe_calls = fft.launches
    inv_complex = torch.complex(inv_in[:, :481], inv_in[:, 481:])
    probe = {}
    for name, x, kern, plain, lib in (
        ("rfft960", fwd_in, fft.rfft960, fft.forward_transform, lambda: torch.fft.rfft(fwd_in, dim=1)),
        ("irfft960", inv_in, fft.irfft960, fft.inverse_transform,
         lambda: torch.fft.irfft(inv_complex, 960, dim=1)),
    ):
        p1 = cuda_ms(torch, lambda: plain(x), 3)
        k_1 = cuda_ms(torch, lambda: kern(x), 3)
        k_2 = cuda_ms(torch, lambda: kern(x), 3)
        p2 = cuda_ms(torch, lambda: plain(x), 3)
        lib_ms = cuda_ms(torch, lib, 3)
        ((e_probe, abs_probe), (e_dense, abs_dense)), rows = errs[name], x.shape[0]
        probe[name] = (abs_probe, (k_1 + k_2) / 2, (p1 + p2) / 2, lib_ms, rows)
        print(f"[15] {name} probe R={rows}: error {e_probe:.3g} of the row scale (max abs "
              f"{abs_probe:.3g}), dense plain {e_dense:.3g} (max abs {abs_dense:.3g}) (bar "
              f"{PROBE_BAR:g}, probe <= 2x dense); probe {probe[name][1]:.3f} ms "
              f"({k_1:.3f}, {k_2:.3f}), dense plain {probe[name][2]:.3f} ms, torch.fft {lib_ms:.3f} ms "
              f"({card})")
        if not (e_probe <= PROBE_BAR and e_dense <= PROBE_BAR and e_probe <= 2 * e_dense):
            raise RuntimeError(f"the {name} probe misses its bars")
    if probe_calls == 0:
        raise RuntimeError("the probe did not launch")
    del fwd_in, inv_in, inv_complex

    # K6's library yardstick: one torch.gather of the same windows
    gidx = (768 - lag7.to(torch.int64))[:, None] + torch.arange(960, device=dev)
    if not torch.equal(mem7.gather(1, gidx), wk.window_cuda(mem7, lag7)):
        raise RuntimeError("K6 and torch.gather disagree")
    k6_lib = cold_ms(torch, lambda m, i: m.gather(1, i), (mem7, gidx), 20)
    print(f"[15] K6 yardstick torch.gather B={b6}: on the device (CUDA graph) {k6_lib:.4f} ms cold, "
          f"{graph_ms(torch, lambda: mem7.gather(1, gidx), 20):.4f} ms warm; "
          f"{cuda_ms(torch, lambda: mem7.gather(1, gidx), 20):.4f} ms a call ({card})")

    # ---- 16. K1 by stage through its skip knob ---------------------------------------------
    at(16)
    prod16 = k1_kern()
    if not all(torch.equal(a, b) for a, b in zip(prod16, pk.pitch_analysis_cuda(ds6, w06, t6, skip=()))):
        raise RuntimeError("K1 with skip=() is not bit-equal to the production launch")
    del prod16
    best_ms = attrib.make_timer(dev, 3)
    base16 = [best_ms(k1_kern)]
    cost16 = {}
    for stage in pk.SKIP_STAGES:
        kern16 = lambda: pk.pitch_analysis_cuda(ds6, w06, t6, skip=(stage,))
        ok, _, msg = pitch_bars(torch, pk.pitch_analysis_cuda(ds, w0, t3, skip=(stage,)),
                                pk.pitch_analysis_plain(ds, w0, t3, skip=(stage,)), lag_lanes=stage != "cand")
        ms = best_ms(kern16)
        cost16[stage] = base16[0] - ms
        print(f"[16] K1 skip={stage}: {ms:.3f} ms, cost {base16[0] - ms:+.3f} ms; against the plain "
              f"stub at B={b3} T={t3}: {msg}")
        if not ok:
            raise RuntimeError(f"K1's {stage} stub disagrees with the plain version's")
    base16.append(best_ms(k1_kern))
    print(f"[16] K1 stage costs at B={b6} T={t6} (production {base16[0]:.3f} ms, {base16[1]:.3f} ms "
          f"after the stubs; skip=() bit-equal): "
          + ", ".join(f"{k} {c:+.3f} ms" for k, c in cost16.items()) + f" ({card})")

    # ---- 17. the training path ----------------------------------------------------------------
    at(17)
    trained = training_phase(torch, dev, card, reset_counts, counts)

    # ---- 18. the multi-device split and data-parallel fit --------------------------------------
    at(18)
    parallel_phase(torch, dev, card, engine, big, trained, reset_counts, counts)

    # ---- 19. the trainer's GRU sequence kernels -----------------------------------------------
    at(19)
    k7_rows = gru_sequence_phase(torch, dev, card, trained["k7_step"])

    # ---- 20. RNNoise 0.2's GRU sequence kernels -----------------------------------------------
    at(20)
    k8_rows = rn02_gru_phase(torch, dev, card)

    band_nnz = int((BAND_CORR_MATRIX != 0).sum())
    bounds = kernel_bounds(b6, t6, b6 * t6, 2 * b6 * t6, b6 * t6, band_nnz)

    def entry(key, name, source, replaces, launches, err, ms, plain_ms, library_ms=None):
        b_ms, b_by = bound(*bounds[key])
        return {"name": name, "route": "cuda", "source": f"nnnoiseless_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": library_ms}

    k2_line = "nnnoiseless_tpu/ops/frame_kernel.py:769"
    kernels = [
        entry("K1", "pitch_analysis_stream", "pitch_kernel.cu", "nnnoiseless_tpu/ops/pitch_kernel.py:696",
              counts6[0], k1_err, *times["k1"]),
        entry("K2", "frame_loop_pallas", "frame_kernel.cu", k2_line, counts6[1], k2_err, *times["k2"]),
        entry("K3", "pitch_analysis_pallas", "pitch_kernel.cu", "nnnoiseless_tpu/ops/pitch_kernel.py:651",
              counts8["K3"], *results7["K3", b6]),
        entry("K5", "rnn_step_pallas", "rnn_kernel.cu", "nnnoiseless_tpu/ops/rnn_pallas.py:145",
              counts9["K5"], *results7["K5", b6]),
        entry("K6", "_pallas_window", "window_kernel.cu", "nnnoiseless_tpu/ops/window.py:65",
              counts9["K6"], *results7["K6", b6], k6_lib),
        # K4: no one PyTorch call computes its function, so library_ms is null;
        # the gather of its 88 positions a row and its sector floor stand beside
        {**entry("K4", "candidates_pallas", "candidates_kernel.cu", "nnnoiseless_tpu/ops/frame_kernel.py:408",
                 counts12["K4"], k4_err, k4_row["ms"], k4_row["plain_ms"]),
         "sector_floor_ms": k4_row["sector_floor_ms"], "gather_alone_ms": k4_row["gather_alone_ms"]},
        # K2's transforms alone; nothing on the main path calls them, and
        # they replace no TPU kernel of their own
        *({**entry(name, f"{name}_probe", "fft960_kernel.cu", None, counts6[2], e, k_ms, p_ms, lib_ms),
           "probe_of": k2_line}
          for name, (e, k_ms, p_ms, lib_ms, _) in probe.items()),
        # the trainer's recurrence; it replaces no TPU kernel (a lax.scan there)
        *k7_rows,
        *k8_rows,
    ]
    for k in kernels:
        print(f"[15] {k['name']}: {k['ms']:.4f} ms, bound {k['bound_ms']:.4f} ms by {k['bound_by']} "
              f"({k['bound_ms'] / k['ms']:.1%} of the bound)")
    beat = [k["name"] for k in kernels if k["ms"] < k["bound_ms"]]
    if beat:
        raise RuntimeError(f"{beat} timed below their bound: the timing's data did not come from "
                           "where the bound's count assumes")
    at("end")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
