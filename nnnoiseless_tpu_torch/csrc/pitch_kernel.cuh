// Kernel K1: per-frame pitch analysis (sm_90a, FP32 on CUDA cores, the
// energy tables from FP64 prefix sums).
//
// Replaces the Pallas kernel nnnoiseless_tpu/ops/pitch_kernel.py::
// pitch_analysis_stream (body _make_pitch_kernel(stream=True)).  For frame t
// of stream b it reads the 864-sample decimated window
// ds[b, 240(t+1) : 240(t+1) + 864] with lane 0 replaced by w0[t, b], and
// computes, as ops/pitch.py::pitch_chain does:
//   whitening: 5-lag autocorrelation with the lag window, order-4 Levinson
//     with the early-exit freeze, 0.9 taper, 6-tap zero-history FIR;
//   the correlation corr[s] = dot(y[384:864], y[s:s+480]) for the 384 lags
//     s < 384 (lag 384 is never read: the pitch index is at least 181 on
//     every path, so every candidate lookup t is at least 1), and the
//     385-lag energy table e[k] = |y[k:k+480]|^2;
//   the coarse top-2 search over 147 lags of y[0::2][:387] against
//     y[384::2][:240], the fine search over 294 lags within +-2 of twice
//     the coarse picks, pseudo-interpolation, and the 105 octave-removal
//     candidate lanes (ops/pitch.py::doubling_candidates layout).
//
// Kernel K3 is the same device code behind a second entry point,
// nnt_pitch_analysis_stacked: it replaces ops/pitch_kernel.py::
// pitch_analysis_pallas, which takes R windows already stacked (R, 864)
// with nothing patched (the per-frame path's one window per stream).  Its
// design and bounds are K1's, one block per window; at R = 1 it is one
// block on one SM, and latency.
//
// Layout.  K1 has no cross-frame carry: the TPU kernel's sequential T grid
// only saved HBM traffic on overlapping windows.  Here one thread block
// owns one (stream, frame) window, so B*T blocks (~410 K at B=4096, T=100)
// fill the card.  Blocks are numbered stream-major (b*T + t), so the
// neighbouring blocks of one stream read overlapping windows that are
// still in L2.
//
// What bounds it.  A window needs ~230 K multiply-adds (the 384x480
// correlation, the 147x240 coarse correlation, ~10 K for whitening)
// against 3.5 KB of input: FP32 work on the CUDA cores, ~1,800 SM clocks
// a window.  Direct sums with four lags a thread load y from shared memory
// for every FMA pair (5 loads feed 8 FMAs), so shared-memory load
// bandwidth bounds them, at ~7x the FMA time.  This design makes each load
// feed many FMAs and takes the energies off the FMA path:
//   - Register tiles.  A task is 8 consecutive lags over a run of samples.
//     The thread keeps the 8 sums and a 12-sample window of y in registers;
//     each step of 4 samples loads one float4 of y (the window slides by
//     4) and one float4 of the correlation's tail, and does 32 FMAs.
//     Warps 0-2 take the correlation as 48 lag groups x 2 sample halves
//     [0, 244) and [244, 480), the low half's lane adding the high half's
//     sums (low + high), then the coarse correlation, on a contiguous copy
//     of y[0::2] (no stride-2 reads), as 19 lag groups x 4 pieces of 60
//     samples, added ((p0 + p1) + (p2 + p3)).
//   - Banks.  A 16-byte load is served a quarter-warp (8 lanes) at a time;
//     lanes 8 lags apart read addresses 32 B apart, so two lanes of a
//     quarter would share banks.  A quarter holds 4 lag groups x both
//     halves, and the halves start 244 samples apart (244 = 20 mod 32
//     words): its 8 float4 reads fall on 8 distinct groups of 4 banks, and
//     its tail reads are two broadcasts on distinct banks.  Per warp and
//     step that is ~5-8 wavefronts against 32 FMAs (8 SM clocks of FP32).
//     The coarse pieces keep a 2-way conflict on their 15 steps.
//   - Energies from float64 prefix sums, on warp 3 while warps 0-2 run the
//     tiles.  P[k] = sum_{j<k} y[j]^2 over the 864 samples and Pe over the
//     432 even ones (each lane a run of samples, the lane offsets added in
//     lane order so that P is monotone); e[k] = P[k+480] - P[k] and w4[k] =
//     Pe[k+240] - Pe[k], rounded to f32 once.  The squares are exact in f64
//     and P is nondecreasing, so every energy is >= 0, and its error is a
//     few ulps of P (~1e-16 of the window's energy), far below an f32
//     direct sum's.  This replaces 385x480 + 147x240 FMAs of direct sums
//     with ~1,300 f64 adds.
//   - Whitening.  The autocorrelation keeps the thread-strided order (the
//     LPC solve amplifies its rounding, and this order tracks the plain
//     version's reduction); the FIR runs 8 samples a thread from registers.
//   - Not taken: tensor cores (the Toeplitz product is a GEMM only by
//     blocking, ~2.1x the MACs, and f32 decisions need split 3xTF32, ~6x
//     the direct MACs on mma.sync tiles of one window: no gain over 67
//     TFLOP/s FP32); the FFT route (3 transforms of 960 a window, ~3.5 ms
//     at the probe's rate, and other rounding near ties); cp.async for the
//     3.5 KB window (other resident blocks hide the load).
// The lag loop compiles to 96 FFMA, 6 LDS.128 and ~9 other instructions
// every 3 steps and runs at about the issue rate; what is left is the
// serial sections (the Levinson solve on one thread; the two searches, a
// one-pass top-2 merge on warp 0; the candidate walk, one lane a
// candidate) and the other passes, which resident blocks only partly
// hide.  48 registers and ~20 KB of shared memory (the raw window, the
// prefix sums and the masked fine correlation share one buffer) let 10
// blocks share an SM.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "candidate_lanes.cuh"

namespace pitch {

// Stages the skip knob stubs out (ops/pitch_kernel.py::SKIP_STAGES), one
// bit each; 0 is production.
enum : int {
  SK_WHITEN = 1,  // whitening: y = x
  SK_ETAB = 2,    // the 385-lag energy table: zeros
  SK_CORR = 4,    // the correlation: zeros
  SK_COARSE = 8,  // the coarse search: best4 = second4 = 0
  SK_CAND = 16,   // the candidate walk: every lane xx
};

// The stub instances (csrc/pitch_kernel_skip.cu): one launch of the kernel
// with the single stage `skip` stubbed; cudaErrorInvalidValue for a mask
// with no instance.
int launch_skip(int skip, const float* ds, int ds_stride, int first, const float* w0, float* cand,
                int* pidx, int B, int T, cudaStream_t stream);

}  // namespace pitch

namespace {

using namespace pitch;

constexpr int N_DS = 864;
constexpr int N_EVEN = N_DS / 2;  // 432
constexpr int DS_STEP = 240;
constexpr int N_LAGS = 385;
constexpr int N_FINE = 294;
constexpr int N_COARSE = 147;
constexpr int LEN4 = 240;
constexpr int FRAME_DS = 480;
constexpr int MAXP = 384;
constexpr int MAX_PERIOD = 768;
constexpr int N_CAND = 105;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 8;                 // lags a task
constexpr int HALF = 244;               // the correlation's sample split (= 20 mod 32)
constexpr int COARSE_GROUPS = (N_COARSE + TILE - 1) / TILE;      // 19
constexpr int COARSE_PIECE = LEN4 / 4;                           // 60 samples
constexpr int PAD = 16;  // zeros past the end: a task's last float4 reads 12 samples ahead
constexpr int XPAD = 8;  // zeros before and after the raw window: the whitening's reach
constexpr int BLOCKS_PER_SM = 10;  // resident blocks: at most 48 registers, ~20 KB shared

struct ArgMax {
  float v;
  int i;
};

// b before a in the search's order: the larger value, the earlier index on
// ties (first-maximum semantics).  A total order: indices are distinct.
__device__ __forceinline__ bool beats(ArgMax b, ArgMax a) {
  return b.v > a.v || (b.v == a.v && b.i < a.i);
}

// The first two of a set in that order.
struct Top2 {
  ArgMax a, b;
};

__device__ __forceinline__ Top2 merge(Top2 x, Top2 y) {
  const bool yx = beats(y.a, x.a);
  const ArgMax lo = yx ? x.a : y.a;             // the worse of the two firsts
  const ArgMax next = beats(y.b, x.b) ? y.b : x.b;  // the better of the seconds
  return {yx ? y.a : x.a, beats(next, lo) ? next : lo};
}

__device__ __forceinline__ float pitch_ratio(const float* xc, const float* w, int i) {
  float c = xc[i];
  return c > 0.f ? (c * c) / fmaxf(1.f + w[i], 1.f) : -INFINITY;
}

// ops/pitch.py::find_best_pitch, run by one whole warp in one pass: each
// lane keeps its first two lags, the warp merges them.  Top-2 lags of
// xc^2 / max(1 + w, 1) over xc > 0, earlier lag on ties; with fewer than
// two qualified lags `second` is 0 (one qualified) or 1 (none).  Every lane
// gets both.
__device__ void find_best_pitch(const float* xc, const float* w, int n, int lane, int& best,
                                int& second) {
  Top2 m{{-INFINITY, 1 << 30}, {-INFINITY, 1 << 30}};
  bool q = false;
  for (int i = lane; i < n; i += 32) {
    const ArgMax c{pitch_ratio(xc, w, i), i};
    if (beats(c, m.a)) {
      m.b = m.a;
      m.a = c;
    } else if (beats(c, m.b)) {
      m.b = c;
    }
    q |= xc[i] > 0.f;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const Top2 o{{__shfl_xor_sync(0xffffffffu, m.a.v, off), __shfl_xor_sync(0xffffffffu, m.a.i, off)},
                 {__shfl_xor_sync(0xffffffffu, m.b.v, off), __shfl_xor_sync(0xffffffffu, m.b.i, off)}};
    m = merge(m, o);
  }
  const bool any_q = __any_sync(0xffffffffu, q);
  best = m.a.i;
  second = m.b.v > -INFINITY ? m.b.i : (any_q ? 0 : 1);
}

// Warp sums of v into red[k * WARPS + warp]; the caller syncs and adds them.
__device__ __forceinline__ void warp_sums(float v, float* red, int k) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[k * WARPS + threadIdx.x / 32] = v;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// One step of 4 samples of a register tile: acc[m] += sum_k t4[k] w[m + k]
// over the window w = (p, q, r) of 12 samples, then p takes the 4 samples
// after r, so that the next step's window is (q, r, p).
__device__ __forceinline__ void tile_step(float acc[TILE], const float* t, const float* v, float4& p,
                                          const float4& q, const float4& r) {
  const float4 t4 = ld4(t);
  const float w[12] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w, r.x, r.y, r.z, r.w};
  const float tk[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int m = 0; m < TILE; ++m) acc[m] = fmaf(tk[k], w[m + k], acc[m]);
  p = ld4(v + 12);
}

// acc[m] = sum_{i<n} t[i] v[i + m] for m < 8, n a multiple of 4, the sum
// in sample order; t and v 16-byte aligned.  Reads v[0, n + 12).
__device__ __forceinline__ void tile_sums(const float* __restrict__ t, const float* __restrict__ v,
                                          int n, float acc[TILE]) {
#pragma unroll
  for (int m = 0; m < TILE; ++m) acc[m] = 0.f;
  float4 a = ld4(v), b = ld4(v + 4), c = ld4(v + 8);
  int i = 0;
  for (; i + 12 <= n; i += 12) {  // three steps, the window rotating through a, b, c
    tile_step(acc, t + i, v + i, a, b, c);
    tile_step(acc, t + i + 4, v + i + 4, b, c, a);
    tile_step(acc, t + i + 8, v + i + 8, c, a, b);
  }
  if (i < n) tile_step(acc, t + i, v + i, a, b, c);
  if (i + 4 < n) tile_step(acc, t + i + 4, v + i + 4, b, c, a);
}

// P[k] = sum_{j<k} (double)v[j]^2 for k <= n, by one warp.  Lane l sums
// its run of ceil(n/32) samples in order (its prefixes part_l(j), its
// total run_l, kept in tot[l]); the offsets are added in lane order,
// off_{l+1} = off_l + run_l, the same additions on every lane; and
// P[j] = off_l + part_l(j).  Each step is a monotone function of
// nonnegative terms, and the last prefix of a run, off_l + run_l, is the
// next run's offset: P is nondecreasing, so P[k2] - P[k1] >= 0 for k2 >= k1.
__device__ void prefix_energy(const float* v, int n, double* P, double* tot, int lane) {
  const int per = (n + 31) / 32;
  const int lo = min(lane * per, n), hi = min(lo + per, n);
  double part = 0.0;
  for (int j = lo; j < hi; ++j) {  // the run's own prefixes first
    P[j] = part;
    part = fma((double)v[j], (double)v[j], part);
  }
  tot[lane] = part;
  __syncwarp();
  double off = 0.0;
  for (int l = 0; l < lane; ++l) off += tot[l];
  for (int j = lo; j < hi; ++j) P[j] = off + P[j];
  if (lane == 31) P[n] = off + part;
}

// Window t of stream b starts at ds[b * ds_stride + first + 240 t]; lane 0
// is w0[t * B + b], or the window's own sample when w0 is null.
template <int SKIP>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
pitch_kernel(const float* __restrict__ ds, int ds_stride, int first, const float* __restrict__ w0,
             float* __restrict__ cand, int* __restrict__ pidx_out, int B, int T) {
  __shared__ __align__(16) float y[N_DS + PAD];     // whitened window
  __shared__ __align__(16) float ev[N_EVEN + PAD];  // y[0::2]
  // the raw window (from float XPAD on, XPAD zeros on each side) until the
  // FIR has read it, then the prefix energies of y and of ev
  __shared__ __align__(16) double scratch[N_DS + 1 + N_EVEN + 1];
  float* const x = reinterpret_cast<float*>(scratch) + XPAD;
  double* const pe = scratch;
  double* const pev = scratch + N_DS + 1;
  __shared__ double lane_tot[2][32];  // the prefix sums' lane totals
  __shared__ float corr[MAXP];
  float* const xc2 = reinterpret_cast<float*>(scratch);  // once the energies are taken
  __shared__ float etab[N_LAGS];
  __shared__ float xc4[COARSE_GROUPS * TILE];
  __shared__ float w4[N_COARSE];
  __shared__ float red[5 * WARPS];
  __shared__ float taps[5];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / T;
  const int t = blockIdx.x % T;
  const int row = t * B + b;  // time-major output row

  const float* src = ds + (size_t)b * ds_stride + first + DS_STEP * t;
  for (int i = tid; i < N_DS; i += THREADS) {
    const float v = i == 0 && w0 != nullptr ? w0[row] : src[i];
    if constexpr (SKIP & SK_WHITEN) {  // the whiten stub: y = x
      y[i] = v;
      if (!(i & 1)) ev[i >> 1] = v;
    } else {
      x[i] = v;
    }
  }
  if (tid < PAD) y[N_DS + tid] = ev[N_EVEN + tid] = 0.f;
  if (tid < 2 * XPAD) x[tid < XPAD ? tid - XPAD : N_DS + tid - XPAD] = 0.f;
  __syncthreads();

  // ---- whitening (ops/pitch.py::whiten, pitch.rs:448-483) ----------------
  if constexpr (!(SKIP & SK_WHITEN)) {
    // the autocorrelation in thread-strided order (the LPC solve amplifies
    // its rounding, and this order tracks the plain version's reduction);
    // x[i + k] past the window reads the zeros after it
    float a[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = tid; i < N_DS; i += THREADS) {
      const float xi = x[i];
#pragma unroll
      for (int k = 0; k < 5; ++k) a[k] = fmaf(xi, x[i + k], a[k]);
    }
#pragma unroll
    for (int k = 0; k < 5; ++k) warp_sums(a[k], red, k);
    __syncthreads();
    if (tid == 0) {
      float ac[5];
      for (int k = 0; k < 5; ++k) {
        float s = 0.f;
        for (int w = 0; w < WARPS; ++w) s += red[k * WARPS + w];
        ac[k] = s;
      }
      ac[0] = __fmul_rn(ac[0], 1.0001f);  // -40 dB noise floor
      for (int i = 1; i < 5; ++i)
        ac[i] = __fsub_rn(ac[i], __fmul_rn(ac[i], (float)((0.008 * i) * (0.008 * i))));
      // order-4 Levinson-Durbin with the reference's early-exit freeze
      float lpc[4] = {0.f, 0.f, 0.f, 0.f};
      float error = ac[0];
      bool done = ac[0] == 0.f;
      const float thresh = __fmul_rn(0.001f, ac[0]);
      for (int i = 0; i < 4; ++i) {
        float rr = ac[i + 1];
        for (int j = 0; j < i; ++j) rr = __fadd_rn(rr, __fmul_rn(lpc[j], ac[i - j]));
        const float r = -rr / (done ? 1.f : error);
        float nw[4] = {lpc[0], lpc[1], lpc[2], lpc[3]};
        nw[i] = r;
        for (int j = 0; j < (i + 1) / 2; ++j) {
          const float t1 = nw[j], t2 = nw[i - 1 - j];
          nw[j] = __fadd_rn(t1, __fmul_rn(r, t2));
          nw[i - 1 - j] = __fadd_rn(t2, __fmul_rn(r, t1));
        }
        if (!done) {
          for (int j = 0; j < 4; ++j) lpc[j] = nw[j];
          error = __fsub_rn(error, __fmul_rn(__fmul_rn(r, r), error));
        }
        done = done || error < thresh;
      }
      float c[4], taper = 1.f;
      for (int i = 0; i < 4; ++i) {
        taper = __fmul_rn(taper, 0.9f);
        c[i] = __fmul_rn(lpc[i], taper);
      }
      // FIR taps with the 0.8 zero folded in
      taps[0] = __fadd_rn(c[0], 0.8f);
      taps[1] = __fadd_rn(c[1], __fmul_rn(0.8f, c[0]));
      taps[2] = __fadd_rn(c[2], __fmul_rn(0.8f, c[1]));
      taps[3] = __fadd_rn(c[3], __fmul_rn(0.8f, c[2]));
      taps[4] = __fmul_rn(0.8f, c[3]);
    }
    __syncthreads();
    // the FIR: thread t < 108 owns samples i0 = 8t .. 8t+7 and reads
    // x[i0-8 .. i0+7] into registers (zeros before the window): r[8 + m] is
    // x[i0 + m]
    if (tid < N_DS / 8) {
      const int i0 = 8 * tid;
      float r[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = ld4(x + i0 - 8 + 4 * q);
        r[4 * q] = v.x;
        r[4 * q + 1] = v.y;
        r[4 * q + 2] = v.z;
        r[4 * q + 3] = v.w;
      }
      float v[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        v[m] = r[8 + m];
#pragma unroll
        for (int j = 1; j <= 5; ++j) v[m] = __fadd_rn(v[m], __fmul_rn(taps[j - 1], r[8 + m - j]));
      }
      *reinterpret_cast<float4*>(y + i0) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(y + i0 + 4) = make_float4(v[4], v[5], v[6], v[7]);
      // the contiguous even samples of the coarse stage
      *reinterpret_cast<float4*>(ev + i0 / 2) = make_float4(v[0], v[2], v[4], v[6]);
    }
    __syncthreads();
  }

  if (warp < 3) {
    // ---- register-tiled lag sums: warps 0-2 -------------------------------
    // The correlation: lag group g = 4 (tid / 8) + tid % 4, samples [0, 244)
    // for tid % 8 < 4 and [244, 480) above (a quarter-warp's loads on
    // distinct banks); the low half's lane adds the high half's sums, 4
    // lanes up.
    float acc[TILE];
    const int g = 4 * (tid >> 3) + (tid & 3);
    if constexpr (SKIP & SK_CORR) {
#pragma unroll
      for (int m = 0; m < TILE; ++m) acc[m] = 0.f;
    } else {
      const int h0 = (tid & 4) ? HALF : 0;
      tile_sums(y + MAXP + h0, y + TILE * g + h0, (tid & 4) ? FRAME_DS - HALF : HALF, acc);
#pragma unroll
      for (int m = 0; m < TILE; ++m) acc[m] += __shfl_down_sync(0xffffffffu, acc[m], 4);
    }
    if (!(tid & 4)) {
#pragma unroll
      for (int m = 0; m < TILE; ++m) corr[TILE * g + m] = acc[m];
    }
    // The coarse correlation of y4 = ev[0:] against x4 = ev[192:432]: lag
    // group tid / 4 over the samples [60 p, 60 p + 60), p = tid % 4, for
    // tid < 76; the four pieces added ((p0 + p1) + (p2 + p3)) in the
    // group's first lane.
    if constexpr (!(SKIP & SK_COARSE)) {
      const int gc = tid >> 2, p0 = COARSE_PIECE * (tid & 3);
      if (gc < COARSE_GROUPS) {
        tile_sums(ev + MAXP / 2 + p0, ev + TILE * gc + p0, COARSE_PIECE, acc);
      } else {
#pragma unroll
        for (int m = 0; m < TILE; ++m) acc[m] = 0.f;
      }
#pragma unroll
      for (int m = 0; m < TILE; ++m) {
        acc[m] += __shfl_down_sync(0xffffffffu, acc[m], 1);
        acc[m] += __shfl_down_sync(0xffffffffu, acc[m], 2);
      }
      if (gc < COARSE_GROUPS && !(tid & 3)) {
#pragma unroll
        for (int m = 0; m < TILE; ++m) xc4[TILE * gc + m] = acc[m];
      }
    }
  } else {
    // ---- warp 3, meanwhile: energy tables from f64 prefix sums ------------
    if constexpr (SKIP & SK_ETAB) {
      for (int k = lane; k < N_LAGS; k += 32) etab[k] = 0.f;
    } else {
      prefix_energy(y, N_DS, pe, lane_tot[0], lane);
      __syncwarp();
      for (int k = lane; k < N_LAGS; k += 32) etab[k] = (float)(pe[k + FRAME_DS] - pe[k]);
    }
    if constexpr (!(SKIP & SK_COARSE)) {
      prefix_energy(ev, N_EVEN, pev, lane_tot[1], lane);
      __syncwarp();
      for (int k = lane; k < N_COARSE; k += 32) w4[k] = (float)(pev[k + LEN4] - pev[k]);
    }
  }
  __syncthreads();
  if (warp != 0) return;

  // ---- the searches and the candidate lanes: warp 0 -----------------------
  int best4 = 0, second4 = 0;
  if constexpr (!(SKIP & SK_COARSE)) find_best_pitch(xc4, w4, N_COARSE, lane, best4, second4);

  // fine stage: the shared correlation within +-2 of the picks
  for (int s = lane; s < N_FINE; s += 32) {
    const bool near = abs(s - 2 * best4) <= 2 || abs(s - 2 * second4) <= 2;
    xc2[s] = near ? fmaxf(corr[s], -1.f) : 0.f;
  }
  __syncwarp();
  int best2, unused_second;
  find_best_pitch(xc2, etab, N_FINE, lane, best2, unused_second);

  // pseudo-interpolation, interior lags only
  const float pa = xc2[max(best2 - 1, 0)];
  const float pb = xc2[best2];
  const float pc = xc2[min(best2 + 1, N_FINE - 1)];
  int offset = 0;
  if (best2 > 0 && best2 < N_FINE - 1) {
    if (pc - pa > 0.7f * (pb - pa)) offset = 1;
    else if (pa - pc > 0.7f * (pb - pc)) offset = -1;
  }
  const int pidx = MAX_PERIOD - (2 * best2 - offset);
  if (lane == 0) pidx_out[row] = pidx;

  // ---- octave-removal candidate lanes (ops/pitch.py::doubling_candidates),
  //      one lane a candidate; pidx >= 181 here, so every lookup t is in
  //      [1, 384]: on the tables and never the unbuilt correlation lag 384;
  //      energies are >= 0
  float* const out = cand + (size_t)row * N_CAND;
  if constexpr (SKIP & SK_CAND) {
    for (int k = lane; k < N_CAND; k += 32) out[k] = etab[MAXP];
  } else if (lane < candidate_lanes::N_WALK) {
    candidate_lanes::write_one<false>(
        lane, min(pidx / 2, MAXP - 1), etab[MAXP], [&](int tt) { return corr[MAXP - tt]; },
        [&](int tt) { return etab[MAXP - tt]; }, out);
  }
}

template <int SKIP>
int launch(const float* ds, int ds_stride, int first, const float* w0, float* cand, int* pidx,
           int B, int T, cudaStream_t stream) {
  pitch_kernel<SKIP><<<B * T, THREADS, 0, stream>>>(ds, ds_stride, first, w0, cand, pidx, B, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
