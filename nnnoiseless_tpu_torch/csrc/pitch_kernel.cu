// Kernel K1: per-frame pitch analysis (sm_90a, FP32 on CUDA cores).
//
// Replaces the Pallas kernel nnnoiseless_tpu/ops/pitch_kernel.py::
// pitch_analysis_stream (body _make_pitch_kernel(stream=True)).  For frame t
// of stream b it reads the 864-sample decimated window
// ds[b, 240(t+1) : 240(t+1) + 864] with lane 0 replaced by w0[t, b], and
// computes, as ops/pitch.py::pitch_chain does:
//   whitening: 5-lag autocorrelation with the lag window, order-4 Levinson
//     with the early-exit freeze, 0.9 taper, 6-tap zero-history FIR;
//   the 385-lag energy table e[k] = |y[k:k+480]|^2 and the 385-lag
//     correlation corr[s] = dot(y[384:864], y[s:s+480]), as direct sums;
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
// What bounds it.  About 0.4 M multiply-adds per window (the 384x480
// correlation and the 385x480 energy table) against 3.5 KB of input:
// compute on the CUDA cores.  Each thread keeps four lags' correlation and
// energy sums in registers and reads the window from shared memory, where
// a warp's 32 lags read 32 consecutive words (no bank conflicts) and the
// correlation's tail sample is a broadcast.  The searches are warp-level
// argmax reductions; the scalar Levinson and candidate walk run on one
// thread (a few hundred operations beside ~400 K).

#include <cuda_runtime.h>
#include <math.h>

#include "candidate_lanes.cuh"

namespace {

constexpr int N_DS = 864;
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
constexpr int LAGS_PER_THREAD = (N_LAGS + THREADS - 1) / THREADS;  // 4

struct ArgMax {
  float v;
  int i;
};

// The larger value; the earlier index on ties (first-maximum semantics).
__device__ __forceinline__ ArgMax better(ArgMax a, ArgMax b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

__device__ __forceinline__ ArgMax warp_argmax(ArgMax m) {
  for (int off = 16; off > 0; off >>= 1) {
    ArgMax o{__shfl_xor_sync(0xffffffffu, m.v, off), __shfl_xor_sync(0xffffffffu, m.i, off)};
    m = better(m, o);
  }
  return m;
}

__device__ __forceinline__ float pitch_ratio(const float* xc, const float* w, int i) {
  float c = xc[i];
  return c > 0.f ? (c * c) / fmaxf(1.f + w[i], 1.f) : -INFINITY;
}

// ops/pitch.py::find_best_pitch, run by one whole warp.  Top-2 lags of
// xc^2 / max(1 + w, 1) over xc > 0, earlier lag on ties; with fewer than
// two qualified lags `second` is 0 (one qualified) or 1 (none).
__device__ void find_best_pitch(const float* xc, const float* w, int n, int lane,
                                int* best_out, int* second_out) {
  ArgMax m{-INFINITY, 1 << 30};
  bool q = false;
  for (int i = lane; i < n; i += 32) {
    m = better(m, ArgMax{pitch_ratio(xc, w, i), i});
    q |= xc[i] > 0.f;
  }
  const int best = warp_argmax(m).i;
  const bool any_q = __any_sync(0xffffffffu, q);
  ArgMax m2{-INFINITY, 1 << 30};
  for (int i = lane; i < n; i += 32)
    m2 = better(m2, ArgMax{i == best ? -INFINITY : pitch_ratio(xc, w, i), i});
  m2 = warp_argmax(m2);
  if (lane == 0) {
    *best_out = best;
    *second_out = m2.v > -INFINITY ? m2.i : (any_q ? 0 : 1);
  }
}

// Warp sums of v into red[k * WARPS + warp]; the caller syncs and adds them.
__device__ __forceinline__ void warp_sums(float v, float* red, int k) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[k * WARPS + threadIdx.x / 32] = v;
}

// Window t of stream b starts at ds[b * ds_stride + first + 240 t]; lane 0
// is w0[t * B + b], or the window's own sample when w0 is null.
__global__ void __launch_bounds__(THREADS)
pitch_kernel(const float* __restrict__ ds, int ds_stride, int first, const float* __restrict__ w0,
             float* __restrict__ cand, int* __restrict__ pidx_out, int B, int T) {
  __shared__ float x[N_DS];  // raw window
  __shared__ float y[N_DS];  // whitened window
  __shared__ float etab[N_LAGS];
  __shared__ float corr[N_LAGS];
  __shared__ float xc4[N_COARSE];
  __shared__ float w4[N_COARSE];
  __shared__ float xc2[N_FINE];
  __shared__ float red[5 * WARPS];
  __shared__ float taps[5];
  __shared__ int sel[3];  // best4, second4, best2

  const int tid = threadIdx.x;
  const int b = blockIdx.x / T;
  const int t = blockIdx.x % T;
  const int row = t * B + b;  // time-major output row

  const float* src = ds + (size_t)b * ds_stride + first + DS_STEP * t;
  for (int i = tid; i < N_DS; i += THREADS) x[i] = i == 0 && w0 != nullptr ? w0[row] : src[i];
  __syncthreads();

  // ---- whitening (ops/pitch.py::whiten, pitch.rs:448-483) ----------------
  float a[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = tid; i < N_DS; i += THREADS) {
    const float xi = x[i];
    a[0] = fmaf(xi, xi, a[0]);
#pragma unroll
    for (int k = 1; k < 5; ++k)
      if (i + k < N_DS) a[k] = fmaf(xi, x[i + k], a[k]);
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
  for (int i = tid; i < N_DS; i += THREADS) {
    float v = x[i];
#pragma unroll
    for (int j = 1; j <= 5; ++j)
      v = __fadd_rn(v, __fmul_rn(taps[j - 1], i >= j ? x[i - j] : 0.f));
    y[i] = v;
  }
  __syncthreads();

  // ---- 385-lag energy table and correlation, direct f32 sums -------------
  {
    int s[LAGS_PER_THREAD];
    float ce[LAGS_PER_THREAD], cc[LAGS_PER_THREAD];
#pragma unroll
    for (int m = 0; m < LAGS_PER_THREAD; ++m) {
      s[m] = min(tid + m * THREADS, N_LAGS - 1);
      ce[m] = 0.f;
      cc[m] = 0.f;
    }
    for (int i = 0; i < FRAME_DS; ++i) {
      const float tv = y[MAXP + i];
#pragma unroll
      for (int m = 0; m < LAGS_PER_THREAD; ++m) {
        const float yv = y[s[m] + i];
        cc[m] = fmaf(tv, yv, cc[m]);
        ce[m] = fmaf(yv, yv, ce[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < LAGS_PER_THREAD; ++m)
      if (tid + m * THREADS < N_LAGS) {
        corr[s[m]] = cc[m];
        etab[s[m]] = ce[m];
      }
  }

  // ---- coarse stage on the 4x-decimated views ----------------------------
  for (int s = tid; s < N_COARSE; s += THREADS) {
    float cx = 0.f, ce = 0.f;
    for (int i = 0; i < LEN4; ++i) {
      const float yv = y[2 * (s + i)];
      cx = fmaf(y[MAXP + 2 * i], yv, cx);
      ce = fmaf(yv, yv, ce);
    }
    xc4[s] = cx;
    w4[s] = ce;
  }
  __syncthreads();
  if (tid < 32) find_best_pitch(xc4, w4, N_COARSE, tid, &sel[0], &sel[1]);
  __syncthreads();

  // ---- fine stage: the shared correlation within +-2 of the picks --------
  const int two_b4 = 2 * sel[0], two_s4 = 2 * sel[1];
  for (int s = tid; s < N_FINE; s += THREADS) {
    const bool near = abs(s - two_b4) <= 2 || abs(s - two_s4) <= 2;
    xc2[s] = near ? fmaxf(corr[s], -1.f) : 0.f;
  }
  __syncthreads();
  int unused_second;
  if (tid < 32) find_best_pitch(xc2, etab, N_FINE, tid, &sel[2], &unused_second);
  __syncthreads();
  if (tid != 0) return;

  // pseudo-interpolation, interior lags only
  const int best2 = sel[2];
  const float pa = xc2[max(best2 - 1, 0)];
  const float pb = xc2[best2];
  const float pc = xc2[min(best2 + 1, N_FINE - 1)];
  int offset = 0;
  if (best2 > 0 && best2 < N_FINE - 1) {
    if (pc - pa > 0.7f * (pb - pa)) offset = 1;
    else if (pa - pc > 0.7f * (pb - pc)) offset = -1;
  }
  const int pidx = MAX_PERIOD - (2 * best2 - offset);
  pidx_out[row] = pidx;

  // ---- octave-removal candidate lanes (ops/pitch.py::doubling_candidates);
  //      pidx >= 181 here, so every lookup is on the tables
  candidate_lanes::write<false>(
      min(pidx / 2, MAXP - 1), fmaxf(etab[MAXP], 0.f), [&](int tt) { return corr[MAXP - tt]; },
      [&](int tt) { return fmaxf(etab[MAXP - tt], 0.f); }, cand + (size_t)row * N_CAND);
}

}  // namespace

// ds: (B, >= 864 + 240T) rows of stride ds_stride; w0: (T, B);
// cand: (T, B, 105); pidx: (T, B).  Returns cudaGetLastError().
extern "C" int nnt_pitch_analysis(const float* ds, int ds_stride, const float* w0, float* cand,
                                  int* pidx, int B, int T, void* stream) {
  pitch_kernel<<<B * T, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(ds, ds_stride, DS_STEP, w0,
                                                                        cand, pidx, B, T);
  return static_cast<int>(cudaGetLastError());
}

// Kernel K3, the counterpart of nnnoiseless_tpu/ops/pitch_kernel.py::
// pitch_analysis_pallas: the same device code on R pre-stacked windows
// (R, 864), each its own frame (T = 1, lane 0 unpatched); cand (R, 105),
// pidx (R,).  Returns cudaGetLastError().
extern "C" int nnt_pitch_analysis_stacked(const float* windows, float* cand, int* pidx, int R,
                                          void* stream) {
  pitch_kernel<<<R, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(windows, N_DS, 0, nullptr,
                                                                    cand, pidx, R, 1);
  return static_cast<int>(cudaGetLastError());
}
