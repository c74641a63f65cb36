// Kernel K2: the whole carry-coupled frame loop of a chunk (sm_90a, FP32
// on CUDA cores).
//
// Replaces the Pallas kernel nnnoiseless_tpu/ops/frame_kernel.py::
// frame_loop_pallas (body _make_frame_kernel, adapter run_fused_scan).  Per
// frame and stream, in the order of ops/frame_kernel.py::frame_loop_plain:
// history shift, lag-0 windowed DFT + band energies + floored log spectrum
// + DCT cepstrum + silence gate, octave removal from the candidate lanes,
// the window at the pitch lag and its DFT, the 42 features, silence
// masking, the RNN with the 201-entry tansig table (the register-tiled
// stages of rnn_tile.cuh, shared with kernel K5), the pitch comb filter
// and renormalization, the gain hangover and interpolation, the inverse
// DFT and overlap-add.
//
// Layout.  One thread block owns a tile of S streams (S warps, 32 S
// threads) and walks all T frames of the chunk in one launch.  The
// carries are read at the start and written at the end; between frames
// they live in shared memory (the synthesis tail in the output carry
// buffer).  The tile's last block masks the streams beyond B instead of
// padding the batch.  The input history is never shifted in memory: after
// frame t it is full[480(t+1) + q] of full = [input_mem | filt_0 | filt_1
// | ...], read by index (hist()).
//
// Transforms.  The TPU kernel's three dense DFT contractions per
// stream-frame (the lag-0 and pitch-lag windows through F (960 x 962), the
// inverse through IV (962 x 960), 2.77 M multiply-adds) are FFTs computed
// in the block (fft960.cuh): one warp per window, 15-point DFTs in
// registers and five radix-2 stages across the lanes, ~22 k flops a
// transform (the function's own, chip_smoke.py::fft960_flops), no basis
// and no block barrier inside a transform.  The S warps take the 2S
// forward windows in two rounds and the S inverses in one, each spectrum a
// 962-float row of shared memory.  The per-bin gain
// interpolation reads each bin's two band weights (BAND_INTERP_MATRIX has
// at most two nonzeros a row, in adjacent bands) in the band order of the
// dense dot, so its result is the dense dot's.
//
// What bounds it.  Bytes in and out are ~4.5 KB per stream-frame (filt,
// cand, the packed output): 1.84 GB at B = 4096, T = 100, 0.55 ms at 3.35
// TB/s.  Operations are ~0.28 MFLOP per stream-frame (the RNN's 87 k
// multiply-adds, three FFTs of ~22 k flops, the band sums; chip_smoke.py's
// kernel_bounds): 113 GFLOP, 1.7 ms at the FP32 peak of 67 TFLOP/s, so
// operations set the bound.  Neither is what the kernel meets: every
// frame is a chain of ~30 block barriers, between which the per-stream
// sections (octave removal, the log-spectrum floor) run on a few threads
// of the block, and the band sums' longest band (160 bins) is a serial
// loop.  So the kernel is latency-bound: its time is T x the per-frame
// critical path x the waves of blocks.  A block owns S = 8 streams (two
// blocks, 16 streams an SM): on an H100 (700 W) at B = 4096, T = 100 the
// kernel took 27.9 ms at S = 8 and 28.4 at S = 4 (PERF.md), so more,
// smaller tiles an SM do not hide the latency.
//
// The RNN stage runs the register tiles of rnn_tile.cuh over the block's
// rows (Cell: 4 outputs x 4 streams a thread, one lane a sum in input
// order, so the sums are those of the scalar loops it replaced, bit for
// bit).  A k step is one 32-bit read-only load of 4 int8 weights, one
// float4 shared load of 4 streams' input, one LOP3, 4 PRMT and 4 FADD to
// widen the weights exactly, and 16 FFMA; over the whole function that is
// 0.16 LDG, 0.20 LDS, 0.13 PRMT and 0.007 I2F per FFMA, against the scalar
// stages' 0.42 LDG (byte loads), 0.38 LDS and 0.22 I2F (kernel_ab.py).
// The weights (pack_tiled, 87.8 KB) stay in global memory and come
// through L1 and L2: the block's 98,992 B of shared memory (the spectra
// 61.6 KB, the RNN's 786 rows of 8 floats, 25.2 KB, in the space the
// per-stream RNN fields took, and the per-stream blocks 11.4 KB) leave no
// room for them at two blocks an SM.  The stage took 15.0 ms of the
// kernel's 27.5 with the scalar stages and 8.2 of 20.6 with the tiles
// (tools/attrib.py's skip stubs, PERF.md); it is latency-bound too: the
// denoise GRU's 144 items (4.5 warps) walk 114 + 96 steps each, at ~36
// instructions a step.  Unrolling 16 steps, loading the weight words 4-16
// steps ahead through a ring of registers, or tiles of 8 streams a thread
// measured no faster.
//
// Stage attribution.  The kernel is a template on a mask of stages to stub
// out (the TPU kernel's `skip` knob, frame_kernel.py:596-756 there), for
// timing each stage by its absence.  Mask 0 is the production kernel:
// every stub is an `if constexpr`.  frame_kernel.cu holds mask 0 and the C
// entry; frame_kernel_skip.cu the seven single-stage masks, so nvcc builds
// them side by side.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fft960.cuh"
#include "rnn_tile.cuh"
#include "smem_once.cuh"

namespace frame {

constexpr int TILE = 8;  // streams per block

// Stages of the skip mask, in the order of ops/frame_kernel.py::SKIP_STAGES.
enum : int {
  SK_RD = 1,     // octave removal: period max(2 t0, 60), gain 0
  SK_LAG0 = 2,   // lag-0 analysis: x = [filt, filt, filt[:2]], ceps = ex, never silent
  SK_DFT = 4,    // pitch-lag window and DFT: p = x
  SK_FEAT = 8,   // features: [ceps, ceps[:20]], unmasked
  SK_RNN = 16,   // RNN: gains |f[:22]| 0.01, vad f[0], states kept
  SK_COMB = 32,  // comb filter: x_comb = x
  SK_INV = 64,   // inverse DFT: out = x_final[:480] + synth, synth kept
};

struct Args {
  const float *tw, *bcorr;  // FFT table (ops/fft.py::fft960_table), band matrix
  const int* branges;
  const float* iw;  // per bin: the weights of bands ib and ib + 1
  const int* ib;
  const float *dct, *tansig;
  const uint8_t* w;  // ops/rnn_kernel.py::pack_tiled, rnn_tile::layout
  const int* acts;
  const float *mem, *synth, *cmem, *hv, *hn, *hd, *lastg;
  const int* per;
  const float* pg;
  const float *filt, *cand;
  float* packed;
  float *mem_o, *synth_o, *cmem_o, *hv_o, *hn_o, *hd_o, *lastg_o;
  int* per_o;
  float* pg_o;
  int B, T;
};

// Launch a single-stage skip instance (frame_kernel_skip.cu);
// returns a CUDA error code, cudaErrorInvalidValue for another mask.
int launch_skip(int skip, const Args& a, cudaStream_t stream);

}  // namespace frame

namespace {

using frame::Args;
using fft960::Cx;

constexpr int FRAME = 480;
constexpr int WIN = 960;
constexpr int FREQ = 481;
constexpr int PACKED = 962;
constexpr int NB = 22;
constexpr int CEPS = 8;
constexpr int DLY = 6;
constexpr int NF = 42;
constexpr int MEM = 1728;
constexpr int OFF = 768;  // MEM - WIN
constexpr int OUT_LANES = 512;
constexpr int OFF_VAD = 480;
constexpr int OFF_PERIOD = 481;
constexpr int OFF_PGAIN = 482;
constexpr int N_CAND = 105;
constexpr int DD = 24, DV = 24, DN = 48, DH = 96, DG = 22;
constexpr float DCT_SCALE = 0.30151134729385376f;  // f32(sqrt(2/22))

// Per-stream block of shared memory (offsets in floats).
enum : int {
  P_CM = 0,                  // (8, 22) cepstral history, newest row first
  P_LASTG = P_CM + CEPS * NB,
  P_EX = P_LASTG + NB,       // band energies of x
  P_EP = P_EX + NB,          // band energies of p
  P_EXP = P_EP + NB,         // band correlation of x and p, then normalized
  P_CEPS = P_EXP + NB,       // cepstrum, dead after the RNN stage's history shift:
  P_NORM = P_CEPS,           // ... then the comb filter's renormalization
  P_LY = P_CEPS + NB,        // log spectrum, later the comb gains r
  P_GAINS = P_LY + NB,
  P_G2 = P_GAINS + NB,
  P_MISC = P_G2 + NB,        // [0] pitch gain [1] vad [2] silence flag
  PS = P_MISC + 4,
};

// The RNN's vectors as rows of the block's S streams (rnn_tile.cuh), row
// stride SP floats.
enum : int {
  R_F = 0,             // the 42 features
  R_D = R_F + NF,      // input dense output
  R_HV = R_D + DD,     // GRU states (vad, noise, denoise: consecutive)
  R_HN = R_HV + DV,
  R_HD = R_HN + DN,
  R_HV2 = R_HD + DH,   // new GRU states before silence masking, in the same order
  R_HN2 = R_HV2 + DV,
  R_HD2 = R_HN2 + DN,
  R_G = R_HD2 + DH,    // GRU scratch (3 x 96 rows); before the RNN, 64 distances a stream
  R_T = R_G + 3 * DH,  // raw sums
  ROWS = R_T + DH,
};
constexpr int TAB = 204;  // tansig table, 201 entries

constexpr int S = frame::TILE;  // streams per block
constexpr int THREADS = 32 * S;
constexpr int SP = S;
// The RNN stage's tile: C streams a thread (4 x C sums a k step), one lane
// a sum in input order, the weights read from global memory, RNN_UNROLL k
// steps unrolled.  On an H100 at B = 4096, T = 100 the kernel took 20.7 ms
// at C = 4 with 8 steps, 21.8 with 4, 22.0 with 16; 23.5 and 24.3 at C = 8
// with 8 and 4 (PERF.md).  The rows' stride is S, 12.6 KB less than K5's
// S + 4: a tile pass reads a row by broadcast, and the elementwise passes'
// consecutive threads take consecutive floats.
constexpr int RNN_C = 4;
constexpr int RNN_UNROLL = 8;
using Cell = rnn_tile::Tile<S, RNN_C, THREADS, 2, SP, true, RNN_UNROLL>;
static_assert(rnn_tile::lanes<Cell>(1) == 1, "K2 sums in input order");
static_assert(NF == rnn_tile::layout::NF && DD == rnn_tile::layout::DD && DV == rnn_tile::layout::DV &&
                  DN == rnn_tile::layout::DN && DH == rnn_tile::layout::DH && DG == rnn_tile::layout::DG,
              "the standard widths");

// Shared memory of a block: 2S spectra, the tansig table, the per-stream
// blocks, the RNN's rows, then S periods and 8 codes.
constexpr size_t SMEM_BYTES =
    (size_t)(2 * S * PACKED + TAB + S * PS + ROWS * SP) * sizeof(float) + (S + 8) * sizeof(int);
static_assert((2 * S * PACKED + TAB + S * PS) % 4 == 0, "the rows are read as float4s");

// Element q of stream b's input history after frame t's shift.
__device__ __forceinline__ float hist(const Args& a, int b, int t, int q) {
  int fi = FRAME * (t + 1) + q;
  if (fi < MEM) return a.mem[(size_t)b * MEM + fi];
  fi -= MEM;
  return a.filt[((size_t)(fi / FRAME) * a.B + b) * FRAME + fi % FRAME];
}

// Band `band` of bands(u * v) over packed spectra (lib.rs:65-82).
__device__ float band_sum(const float* u, const float* v, const Args& a, int band) {
  const float* c = a.bcorr + band * FREQ;
  const int hi = __ldg(a.branges + 2 * band + 1);
  float acc = 0.f;
  for (int j = __ldg(a.branges + 2 * band); j < hi; ++j) {
    const float w = __ldg(c + j);
    acc = fmaf(__fmul_rn(u[j], v[j]), w, acc);
    acc = fmaf(__fmul_rn(u[FREQ + j], v[FREQ + j]), w, acc);
  }
  return acc;
}

// Band values interpolated to one bin (lib.rs:84-97): the bin's two
// nonzero weights, in the band order of the dense dot.
__device__ __forceinline__ float interp_at(const Args& a, const float* v, int bin) {
  const float2 w = __ldg(reinterpret_cast<const float2*>(a.iw) + bin);
  const int b = __ldg(a.ib + bin);
  return fmaf(w.y, v[b + 1], __fmul_rn(w.x, v[b]));
}

// ops/pitch.py::remove_doubling_from_candidates: the sequential k = 2..15
// chain with the previous frame's continuity bonus (pitch.rs:173-221).
__device__ void remove_doubling(const float* cand, int last_period, float last_gain, int* period,
                                float* gain) {
  const float minp = 30.f;
  const float t0 = cand[0], g0 = cand[1];
  const float prev = floorf((float)last_period * 0.5f);
  float bxy = cand[2], byy = cand[3], t = t0, g = g0;
  int bidx = 0;
  bool stopped = false;
  for (int k = 2; k < 16; ++k) {
    const float t1 = cand[4 + k - 2];
    const bool active = !stopped && t1 >= minp;
    stopped = stopped || t1 < minp;
    const float xy = cand[18 + k - 2], yy = cand[32 + k - 2], g1 = cand[46 + k - 2];
    const float adiff = fabsf(t1 - prev);
    const float cont = adiff <= 1.f ? last_gain
                       : (adiff <= 2.f && (float)(5 * k * k) < t0) ? last_gain * 0.5f : 0.f;
    // the middle branch is shadowed by the first, as in the reference
    const float thresh = t1 < 3.f * minp ? fmaxf(__fsub_rn(__fmul_rn(0.85f, g0), cont), 0.4f)
                         : t1 < 2.f * minp ? fmaxf(__fsub_rn(__fmul_rn(0.9f, g0), cont), 0.5f)
                                           : fmaxf(__fsub_rn(__fmul_rn(0.7f, g0), cont), 0.3f);
    if (active && g1 > thresh) {
      bxy = xy;
      byy = yy;
      t = t1;
      g = g1;
      bidx = k - 1;
    }
  }
  bxy = fmaxf(bxy, 0.f);
  float pg = byy <= bxy ? 1.f : bxy / (byy + 1.f);
  const float c0 = cand[60 + bidx], c1 = cand[75 + bidx], c2 = cand[90 + bidx];
  const float offset = (c2 - c0 > __fmul_rn(0.7f, c1 - c0))   ? 1.f
                       : (c0 - c2 > __fmul_rn(0.7f, c1 - c2)) ? -1.f
                                                               : 0.f;
  *gain = fminf(pg, g);
  *period = (int)fmaxf(2.f * t + offset, 60.f);
}

template <int SKIP>
__global__ void __launch_bounds__(THREADS, 2) frame_kernel(const Args a) {
  using namespace frame;
  namespace L = rnn_tile::layout;
  // forward FFT rows: the lag-0 windows unless SK_LAG0, the pitch-lag
  // windows unless SK_DFT
  constexpr bool LAG0_ROWS = !(SKIP & SK_LAG0);
  constexpr bool PITCH_ROWS = !(SKIP & SK_DFT);
  constexpr int NR = (LAG0_ROWS ? S : 0) + (PITCH_ROWS ? S : 0);
  extern __shared__ float4 smem4[];
  float* U = reinterpret_cast<float*>(smem4);  // (2S, 962) spectra
  float* tab = U + 2 * S * PACKED;
  float* ps = tab + TAB;
  float* R = ps + S * PS;  // (ROWS, SP) RNN rows
  int* iper = reinterpret_cast<int*>(R + ROWS * SP);
  int* acts = iper + S;
  auto row = [&](int r, int j, int s) -> float& { return R[(r + j) * SP + s]; };

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int b0 = blockIdx.x * S;
  const int n_valid = min(S, a.B - b0);

  // ---- carries in ---------------------------------------------------------
  for (int i = tid; i < 201; i += THREADS) tab[i] = a.tansig[i];
  if (tid < 6) acts[tid] = a.acts[tid];
  for (int i = tid; i < S * PS + ROWS * SP; i += THREADS) ps[i] = 0.f;  // R follows ps
  __syncthreads();
  auto load = [&](const float* src, int n, int off) {
    for (int idx = tid; idx < n_valid * n; idx += THREADS)
      ps[(idx / n) * PS + off + idx % n] = src[(size_t)b0 * n + idx];
  };
  auto load_rows = [&](const float* src, int n, int r0) {
    for (int idx = tid; idx < n_valid * n; idx += THREADS)
      row(r0, idx % n, idx / n) = src[(size_t)b0 * n + idx];
  };
  load(a.cmem, CEPS * NB, P_CM);
  load_rows(a.hv, DV, R_HV);
  load_rows(a.hn, DN, R_HN);
  load_rows(a.hd, DH, R_HD);
  load(a.lastg, NB, P_LASTG);
  if (tid < S) {
    iper[tid] = tid < n_valid ? a.per[b0 + tid] : 0;
    if (tid < n_valid) ps[tid * PS + P_MISC] = a.pg[b0 + tid];
  }
  for (int idx = tid; idx < n_valid * FRAME; idx += THREADS)
    a.synth_o[(size_t)b0 * FRAME + idx] = a.synth[(size_t)b0 * FRAME + idx];
  __syncthreads();

  const uint8_t* W = a.w;
  const float* X = U;          // lag-0 spectra, rows 0..S-1
  float* P = U + S * PACKED;   // pitch-lag spectra, rows S..2S-1

  for (int t = 0; t < a.T; ++t) {
    const size_t row0 = (size_t)t * a.B + b0;  // (t, b0) row of cand/packed

    // ---- octave removal ---------------------------------------------------
    if (tid < n_valid) {
      float* p = ps + tid * PS;
      int per;
      float pg;
      const float* cand = a.cand + (row0 + tid) * N_CAND;
      if constexpr (SKIP & SK_RD) {
        per = max(2 * (int)cand[0], 60);
        pg = cand[1] * 0.f;
      } else {
        remove_doubling(cand, iper[tid], p[P_MISC], &per, &pg);
      }
      iper[tid] = per;
      p[P_MISC] = pg;
      float* out = a.packed + (row0 + tid) * OUT_LANES;
      out[OFF_PERIOD] = (float)per;
      out[OFF_PGAIN] = pg;
      for (int l = OFF_PGAIN + 1; l < OUT_LANES; ++l) out[l] = 0.f;
    }
    __syncthreads();

    // ---- forward FFTs: warp w takes windows w and w + S of the NR; window r
    //      fills spectrum row r (r < S: the lag-0 window mem[768 + k] of
    //      stream r; r >= S: the pitch window mem[768 - period + k] of stream
    //      r - S), or pitch row S + r when the lag-0 rows are stubbed out
    for (int r = warp; r < NR; r += S) {
      const int row = LAG0_ROWS ? r : S + r;
      const int s = row % S;
      const int q0 = row < S ? OFF : OFF - iper[s];
      Cx v[fft960::N1];
#pragma unroll
      for (int n1 = 0; n1 < fft960::N1; ++n1) {
        const int q = q0 + 64 * n1 + 2 * lane;
        v[n1] = s < n_valid ? Cx{hist(a, b0 + s, t, q), hist(a, b0 + s, t, q + 1)} : Cx{0.f, 0.f};
      }
      fft960::forward(v, a.tw, U + row * PACKED);
    }
    __syncthreads();
    if constexpr (SKIP & SK_LAG0) {  // x = [filt, filt, filt[:2]] of this frame
      for (int idx = tid; idx < S * PACKED; idx += THREADS) {
        const int s = idx / PACKED, j = idx % PACKED;
        U[idx] = s < n_valid ? a.filt[((size_t)t * a.B + b0 + s) * FRAME + j % FRAME] : 0.f;
      }
      __syncthreads();
    }
    if constexpr (SKIP & SK_DFT) {  // p = x
      for (int idx = tid; idx < S * PACKED; idx += THREADS) P[idx] = X[idx];
      __syncthreads();
    }

    // ---- band energies and correlation -------------------------------------
    for (int idx = tid; idx < S * NB; idx += THREADS) {
      const int s = idx / NB, bd = idx % NB;
      float* p = ps + s * PS;
      const float* x = X + s * PACKED;
      const float* pp = P + s * PACKED;
      p[P_EX + bd] = band_sum(x, x, a, bd);
      p[P_EP + bd] = band_sum(pp, pp, a, bd);
      p[P_EXP + bd] = band_sum(x, pp, a, bd);
    }
    __syncthreads();

    // ---- floored log spectrum and the silence gate (features.rs:147-166) --
    if constexpr (SKIP & SK_LAG0) {
      if (tid < S) ps[tid * PS + P_MISC + 2] = 0.f;
    } else if (tid < S) {
      float* p = ps + tid * PS;
      float log_max = -2.f, follow = -2.f, e = 0.f;
      for (int i = 0; i < NB; ++i) {
        const float raw = log10f(0.01f + p[P_EX + i]);
        const float v = fmaxf(fmaxf(raw, log_max - 7.f), follow - 1.5f);
        log_max = fmaxf(log_max, v);
        follow = fmaxf(follow - 1.5f, v);
        p[P_LY + i] = v;
        e += p[P_EX + i];
      }
      p[P_MISC + 2] = e < 0.04f ? 1.f : 0.f;
    }
    __syncthreads();

    // ---- cepstrum and normalized band correlation --------------------------
    for (int idx = tid; idx < S * NB; idx += THREADS) {
      const int s = idx / NB, i = idx % NB;
      float* p = ps + s * PS;
      if constexpr (SKIP & SK_LAG0) {
        p[P_CEPS + i] = p[P_EX + i];
      } else {
        float acc = 0.f;
        for (int j = 0; j < NB; ++j) acc = fmaf(p[P_LY + j], __ldg(a.dct + j * NB + i), acc);
        float c = __fmul_rn(acc, DCT_SCALE);
        if (i == 0) c = __fadd_rn(c, -12.f);
        if (i == 1) c = __fadd_rn(c, -4.f);
        p[P_CEPS + i] = c;
      }
      p[P_EXP + i] = p[P_EXP + i] / sqrtf(__fadd_rn(0.001f, __fmul_rn(p[P_EX + i], p[P_EP + i])));
    }
    __syncthreads();

    // ---- squared distances between the rows of the new cepstral history ----
    float* dist = R + R_G * SP;  // (S, 8, 8)
    for (int idx = tid; !(SKIP & SK_FEAT) && idx < S * CEPS * CEPS; idx += THREADS) {
      const int s = idx / (CEPS * CEPS), i = (idx / CEPS) % CEPS, j = idx % CEPS;
      float* p = ps + s * PS;
      const float* ri = i == 0 ? p + P_CEPS : p + P_CM + (i - 1) * NB;
      const float* rj = j == 0 ? p + P_CEPS : p + P_CM + (j - 1) * NB;
      float d = 0.f;
      for (int k = 0; k < NB; ++k) {
        const float v = __fsub_rn(ri[k], rj[k]);
        d = fmaf(v, v, d);
      }
      dist[idx] = d;
    }
    __syncthreads();

    // ---- the 42 features (features.rs:139-216), zero on silence, to their rows
    for (int idx = tid; idx < S * NF; idx += THREADS) {
      const int s = idx / NF, l = idx % NF;
      float* p = ps + s * PS;
      const float* ceps = p + P_CEPS;
      if constexpr (SKIP & SK_FEAT) {
        row(R_F, l, s) = ceps[l < NB ? l : l - NB];
        continue;
      }
      const float* c1 = p + P_CM;       // previous frame
      const float* c2 = p + P_CM + NB;  // two frames back
      float v;
      if (l < DLY) {
        v = __fadd_rn(__fadd_rn(ceps[l], c1[l]), c2[l]);
      } else if (l < NB) {
        v = ceps[l];
      } else if (l < NB + DLY) {
        v = __fsub_rn(ceps[l - NB], c2[l - NB]);
      } else if (l < NB + 2 * DLY) {
        const int i = l - NB - DLY;
        v = __fadd_rn(__fsub_rn(ceps[i], 2.f * c1[i]), c2[i]);
      } else if (l < NB + 3 * DLY) {
        const int i = l - NB - 2 * DLY;
        float acc = 0.f;
        for (int j = 0; j < NB; ++j) acc = fmaf(p[P_EXP + j], __ldg(a.dct + j * NB + i), acc);
        v = __fmul_rn(acc, DCT_SCALE);
        if (i == 0) v = __fadd_rn(v, -1.3f);
        if (i == 1) v = __fadd_rn(v, -0.9f);
      } else if (l == NF - 2) {
        v = __fmul_rn(0.01f, __fsub_rn((float)iper[s], 300.f));
      } else {
        float sum = 0.f;
        for (int i = 0; i < CEPS; ++i) {
          float m = INFINITY;
          for (int j = 0; j < CEPS; ++j)
            if (j != i) m = fminf(m, dist[(s * CEPS + i) * CEPS + j]);
          sum += m;
        }
        v = __fsub_rn(sum / (float)CEPS, 2.1f);
      }
      row(R_F, l, s) = p[P_MISC + 2] != 0.f ? 0.f : v;
    }
    __syncthreads();

    // ---- RNN (rnn.rs:343-379); the cepstral history shifts unless silent --
    if (tid < S && ps[tid * PS + P_MISC + 2] == 0.f) {
      float* p = ps + tid * PS;
      for (int l = CEPS * NB - 1; l >= NB; --l) p[P_CM + l] = p[P_CM + l - NB];
      for (int i = 0; i < NB; ++i) p[P_CM + i] = p[P_CEPS + i];
    }
    if constexpr (SKIP & SK_RNN) {
      for (int idx = tid; idx < S * NB; idx += THREADS) {
        const int s = idx / NB, i = idx % NB;
        ps[s * PS + P_GAINS + i] = __fmul_rn(fabsf(row(R_F, i, s)), 0.01f);
      }
      if (tid < S) ps[tid * PS + P_MISC + 1] = row(R_F, 0, tid);
      __syncthreads();
    } else {
    // the tiles of rnn_tile.cuh over the block's rows; a GRU's inputs are
    // runs of rows summed in turn, in the input order of [d, hv', f] and
    // [hv', hn', f]
    using rnn_tile::Runs;
    float* G = R + R_G * SP;
    float* TMP = R + R_T * SP;
    rnn_tile::dense<Cell, DD>(Runs<NF>{{R + R_F * SP}}, W + L::O_DENSE, TMP, acts[0], tab, n_valid,
                              [&](int j, int s, float v) { row(R_D, j, s) = v; });
    __syncthreads();
    rnn_tile::gru_gates<Cell, DV>(Runs<DD>{{R + R_D * SP}}, R + R_HV * SP, W + L::O_VAD, G, tab, n_valid);
    __syncthreads();
    rnn_tile::gru_out<Cell, DD, DV>(R + R_HV * SP, W + L::O_VAD, G, TMP, acts[1], tab, n_valid,
                                    [&](int j, int s, float v) { row(R_HV2, j, s) = v; });
    __syncthreads();
    rnn_tile::dense<Cell, 1>(Runs<DV>{{R + R_HV2 * SP}}, W + L::O_VADH, TMP, acts[5], tab, n_valid,
                             [&](int, int s, float v) { ps[s * PS + P_MISC + 1] = v; });
    rnn_tile::gru_gates<Cell, DN>(Runs<DD, DV, NF>{{R + R_D * SP, R + R_HV2 * SP, R + R_F * SP}},
                                  R + R_HN * SP, W + L::O_NOISE, G, tab, n_valid);
    __syncthreads();
    rnn_tile::gru_out<Cell, L::NIN_NOISE, DN>(R + R_HN * SP, W + L::O_NOISE, G, TMP, acts[2], tab, n_valid,
                                              [&](int j, int s, float v) { row(R_HN2, j, s) = v; });
    __syncthreads();
    rnn_tile::gru_gates<Cell, DH>(Runs<DV, DN, NF>{{R + R_HV2 * SP, R + R_HN2 * SP, R + R_F * SP}},
                                  R + R_HD * SP, W + L::O_DEN, G, tab, n_valid);
    __syncthreads();
    rnn_tile::gru_out<Cell, L::NIN_DEN, DH>(R + R_HD * SP, W + L::O_DEN, G, TMP, acts[3], tab, n_valid,
                                            [&](int j, int s, float v) { row(R_HD2, j, s) = v; });
    __syncthreads();
    rnn_tile::dense<Cell, DG>(Runs<DH>{{R + R_HD2 * SP}}, W + L::O_GAIN, TMP, acts[4], tab, n_valid,
                              [&](int j, int s, float v) { ps[s * PS + P_GAINS + j] = v; });
    // silence keeps the GRU states
    for (int idx = tid; idx < (DV + DN + DH) * S; idx += THREADS) {
      const int j = idx / S, s = idx % S;
      if (ps[s * PS + P_MISC + 2] == 0.f) row(R_HV, j, s) = row(R_HV2, j, s);
    }
    }  // SK_RNN
    if (tid < n_valid) {
      const float* p = ps + tid * PS;
      a.packed[(row0 + tid) * OUT_LANES + OFF_VAD] = p[P_MISC + 2] != 0.f ? 0.f : p[P_MISC + 1];
    }
    __syncthreads();

    // ---- pitch comb filter gains and the gain hangover (features.rs:223-257)
    for (int idx = tid; idx < S * NB; idx += THREADS) {
      const int s = idx / NB, i = idx % NB;
      float* p = ps + s * PS;
      const float g = p[P_GAINS + i], e = p[P_EXP + i];
      if constexpr (!(SKIP & SK_COMB)) {
        const float g_sq = __fmul_rn(g, g), e_sq = __fmul_rn(e, e);
        float r = e > g ? 1.f
                        : __fmul_rn(e_sq, __fsub_rn(1.f, g_sq)) /
                              __fadd_rn(0.001f, __fmul_rn(g_sq, __fsub_rn(1.f, e_sq)));
        r = sqrtf(fminf(fmaxf(r, 0.f), 1.f));
        p[P_LY + i] = __fmul_rn(r, sqrtf(p[P_EX + i] / __fadd_rn(1e-8f, p[P_EP + i])));
      }
      p[P_G2 + i] = fmaxf(g, __fmul_rn(0.6f, p[P_LASTG + i]));
    }
    __syncthreads();
    // x1 = x + p * interp(r), in place of p (x1 = x without the comb filter)
    if constexpr (!(SKIP & SK_COMB)) {
      for (int idx = tid; idx < S * PACKED; idx += THREADS) {
        const int s = idx / PACKED, j = idx % PACKED;
        float* pp = P + s * PACKED;
        pp[j] = fmaf(pp[j], interp_at(a, ps + s * PS + P_LY, j % FREQ), X[s * PACKED + j]);
      }
      __syncthreads();
    }
    for (int idx = tid; idx < S * NB; idx += THREADS) {
      const int s = idx / NB, i = idx % NB;
      float* p = ps + s * PS;
      if constexpr (!(SKIP & SK_COMB)) {
        const float* x1 = P + s * PACKED;
        const float new_e = band_sum(x1, x1, a, i);
        p[P_NORM + i] = sqrtf(p[P_EX + i] / __fadd_rn(1e-8f, new_e));
      }
      if (p[P_MISC + 2] == 0.f) p[P_LASTG + i] = p[P_G2 + i];
    }
    __syncthreads();
    // x_final = silent ? x : x1 * interp(norm) * interp(g2), in place of x1
    for (int idx = tid; idx < S * PACKED; idx += THREADS) {
      const int s = idx / PACKED, j = idx % PACKED;
      const float* p = ps + s * PS;
      float* pp = P + s * PACKED;
      if constexpr (SKIP & SK_COMB) {
        pp[j] = p[P_MISC + 2] != 0.f ? X[s * PACKED + j]
                                     : __fmul_rn(X[s * PACKED + j], interp_at(a, p + P_G2, j % FREQ));
      } else {
        pp[j] = p[P_MISC + 2] != 0.f
                    ? X[s * PACKED + j]
                    : __fmul_rn(__fmul_rn(pp[j], interp_at(a, p + P_NORM, j % FREQ)),
                                interp_at(a, p + P_G2, j % FREQ));
      }
    }
    __syncthreads();
    if constexpr (SKIP & SK_INV) {  // out = x_final[:480] + synth; synth kept
      for (int idx = tid; idx < n_valid * FRAME; idx += THREADS) {
        const int s = idx / FRAME, c = idx % FRAME;
        a.packed[(row0 + s) * OUT_LANES + c] =
            __fadd_rn(P[s * PACKED + c], a.synth_o[(size_t)(b0 + s) * FRAME + c]);
      }
      __syncthreads();
      continue;
    }
    // ---- inverse FFTs and overlap-add: warp s takes stream s; the head
    //      (samples < 480) adds the synthesis memory, then the tail replaces it
    if (warp < n_valid) {
      Cx v[fft960::N1];
      fft960::inverse(P + warp * PACKED, a.tw, v);
      float* so = a.synth_o + (size_t)(b0 + warp) * FRAME;
      float* out = a.packed + (row0 + warp) * OUT_LANES;
#pragma unroll
      for (int n1 = 0; n1 < 8; ++n1) {
        const int n = 64 * n1 + 2 * lane;
        if (n < FRAME) {
          const float2 m = *reinterpret_cast<const float2*>(so + n);
          *reinterpret_cast<float2*>(out + n) = make_float2(__fadd_rn(v[n1].r, m.x), __fadd_rn(v[n1].i, m.y));
        }
      }
      __syncwarp();
#pragma unroll
      for (int n1 = 7; n1 < fft960::N1; ++n1) {
        const int n = 64 * n1 + 2 * lane;
        if (n >= FRAME) *reinterpret_cast<float2*>(so + n - FRAME) = make_float2(v[n1].r, v[n1].i);
      }
    }
    __syncthreads();
  }

  // ---- carries out ----------------------------------------------------------
  for (int idx = tid; idx < n_valid * MEM; idx += THREADS)
    a.mem_o[(size_t)b0 * MEM + idx] = hist(a, b0 + idx / MEM, a.T - 1, idx % MEM);
  auto store = [&](float* dst, int n, int off) {
    for (int idx = tid; idx < n_valid * n; idx += THREADS)
      dst[(size_t)b0 * n + idx] = ps[(idx / n) * PS + off + idx % n];
  };
  auto store_rows = [&](float* dst, int n, int r0) {
    for (int idx = tid; idx < n_valid * n; idx += THREADS)
      dst[(size_t)b0 * n + idx] = row(r0, idx % n, idx / n);
  };
  store(a.cmem_o, CEPS * NB, P_CM);
  store_rows(a.hv_o, DV, R_HV);
  store_rows(a.hn_o, DN, R_HN);
  store_rows(a.hd_o, DH, R_HD);
  store(a.lastg_o, NB, P_LASTG);
  if (tid < n_valid) {
    a.per_o[b0 + tid] = iper[tid];
    a.pg_o[b0 + tid] = ps[tid * PS + P_MISC];
  }
}

template <int SKIP>
int launch(const Args& a, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = smem_once(frame_kernel<SKIP>, (int)SMEM_BYTES, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  frame_kernel<SKIP><<<(a.B + S - 1) / S, THREADS, SMEM_BYTES, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
