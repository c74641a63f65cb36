// The windowed 960-point real FFT of kernel K2, one warp per window (sm_90a,
// FP32 on CUDA cores).  Device functions shared by K2 (frame_kernel.cuh)
// and its probe entries (fft960_kernel.cu).
//
// The functions are those of ops/fft.py::forward_transform and
// inverse_transform (the dense bases F and IV of the TPU kernel): forward,
// rfft(x * window) * wnorm into the packed [re(481) | im(481)] layout;
// inverse, the hermitian inverse DFT / 2 times the window (the imaginary
// parts of bins 0 and 480 read as 0, as IV reads them).
//
// Design.  The real transform is a 480-point complex FFT of z[m] = x[2m] +
// i x[2m + 1] plus a split step.  480 = 15 x 32 with n = 32 n1 + n2 and
// k = k1 + 15 k2: lane n2 holds z[32 n1 + n2] for n1 = 0..14 in registers
// (coalesced loads), runs the 15-point DFT over n1 as 3 x 5 prime factors
// (no twiddles), multiplies by W480^(n2 k1), and the 32-point DFT over
// n2 runs across the lanes as five radix-2 stages by __shfl_xor_sync
// (decimation in frequency: lane l ends with Z[k1 + 15 bitrev5(l)]).  The
// split pairs Z[k] with Z[480 - k], which sits in lane l ^ 31, register
// 15 - k1 (register 0 of one lane for k1 = 0): one more shuffle each.  The
// inverse is the adjoint of the same stages in reverse order with
// conjugate twiddles.  No block barrier: a warp owns its window, and the
// spectrum goes to (comes from) one 962-float row of shared memory, where
// lane l's bins k1 + 15 bitrev5(l) fall in 32 different banks.
//
// Twiddles come from the f32 table of ops/fft.py::fft960_table (built in
// f64, rounded once), read through L1 as float2, each warp load one
// 256-byte line; nothing is computed with __sinf.  Arithmetic is f32.
// Per window a lane does ~1,330 flops (an FMA counted as two) and 180
// shuffles, ~43 k flops a warp: both lanes of a radix-2 pair form their
// own sum or difference, and trivial twiddles are multiplied too.  The
// transform itself needs ~22 k (chip_smoke.py::fft960_flops), against the
// dense product's 1.85 M.

#pragma once

#include <cuda_runtime.h>

namespace fft960 {

constexpr int N1 = 15;
constexpr int FREQ = 481;
// float offsets into the table (ops/fft.py TW_*)
constexpr int TW_WIN = 0, TW_480 = 960, TW_32 = 1920, TW_SPLIT = 2240, TW_CONST = 3200;
constexpr unsigned FULL = 0xffffffffu;

struct Cx {
  float r, i;
};

__device__ __forceinline__ Cx cmul(Cx a, Cx b) { return {a.r * b.r - a.i * b.i, a.r * b.i + a.i * b.r}; }
// a * conj(b)
__device__ __forceinline__ Cx cmulc(Cx a, Cx b) { return {a.r * b.r + a.i * b.i, a.i * b.r - a.r * b.i}; }

// Complex entry `idx` of the table, counted from the float offset `off`.
__device__ __forceinline__ Cx tw(const float* t, int off, int idx) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(t + off) + idx);
  return {v.x, v.y};
}

// The 15-point DFT of v (forward e^-, or inverse e^+) as 3 x 5 prime
// factors: input n = (5a + 3b) mod 15, output k = (10c + 6d) mod 15.
template <bool INV>
__device__ __forceinline__ void pfa15(Cx (&v)[N1], const float* t) {
  const float s3 = __ldg(t + TW_CONST), c51 = __ldg(t + TW_CONST + 1), c52 = __ldg(t + TW_CONST + 2);
  const float s51 = __ldg(t + TW_CONST + 3), s52 = __ldg(t + TW_CONST + 4);
  Cx a[5][3];
#pragma unroll
  for (int b = 0; b < 5; ++b) {
    const Cx x0 = v[(3 * b) % 15], x1 = v[(5 + 3 * b) % 15], x2 = v[(10 + 3 * b) % 15];
    const Cx s = {x1.r + x2.r, x1.i + x2.i};
    const Cx m = {x0.r - 0.5f * s.r, x0.i - 0.5f * s.i};
    const Cx d = {s3 * (x1.r - x2.r), s3 * (x1.i - x2.i)};
    a[b][0] = {x0.r + s.r, x0.i + s.i};
    if (INV) {
      a[b][1] = {m.r - d.i, m.i + d.r};
      a[b][2] = {m.r + d.i, m.i - d.r};
    } else {
      a[b][1] = {m.r + d.i, m.i - d.r};
      a[b][2] = {m.r - d.i, m.i + d.r};
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const Cx x0 = a[0][c], x1 = a[1][c], x2 = a[2][c], x3 = a[3][c], x4 = a[4][c];
    const Cx t1 = {x1.r + x4.r, x1.i + x4.i}, t2 = {x2.r + x3.r, x2.i + x3.i};
    const Cx t3 = {x1.r - x4.r, x1.i - x4.i}, t4 = {x2.r - x3.r, x2.i - x3.i};
    const Cx a1 = {x0.r + c51 * t1.r + c52 * t2.r, x0.i + c51 * t1.i + c52 * t2.i};
    const Cx a2 = {x0.r + c52 * t1.r + c51 * t2.r, x0.i + c52 * t1.i + c51 * t2.i};
    const Cx b1 = {s51 * t3.r + s52 * t4.r, s51 * t3.i + s52 * t4.i};
    const Cx b2 = {s52 * t3.r - s51 * t4.r, s52 * t3.i - s51 * t4.i};
    const float sg = INV ? 1.f : -1.f;  // y_d = a -/+ i b with e^(sg i theta)
    v[(10 * c) % 15] = {x0.r + t1.r + t2.r, x0.i + t1.i + t2.i};
    v[(10 * c + 6) % 15] = {a1.r - sg * b1.i, a1.i + sg * b1.r};
    v[(10 * c + 12) % 15] = {a2.r - sg * b2.i, a2.i + sg * b2.r};
    v[(10 * c + 18) % 15] = {a2.r + sg * b2.i, a2.i - sg * b2.r};
    v[(10 * c + 24) % 15] = {a1.r + sg * b1.i, a1.i - sg * b1.r};
  }
}

// Bit-reversed lane: lane l holds bins k1 + 15 bitrev5(l) between the two
// halves of a transform.
__device__ __forceinline__ int bitrev5(int l) { return static_cast<int>(__brev(l) >> 27); }

// Forward.  In: v[n1] = (x[64 n1 + 2 l], x[64 n1 + 2 l + 1]) of the raw
// window on lane l.  Out: the packed spectrum of rfft(x * window) * wnorm
// in row[0, 962) (shared memory; the caller syncs the warp before other
// lanes read it).  Clobbers v.
__device__ __forceinline__ void forward(Cx (&v)[N1], const float* __restrict__ t, float* row) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int n1 = 0; n1 < N1; ++n1) {
    const Cx w = tw(t, TW_WIN, 32 * n1 + l);
    v[n1] = {v[n1].r * w.r, v[n1].i * w.i};
  }
  pfa15<false>(v, t);
#pragma unroll
  for (int k1 = 1; k1 < N1; ++k1) v[k1] = cmul(v[k1], tw(t, TW_480, 32 * k1 + l));
#pragma unroll
  for (int s = 0; s < 5; ++s) {  // DIF: t = partner +- own, times the stage twiddle
    const int d = 16 >> s;
    const float sgn = (l & d) ? -1.f : 1.f;
    const Cx w = tw(t, TW_32, 32 * s + l);
#pragma unroll
    for (int k = 0; k < N1; ++k) {
      const float pr = __shfl_xor_sync(FULL, v[k].r, d), pi = __shfl_xor_sync(FULL, v[k].i, d);
      v[k] = cmul({fmaf(sgn, v[k].r, pr), fmaf(sgn, v[k].i, pi)}, w);
    }
  }
  // the split: X[k] = wnorm/2 ((A + B) - i W960^k (A - B)), A = Z[k], B = conj(Z[480 - k])
  Cx p[N1];
  const int src0 = bitrev5((32 - bitrev5(l)) & 31);
  p[0] = {__shfl_sync(FULL, v[0].r, src0), __shfl_sync(FULL, v[0].i, src0)};
#pragma unroll
  for (int k1 = 1; k1 < N1; ++k1)
    p[k1] = {__shfl_xor_sync(FULL, v[N1 - k1].r, 31), __shfl_xor_sync(FULL, v[N1 - k1].i, 31)};
  const float half = __ldg(t + TW_CONST + 5);
  const int kb = N1 * bitrev5(l);
#pragma unroll
  for (int k1 = 0; k1 < N1; ++k1) {
    const Cx s = {v[k1].r + p[k1].r, v[k1].i - p[k1].i}, d = {v[k1].r - p[k1].r, v[k1].i + p[k1].i};
    const Cx w = tw(t, TW_SPLIT, 32 * k1 + l);
    row[kb + k1] = half * (s.r + (w.r * d.i + w.i * d.r));
    row[FREQ + kb + k1] = half * (s.i - (w.r * d.r - w.i * d.i));
    if (k1 == 0 && l == 0) {  // bin 480 from Z[0]
      row[FREQ - 1] = half * (s.r - d.i);
      row[2 * FREQ - 1] = 0.f;
    }
  }
}

// Inverse.  In: the packed spectrum in row[0, 962) (shared memory, written
// before a warp or block sync).  Out: v[n1] = (y[64 n1 + 2 l], y[64 n1 +
// 2 l + 1]) of y = the hermitian inverse DFT / 2 times the window.
__device__ __forceinline__ void inverse(const float* row, const float* __restrict__ t, Cx (&v)[N1]) {
  const int l = threadIdx.x & 31;
  const int kb = N1 * bitrev5(l);
  // Z'[k] = E + i O: E = A + B, O = (A - B) conj(W960^k), A = X[k], B = conj(X[480 - k])
#pragma unroll
  for (int k1 = 0; k1 < N1; ++k1) {
    const int k = kb + k1;
    const Cx a = {row[k], k ? row[FREQ + k] : 0.f};
    const Cx b = {row[FREQ - 1 - k], k ? -row[2 * FREQ - 1 - k] : 0.f};
    const Cx o = cmulc({a.r - b.r, a.i - b.i}, tw(t, TW_SPLIT, 32 * k1 + l));
    v[k1] = {a.r + b.r - o.i, a.i + b.i + o.r};
  }
#pragma unroll
  for (int s = 4; s >= 0; --s) {  // the adjoint stages: m = own conj(w), partner +- m
    const int d = 16 >> s;
    const float sgn = (l & d) ? -1.f : 1.f;
    const Cx w = tw(t, TW_32, 32 * s + l);
#pragma unroll
    for (int k = 0; k < N1; ++k) {
      const Cx m = cmulc(v[k], w);
      const float pr = __shfl_xor_sync(FULL, m.r, d), pi = __shfl_xor_sync(FULL, m.i, d);
      v[k] = {fmaf(sgn, m.r, pr), fmaf(sgn, m.i, pi)};
    }
  }
#pragma unroll
  for (int k1 = 1; k1 < N1; ++k1) v[k1] = cmulc(v[k1], tw(t, TW_480, 32 * k1 + l));
  pfa15<true>(v, t);
#pragma unroll
  for (int n1 = 0; n1 < N1; ++n1) {
    const Cx w = tw(t, TW_WIN, 32 * n1 + l);
    v[n1] = {0.5f * (v[n1].r * w.r), 0.5f * (v[n1].i * w.i)};
  }
}

}  // namespace fft960
