// The 105 octave-removal candidate lanes of one window (ops/pitch.py::
// doubling_candidates layout, pitch.rs:118-221), shared by kernel K1/K3
// (csrc/pitch_kernel.cu, tables in shared memory) and kernel K4
// (csrc/candidates_kernel.cu, tables in global memory).
//
//   [0] t0  [1] g0  [2] xy0  [3] yy0
//   [4:18] t1 (k = 2..15)  [18:32] xy_k  [32:46] yy_k  [46:60] g1_k
//   [60:75] corr_at(c - 1)  [75:90] corr_at(c)  [90:105] corr_at(c + 1)
//   for c in [t0, t1_2 .. t1_15]
//
// corr_at(t) and yy_at(t) are the caller's accessors; each caller keeps
// its own table layout and its own rule for lookups off the table.
#pragma once

namespace candidate_lanes {

constexpr int MAXP = 384;
constexpr int N_CAND = 105;
constexpr int N_WALK = 15;  // candidates: t0, then t1 of k = 2..15

__constant__ int SECOND_CHECK[16] = {0, 0, 3, 2, 3, 2, 5, 2, 3, 2, 3, 2, 5, 2, 3, 2};

// a // b rounded toward minus infinity for b > 0 (Python's and XLA's
// integer floor division); FLOOR = false is C's truncation, the same for
// a >= 0.
template <bool FLOOR>
__device__ __forceinline__ int idiv(int a, int b) {
  if (FLOOR && a < 0) return -((b - 1 - a) / b);
  return a / b;
}

// The lanes of candidate c < N_WALK: c = 0 is t0 (lanes 0-3), c >= 1 the
// t1 of k = c + 1 (lanes 4, 18, 32, 46 + c - 1); then the candidate's
// three correlation lanes 60, 75, 90 + c.  Candidates are independent, so
// one thread may walk all of them or 15 threads one each.
template <bool FLOOR, class CorrAt, class YyAt>
__device__ __forceinline__ void write_one(int c, int t0, float xx, CorrAt corr_at, YyAt yy_at,
                                          float* out) {
  auto gain = [&](float xy, float yy) { return xy / sqrtf(__fadd_rn(1.f, __fmul_rn(xx, yy))); };
  int cand = t0;
  if (c == 0) {
    const float xy0 = corr_at(t0), yy0 = yy_at(t0);
    out[0] = (float)t0;
    out[1] = gain(xy0, yy0);
    out[2] = xy0;
    out[3] = yy0;
  } else {
    const int k = c + 1;
    const int t1 = idiv<FLOOR>(2 * t0 + k, 2 * k);
    const int t1b = k == 2 ? (t1 + t0 > MAXP ? t0 : t0 + t1)
                           : idiv<FLOOR>(2 * SECOND_CHECK[k] * t0 + k, 2 * k);
    const float xy = (corr_at(t1) + corr_at(t1b)) * 0.5f;
    const float yy = (yy_at(t1) + yy_at(t1b)) * 0.5f;
    out[4 + k - 2] = (float)t1;
    out[18 + k - 2] = xy;
    out[32 + k - 2] = yy;
    out[46 + k - 2] = gain(xy, yy);
    cand = t1;
  }
  out[60 + c] = corr_at(cand - 1);
  out[75 + c] = corr_at(cand);
  out[90 + c] = corr_at(cand + 1);
}

template <bool FLOOR, class CorrAt, class YyAt>
__device__ __forceinline__ void write(int t0, float xx, CorrAt corr_at, YyAt yy_at, float* out) {
  for (int c = 0; c < N_WALK; ++c) write_one<FLOOR>(c, t0, xx, corr_at, yy_at, out);
}

}  // namespace candidate_lanes
