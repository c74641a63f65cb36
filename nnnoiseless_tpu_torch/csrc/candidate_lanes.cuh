// The 105 octave-removal candidate lanes of one window (ops/pitch.py::
// doubling_candidates layout, pitch.rs:118-221), shared by kernel K1/K3
// (csrc/pitch_kernel.cu, tables in shared memory) and kernel K4
// (csrc/candidates_kernel.cu, tables in global memory).  Both give one
// lane to each candidate.
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

// The reference's second check for k >= 3 (pitch.rs, second_check =
// {0, 0, 3, 2, 3, 2, 5, 2, 3, 2, 3, 2, 5, 2, 3, 2}): 2 for odd k, 5 for
// k = 6 and 12, else 3.  Arithmetic on k, since k varies across lanes.
__host__ __device__ constexpr int second_check(int k) { return k % 2 ? 2 : (k == 6 || k == 12 ? 5 : 3); }

__host__ __device__ constexpr int ceil_log2(int k) {
  int l = 0;
  while ((1 << l) < k) ++l;
  return l;
}

// ceil(2^(31 + l) / k), l = ceil(log2 k): below 2^32 for k >= 2.
__host__ __device__ constexpr unsigned magic(int k) {
  return static_cast<unsigned>(((1ull << (31 + ceil_log2(k))) + k - 1) / k);
}

// Integer division by 2k for the walk's k in [2, N_WALK], with k varying
// across the lanes of a warp.  n / 2k = (n >> 1) / k for n >= 0, and
// m / k = umulhi(m, M_k) >> (l_k - 1) with l_k = ceil(log2 k) and M_k =
// magic(k), exact for every m < 2^31 (Granlund and Montgomery, PLDI 1994,
// theorem 4.2 with N = 31), so for every unsigned n.  M_k comes from a
// chain of selects on k over immediates: a __constant__ table read at a
// lane-varying index is served one address at a time.
struct Div2k {
  int k;
  unsigned m;
  int shift;

  // (set in the body: nvcc's host pass keeps a device constructor's
  // initializer list, where device intrinsics are undeclared)
  __device__ __forceinline__ explicit Div2k(int k_) {
    k = k_;
    m = select_magic<N_WALK>(k_);
    shift = 31 - __clz(k_ - 1);  // l_k - 1
  }

  template <int J>
  static __device__ __forceinline__ unsigned select_magic(int k) {
    if constexpr (J <= 2) {
      return magic(2);
    } else {
      constexpr unsigned mj = magic(J);
      return k == J ? mj : select_magic<J - 1>(k);
    }
  }

  __device__ __forceinline__ int udiv(unsigned n) const { return static_cast<int>(__umulhi(n >> 1, m) >> shift); }

  // a / 2k rounded toward minus infinity (FLOOR: Python's and XLA's
  // integer floor division) or toward zero (C's truncation); the same for
  // a >= 0.  Exact for every int a: the negative numerators are formed in
  // unsigned arithmetic.
  template <bool FLOOR>
  __device__ __forceinline__ int quot(int a) const {
    if (a >= 0) return udiv(static_cast<unsigned>(a));
    const unsigned mag = 0u - static_cast<unsigned>(a);
    return -udiv(FLOOR ? mag + static_cast<unsigned>(2 * k - 1) : mag);
  }
};

// The lanes of candidate c < N_WALK: c = 0 is t0 (lanes 0-3), c >= 1 the
// t1 of k = c + 1 (lanes 4, 18, 32, 46 + c - 1); then the candidate's
// three correlation lanes 60, 75, 90 + c.  Candidates are independent:
// each caller gives one lane to each.  All six reads (corr_at at cand - 1,
// cand, cand + 1 and t1b; yy_at at cand and t1b; t1b = t0 for c = 0) are
// issued before any arithmetic or store, and neighbouring lanes c store
// neighbouring words.  The arithmetic is the plain version's:
// (a + b) * 0.5 and xy / sqrt(1 + xx yy) with the product and the sum
// rounded apart.
template <bool FLOOR, class CorrAt, class YyAt>
__device__ __forceinline__ void write_one(int c, int t0, float xx, CorrAt corr_at, YyAt yy_at,
                                          float* out) {
  int cand = t0, t1b = t0;
  if (c > 0) {
    const int k = c + 1;
    const Div2k d(k);
    cand = d.quot<FLOOR>(2 * t0 + k);
    t1b = k == 2 ? (cand + t0 > MAXP ? t0 : t0 + cand) : d.quot<FLOOR>(2 * second_check(k) * t0 + k);
  }
  const float lo = corr_at(cand - 1), mid = corr_at(cand), hi = corr_at(cand + 1);
  const float cb = corr_at(t1b), ya = yy_at(cand), yb = yy_at(t1b);
  const float xy = c == 0 ? mid : (mid + cb) * 0.5f;
  const float yy = c == 0 ? ya : (ya + yb) * 0.5f;
  const float g = xy / sqrtf(__fadd_rn(1.f, __fmul_rn(xx, yy)));
  out[c == 0 ? 0 : 3 + c] = static_cast<float>(cand);
  out[c == 0 ? 1 : 45 + c] = g;
  out[c == 0 ? 2 : 17 + c] = xy;
  out[c == 0 ? 3 : 31 + c] = yy;
  out[60 + c] = lo;
  out[75 + c] = mid;
  out[90 + c] = hi;
}

}  // namespace candidate_lanes
