// Kernel K4: octave-removal candidate lanes from precomputed tables
// (sm_90a).
//
// Replaces the Pallas kernel nnnoiseless_tpu/ops/frame_kernel.py::
// candidates_pallas (body _make_cand_kernel).  Row r of the (R, 385)
// correlation table corr, the (R, 385) energy lookup yy (already flipped
// and clamped, ops/pitch.py::doubling_tables), xx[r] and pidx[r] give the
// 105 lanes of ops/pitch.py::doubling_candidates, with K4's own rules:
// t0 = min(pidx // 2, 383) with floor division, corr_at(t) = corr[384 - t],
// yy_at(t) = yy[t], and a lookup outside [0, 385) reads 0 (the one-hot
// lookup of the TPU kernel finds no lane there).  The lane code is
// csrc/candidate_lanes.cuh, K1's.
//
// What bounds it.  About 80 scattered 4-byte reads of a row's 3 KB of
// tables, each a 32-byte sector from device memory, and 420 bytes written:
// memory traffic, ~1.2 GB at R = 409,600.  One thread per row: a warp's
// 32 rows send their reads together, and the rows are independent.  Each
// thread writes its 105 lanes into shared memory (row stride 105, odd, so
// no bank conflicts), and the block then stores its rows, which are
// contiguous in the output, with coalesced writes: 105 scattered 4-byte
// stores per thread took 3.3x as long (2.81 against 0.84 ms at R = 409,600
// on an H100).
#include <cuda_runtime.h>

#include "candidate_lanes.cuh"

namespace {

constexpr int N_LAGS = 385;
constexpr int N_CAND = candidate_lanes::N_CAND;
constexpr int THREADS = 96;  // rows per block; 40 KB of staged lanes

__global__ void __launch_bounds__(THREADS)
candidates_kernel(const float* __restrict__ corr, const float* __restrict__ yy,
                  const float* __restrict__ xx, const int* __restrict__ pidx,
                  float* __restrict__ out, int R) {
  __shared__ float lanes[THREADS * N_CAND];
  const int r0 = blockIdx.x * THREADS;
  const int r = r0 + threadIdx.x;
  if (r < R) {
    const float* c = corr + (size_t)r * N_LAGS;
    const float* y = yy + (size_t)r * N_LAGS;
    const int t0 = min(candidate_lanes::idiv<true>(pidx[r], 2), candidate_lanes::MAXP - 1);
    candidate_lanes::write<true>(
        t0, xx[r],
        [&](int t) {
          const int i = candidate_lanes::MAXP - t;
          return i >= 0 && i < N_LAGS ? __ldg(c + i) : 0.f;
        },
        [&](int t) { return t >= 0 && t < N_LAGS ? __ldg(y + t) : 0.f; },
        lanes + threadIdx.x * N_CAND);
  }
  __syncthreads();
  const int n = min(THREADS, R - r0) * N_CAND;
  float* o = out + (size_t)r0 * N_CAND;
  for (int i = threadIdx.x; i < n; i += THREADS) o[i] = lanes[i];
}

}  // namespace

// corr, yy: (R, 385); xx: (R,); pidx: (R,) int32; out: (R, 105).
// Returns cudaGetLastError().
extern "C" int nnt_candidates(const float* corr, const float* yy, const float* xx, const int* pidx,
                              float* out, int R, void* stream) {
  candidates_kernel<<<(R + THREADS - 1) / THREADS, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      corr, yy, xx, pidx, out, R);
  return static_cast<int>(cudaGetLastError());
}
