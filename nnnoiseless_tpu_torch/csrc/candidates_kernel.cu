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
// What bounds it.  A row's 88 reads are scattered 4-byte reads of its
// 3 KB of tables; each costs a whole 32-byte sector from memory, and the
// t1 of k = 2..15 cluster near t0 / k, so a row touches about 33 distinct
// sectors (~1.06 KB), besides xx, pidx and the 420 bytes of lanes it
// writes: ~0.61 GB at R = 409,600, 0.18 ms at 3.35 TB/s (chip_smoke.py
// phase 11 counts the sectors of the run's own pitch indices).  Reading
// whole rows (1.44 GB) would cost more than the scattered sectors.  The
// limit is then how many reads are in flight, so the design keeps many:
//   - One lane a candidate.  A group of 16 lanes takes a row (lanes
//     0..14 walk one candidate each, lane 15 is idle): 2 rows a warp, 16
//     a 256-thread block, 25,600 blocks at R = 409,600.  A lane's six reads
//     are independent and issued before any arithmetic.
//   - No shared memory.  Each lane stores its 7 lanes straight to out;
//     neighbouring lanes write neighbouring words, so each store covers
//     runs of 14-15 floats of a row.  Registers alone set occupancy: at
//     most 32 a thread, 2048 threads an SM.
//   - pidx[r] and xx[r]: one load a row, broadcast by shuffle.
// The earlier design (one thread walking a whole row, its lanes staged in
// 40 KB of shared memory a 96-row block) ran 15 of 64 warps an SM, each
// warp-wide load on 32 rows' sectors: 0.82 ms at R = 409,600 on an H100.
#include <cuda_runtime.h>

#include "candidate_lanes.cuh"

namespace {

using candidate_lanes::MAXP;
using candidate_lanes::N_CAND;
constexpr int N_LAGS = 385;
constexpr int LANES = 16;  // lanes a row: one a candidate, the last idle
constexpr int THREADS = 256;
constexpr int ROWS = THREADS / LANES;  // rows a block
constexpr int BLOCKS_PER_SM = 2048 / THREADS;

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
candidates_kernel(const float* __restrict__ corr, const float* __restrict__ yy,
                  const float* __restrict__ xx, const int* __restrict__ pidx,
                  float* __restrict__ out, int R) {
  const int c = threadIdx.x % LANES;
  const int r = blockIdx.x * ROWS + threadIdx.x / LANES;
  int p = 0;
  float x = 0.f;
  if (c == 0 && r < R) {
    p = __ldg(pidx + r);
    x = __ldg(xx + r);
  }
  p = __shfl_sync(0xffffffffu, p, 0, LANES);
  x = __shfl_sync(0xffffffffu, x, 0, LANES);
  if (r >= R || c >= candidate_lanes::N_WALK) return;
  const float* const cr = corr + (size_t)r * N_LAGS;
  const float* const yr = yy + (size_t)r * N_LAGS;
  const int t0 = min(p >> 1, MAXP - 1);  // floor(pidx / 2): an arithmetic shift
  candidate_lanes::write_one<true>(
      c, t0, x,
      [cr](int t) {
        const int i = MAXP - t;
        return i >= 0 && i < N_LAGS ? __ldg(cr + i) : 0.f;
      },
      [yr](int t) { return t >= 0 && t < N_LAGS ? __ldg(yr + t) : 0.f; }, out + (size_t)r * N_CAND);
}

}  // namespace

// corr, yy: (R, 385); xx: (R,); pidx: (R,) int32; out: (R, 105).
// Returns cudaGetLastError().
extern "C" int nnt_candidates(const float* corr, const float* yy, const float* xx, const int* pidx,
                              float* out, int R, void* stream) {
  candidates_kernel<<<(R + ROWS - 1) / ROWS, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      corr, yy, xx, pidx, out, R);
  return static_cast<int>(cudaGetLastError());
}
