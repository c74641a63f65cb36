// Kernel K2's FFT alone over rows: a second entry to the device functions
// of fft960.cuh (sm_90a), as K3 is a second entry to K1's code.  It lets a
// check hold the transform against ops/fft.py's plain versions apart from
// the rest of the frame loop; nothing on the main path calls it.
//
// One warp per row, eight rows a block.  The forward loads each lane's 15
// sample pairs as float2 (coalesced), transforms, and copies the warp's
// shared row to the output coalesced; the inverse stages the packed row in
// shared memory first.  What bounds it: bytes, 7.5 KB per row in and out,
// against ~43 k flops.

#include "fft960.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int WIN = 960;
constexpr int PACKED = 962;

__global__ void __launch_bounds__(WARPS * 32)
rfft_kernel(const float* __restrict__ t, const float* __restrict__ x, float* __restrict__ out, int R) {
  __shared__ float rows[WARPS][PACKED];
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + w;
  if (r >= R) return;  // the whole warp leaves together
  const float2* src = reinterpret_cast<const float2*>(x + (size_t)r * WIN);
  fft960::Cx v[fft960::N1];
#pragma unroll
  for (int n1 = 0; n1 < fft960::N1; ++n1) {
    const float2 s = src[32 * n1 + l];
    v[n1] = {s.x, s.y};
  }
  fft960::forward(v, t, rows[w]);
  __syncwarp();
  float* dst = out + (size_t)r * PACKED;
  for (int i = l; i < PACKED; i += 32) dst[i] = rows[w][i];
}

__global__ void __launch_bounds__(WARPS * 32)
irfft_kernel(const float* __restrict__ t, const float* __restrict__ spec, float* __restrict__ out, int R) {
  __shared__ float rows[WARPS][PACKED];
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + w;
  if (r >= R) return;
  const float* src = spec + (size_t)r * PACKED;
  for (int i = l; i < PACKED; i += 32) rows[w][i] = src[i];
  __syncwarp();
  fft960::Cx v[fft960::N1];
  fft960::inverse(rows[w], t, v);
  float2* dst = reinterpret_cast<float2*>(out + (size_t)r * WIN);
#pragma unroll
  for (int n1 = 0; n1 < fft960::N1; ++n1) dst[32 * n1 + l] = make_float2(v[n1].r, v[n1].i);
}

}  // namespace

// table (ops/fft.py::fft960_table), x (R, 960) -> out (R, 962).  Returns
// cudaGetLastError().
extern "C" int nnt_rfft960(const float* table, const float* x, float* out, int R, void* stream) {
  rfft_kernel<<<(R + WARPS - 1) / WARPS, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(table, x, out, R);
  return static_cast<int>(cudaGetLastError());
}

// table, spec (R, 962) -> out (R, 960).  Returns cudaGetLastError().
extern "C" int nnt_irfft960(const float* table, const float* spec, float* out, int R, void* stream) {
  irfft_kernel<<<(R + WARPS - 1) / WARPS, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(table, spec, out, R);
  return static_cast<int>(cudaGetLastError());
}
