// Kernel K6: each stream's 960-sample window at its pitch lag (sm_90a).
//
// Replaces the Pallas kernel nnnoiseless_tpu/ops/window.py::_pallas_window
// (_window_kernel), which forms input_mem[768 - lag : 1728 - lag] of every
// stream by ten rolls gated by the bits of the lag.  On the card it is an
// indexed copy: out[b, i] = mem[b, 768 - lag[b] + i], and 0 where that
// index is negative.  The lag is taken modulo 1024, as the ten-bit barrel
// shifter (ops/window.py::barrel_shift_window) takes it, so the two agree
// bit for bit on every int32 lag and no index leaves the row.
//
// Layout.  One block of 320 threads per stream; each thread copies three
// samples, consecutive threads consecutive samples, so reads and writes
// are coalesced (the reads start at any word, a one-segment misalignment).
//
// What bounds it.  No arithmetic: 3.75 KB read and 3.75 KB written per
// stream, 31 MB at B = 4096, ~10 us at 3.35 TB/s.  It is bound by memory
// bandwidth, and the design spends nothing beyond one read and one write
// of each output sample.  At B = 1 it is one block, and launch latency.

#include <cuda_runtime.h>

namespace {

constexpr int MEM = 1728;
constexpr int WIN = 960;
constexpr int OFF = 768;  // MEM - WIN
constexpr int THREADS = 320;

__global__ void __launch_bounds__(THREADS)
window_kernel(const float* __restrict__ mem, const int* __restrict__ lag, float* __restrict__ out) {
  const int b = blockIdx.x;
  const int start = OFF - (lag[b] & 1023);
  const float* src = mem + (size_t)b * MEM;
  float* dst = out + (size_t)b * WIN;
  for (int i = threadIdx.x; i < WIN; i += THREADS) {
    const int q = start + i;
    dst[i] = q >= 0 ? src[q] : 0.f;
  }
}

}  // namespace

// mem (B, 1728), lag (B,) int32; out (B, 960).  Returns cudaGetLastError().
extern "C" int nnt_window_at_lag(const float* mem, const int* lag, float* out, int B, void* stream) {
  window_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(mem, lag, out);
  return static_cast<int>(cudaGetLastError());
}
