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
// Layout.  One block of THREADS = 128 threads per stream.  Rows of 1728
// and 960 floats are 16-byte multiples, so with 16-byte aligned bases (the
// wrapper checks) every row is a sequence of float4s.  Output float4 m
// needs the source floats start + 4m .. start + 4m + 3: with a = start & 3
// (one value per stream, so uniform across the block) and base = start -
// a, that is float4 (base / 4 + m) shifted by a, plus the next float4 when
// a is not 0.  A float4 at a negative index lies wholly before the row's
// start (base is a multiple of 4) and reads as zeros; the largest index
// read is 1727.  Thread t writes output float4s t and t + 128 (the second
// on 112 of the threads) and issues its loads before its first store;
// consecutive threads touch consecutive float4s.  128 threads a stream was
// chosen on the card over one warp a stream (one or eight streams a
// block) and over 64 and 256 threads a stream: it is within the spread of
// the fastest at every B from 1 to 4096 (PERF.md section 6).
//
// What bounds it.  No arithmetic: 3.75 KB read and 3.75 KB written per
// stream, 31 MB at B = 4096, 9.4 us at 3.35 TB/s: memory bandwidth.  The
// second float4 a thread reads when a != 0 is its neighbour's first: it
// adds reads of L1, not of memory.  At B = 1 it is one block, and launch
// latency.

#include <cuda_runtime.h>

namespace {

constexpr int MEM = 1728;
constexpr int WIN = 960;
constexpr int OFF = 768;  // MEM - WIN
constexpr int THREADS = 128;  // a stream
constexpr int QUADS = WIN / 4;
constexpr int PER_THREAD = (QUADS + THREADS - 1) / THREADS;  // 2 float4s, the second on 112 threads

__device__ __forceinline__ float4 load4(const float4* src, int u) {
  return u >= 0 ? __ldg(src + u) : make_float4(0.f, 0.f, 0.f, 0.f);
}

__global__ void __launch_bounds__(THREADS)
window_kernel(const float* __restrict__ mem, const int* __restrict__ lag, float* __restrict__ out) {
  const int b = blockIdx.x, t = threadIdx.x;
  const int start = OFF - (__ldg(lag + b) & 1023);  // -255 .. 768
  const int a = start & 3;
  const int u0 = (start - a) / 4;  // exact: start - a is a multiple of 4
  const float4* src = reinterpret_cast<const float4*>(mem + (size_t)b * MEM);
  float4* dst = reinterpret_cast<float4*>(out + (size_t)b * WIN);
  // every load of the thread first, so that they are in flight together
  float4 v[PER_THREAD], w[PER_THREAD];
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int m = t + THREADS * i;
    v[i] = m < QUADS ? load4(src, u0 + m) : make_float4(0.f, 0.f, 0.f, 0.f);
    w[i] = a != 0 && m < QUADS ? load4(src, u0 + m + 1) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int m = t + THREADS * i;
    if (m >= QUADS) break;
    float4 o = v[i];
    if (a == 1) o = make_float4(v[i].y, v[i].z, v[i].w, w[i].x);
    else if (a == 2) o = make_float4(v[i].z, v[i].w, w[i].x, w[i].y);
    else if (a == 3) o = make_float4(v[i].w, w[i].x, w[i].y, w[i].z);
    dst[m] = o;
  }
}

}  // namespace

// mem (B, 1728), lag (B,) int32; out (B, 960); mem and out 16-byte
// aligned.  Returns cudaGetLastError().
extern "C" int nnt_window_at_lag(const float* mem, const int* lag, float* out, int B, void* stream) {
  window_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(mem, lag, out);
  return static_cast<int>(cudaGetLastError());
}
