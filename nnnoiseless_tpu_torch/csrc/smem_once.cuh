// A kernel's dynamic shared-memory limit, raised once per device rather
// than at every launch: the per-frame path and the scan engine capture
// their launches into CUDA graphs (nnnoiseless_tpu_torch/programs.py), and
// a launch that is captured should record the kernel and nothing else.
#pragma once

#include <atomic>

#include <cuda_runtime.h>

// cudaFuncSetAttribute(kernel, MaxDynamicSharedMemorySize, bytes) on the
// current device unless ``done`` (one bit a device, owned by the caller:
// one flag a kernel instance) says it was set there already.
template <class Kernel>
cudaError_t smem_once(Kernel* kernel, int bytes, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}
