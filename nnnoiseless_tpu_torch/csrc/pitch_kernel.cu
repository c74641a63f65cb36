// Kernels K1 and K3, the production instance (skip mask 0) and the C
// entries.  The kernel itself is csrc/pitch_kernel.cuh; the five
// stage-attribution instances are built beside this file in
// csrc/pitch_kernel_skip.cu.
#include "pitch_kernel.cuh"

// ds: (B, >= 864 + 240T) rows of stride ds_stride; w0: (T, B);
// cand: (T, B, 105); pidx: (T, B).  Returns cudaGetLastError().
extern "C" int nnt_pitch_analysis(const float* ds, int ds_stride, const float* w0, float* cand,
                                  int* pidx, int B, int T, void* stream) {
  return launch<0>(ds, ds_stride, DS_STEP, w0, cand, pidx, B, T, static_cast<cudaStream_t>(stream));
}

// Kernel K3, the counterpart of nnnoiseless_tpu/ops/pitch_kernel.py::
// pitch_analysis_pallas: the same device code on R pre-stacked windows
// (R, 864), each its own frame (T = 1, lane 0 unpatched); cand (R, 105),
// pidx (R,).  Returns cudaGetLastError().
extern "C" int nnt_pitch_analysis_stacked(const float* windows, float* cand, int* pidx, int R,
                                          void* stream) {
  return launch<0>(windows, N_DS, 0, nullptr, cand, pidx, R, 1, static_cast<cudaStream_t>(stream));
}
