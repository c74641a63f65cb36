// Kernel K1's stage-attribution instances: one per stubbed stage
// (csrc/pitch_kernel.cuh), compiled apart from the production instance so
// that nvcc builds the two files side by side.
#include "pitch_kernel.cuh"

namespace pitch {

int launch_skip(int skip, const float* ds, int ds_stride, int first, const float* w0, float* cand,
                int* pidx, int B, int T, cudaStream_t stream) {
  switch (skip) {
    case SK_WHITEN: return launch<SK_WHITEN>(ds, ds_stride, first, w0, cand, pidx, B, T, stream);
    case SK_ETAB: return launch<SK_ETAB>(ds, ds_stride, first, w0, cand, pidx, B, T, stream);
    case SK_CORR: return launch<SK_CORR>(ds, ds_stride, first, w0, cand, pidx, B, T, stream);
    case SK_COARSE: return launch<SK_COARSE>(ds, ds_stride, first, w0, cand, pidx, B, T, stream);
    case SK_CAND: return launch<SK_CAND>(ds, ds_stride, first, w0, cand, pidx, B, T, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace pitch

// K1 with the stages of the mask `skip` (one of pitch::SK_*) stubbed out,
// for attribution; the arguments of nnt_pitch_analysis otherwise.
extern "C" int nnt_pitch_analysis_skip(const float* ds, int ds_stride, const float* w0, float* cand,
                                       int* pidx, int B, int T, int skip, void* stream) {
  return pitch::launch_skip(skip, ds, ds_stride, DS_STEP, w0, cand, pidx, B, T,
                            static_cast<cudaStream_t>(stream));
}
