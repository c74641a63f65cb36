// Kernel K2's stage-attribution instances: one per stubbed stage
// (csrc/frame_kernel.cuh), compiled apart from the production instance so
// that nvcc builds the two files side by side.
#include "frame_kernel.cuh"

namespace frame {

int launch_skip(int skip, const Args& a, cudaStream_t stream) {
  switch (skip) {
    case SK_RD: return launch<SK_RD>(a, stream);
    case SK_LAG0: return launch<SK_LAG0>(a, stream);
    case SK_DFT: return launch<SK_DFT>(a, stream);
    case SK_FEAT: return launch<SK_FEAT>(a, stream);
    case SK_RNN: return launch<SK_RNN>(a, stream);
    case SK_COMB: return launch<SK_COMB>(a, stream);
    case SK_INV: return launch<SK_INV>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace frame
