// Kernel K2, the production instance (skip mask 0) and the C entry.  The kernel
// itself is csrc/frame_kernel.cuh; the seven stage-attribution instances
// are built beside this file in csrc/frame_kernel_skip.cu.
#include "frame_kernel.cuh"

// The FFT table (ops/fft.py::fft960_table), the band matrix and ranges,
// the interpolation weights and bands, the DCT and tansig tables, the
// tiled int8 weights (ops/rnn_kernel.py::pack_tiled, n_w bytes, 16-byte
// aligned) and the 6 activation codes, the nine input carries (B, ...),
// filt (T, B, 480), cand (T, B, 105), the packed output (T, B, 512), the
// nine output carries and the mask of stubbed stages (0 in production, or
// one of frame::SK_*).  Returns cudaGetLastError() (or the shared-memory
// attribute's error); weights of another size, or a mask with no
// instance, return cudaErrorInvalidValue without launching.
extern "C" int nnt_frame_loop(const float* tw, const float* bcorr, const int* branges,
                              const float* iw, const int* ib, const float* dct,
                              const float* tansig, const void* w, const int* acts, int n_w,
                              const float* mem, const float* synth, const float* cmem,
                              const float* hv, const float* hn, const float* hd,
                              const float* lastg, const int* per, const float* pg,
                              const float* filt, const float* cand, float* packed, float* mem_o,
                              float* synth_o, float* cmem_o, float* hv_o, float* hn_o,
                              float* hd_o, float* lastg_o, int* per_o, float* pg_o, int B, int T,
                              int skip, void* stream) {
  if (n_w != rnn_tile::layout::W_BYTES) return static_cast<int>(cudaErrorInvalidValue);
  const frame::Args a{tw,      bcorr,  branges, iw,     ib,     dct,    tansig,
                      static_cast<const uint8_t*>(w),   acts,   mem,    synth,  cmem,
                      hv,      hn,     hd,      lastg,  per,    pg,     filt,   cand,
                      packed,  mem_o,  synth_o, cmem_o, hv_o,   hn_o,   hd_o,   lastg_o,
                      per_o,   pg_o,   B,       T};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return skip == 0 ? launch<0>(a, s) : frame::launch_skip(skip, a, s);
}
