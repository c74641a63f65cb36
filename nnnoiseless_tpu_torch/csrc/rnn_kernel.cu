// Kernel K5: one step of the whole RNN cell for a batch of streams
// (sm_90a, FP32 on CUDA cores).
//
// Replaces the Pallas kernel nnnoiseless_tpu/ops/rnn_pallas.py::_rnn_pallas
// (rnn_step_pallas): dense 42 -> 24, the vad GRU (24), the vad head (1),
// the noise GRU (48) on [d, vad_h, f], the denoise GRU (96) on
// [vad_h, noise_h, f] and the gains head (22), with the 201-entry tansig
// table.  The stages are those of kernel K2 (rnn_cell.cuh), so the two
// kernels compute the cell with the same arithmetic.
//
// Layout.  One block of 256 threads owns a tile of S = 32 streams.  It
// copies the int8-valued weights (87.5 KB for the standard model, exact
// as int8) and the tansig table into shared memory, loads each stream's
// features and three GRU states into a per-stream block of shared memory,
// runs the stages with a barrier between dependent ones, and writes the
// new states, the gains and the vad.  Streams beyond B in the last tile
// compute on zeros and are not stored, so any B >= 1 works (B = 1 is the
// per-frame path's shape).
//
// What bounds it.  ~87 K multiply-adds per stream (each weight once): 0.7
// GFLOP at B = 4096, ~11 us at the FP32 peak; 1.9 KB of states and
// features per stream in and out, ~8 MB, ~2.4 us of HBM time.  Neither
// bounds it: the ten dependent stages and the 87.5 KB weight copy per
// block do, since a block runs its tile through every stage in turn.  At
// B = 4096 the 128 blocks are one wave on 132 SMs (194 KB of shared memory
// each, one block per SM); at B = 1 it is one block, and launch latency.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rnn_cell.cuh"

namespace {

constexpr int S = 32;  // streams per block
constexpr int THREADS = 256;
constexpr int NF = 42;
constexpr int DD = 24, DV = 24, DN = 48, DH = 96, DG = 22;
constexpr int TAB = 204;          // tansig table, 201 entries
constexpr int MAX_W = 87552;      // int8 weight bytes held in shared memory (16-byte multiple)

// Per-stream block of shared memory (offsets in floats).
enum : int {
  P_F = 0,                    // 42 features
  P_D = P_F + NF,             // input dense output
  P_HV = P_D + DD,            // GRU states in
  P_HN = P_HV + DV,
  P_HD = P_HN + DN,
  P_HV2 = P_HD + DH,          // GRU states out
  P_HN2 = P_HV2 + DV,
  P_HD2 = P_HN2 + DN,
  P_GIN = P_HD2 + DH,         // GRU input vector (up to 114)
  P_GS = P_GIN + NF + DV + DN,  // gate scratch (3 x 96)
  P_G = P_GS + 3 * DH,        // gains
  P_VAD = P_G + DG,
  PS = P_VAD + 2,
};
using Cell = rnn_cell::Layout<S, THREADS, PS, P_GS, P_GIN>;
constexpr size_t SMEM_BYTES = MAX_W + (size_t)(TAB + S * PS) * sizeof(float) + 24 * sizeof(int);

__global__ void __launch_bounds__(THREADS, 1)
rnn_kernel(const float* __restrict__ tansig, const int8_t* __restrict__ w,
           const int* __restrict__ woff_g, const int* __restrict__ acts_g, int n_w,
           const float* __restrict__ f, const float* __restrict__ hv, const float* __restrict__ hn,
           const float* __restrict__ hd, float* __restrict__ hv_o, float* __restrict__ hn_o,
           float* __restrict__ hd_o, float* __restrict__ gains, float* __restrict__ vad, int B) {
  extern __shared__ int4 smem_i4[];
  int8_t* W = reinterpret_cast<int8_t*>(smem_i4);
  float* tab = reinterpret_cast<float*>(W + MAX_W);
  float* ps = tab + TAB;
  int* woff = reinterpret_cast<int*>(ps + S * PS);
  int* acts = woff + 15;

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * S;
  const int n_valid = min(S, B - b0);

  // weights (16-byte copies, then the tail), table, offsets, codes
  const int n16 = n_w / 16;
  for (int i = tid; i < n16; i += THREADS) smem_i4[i] = reinterpret_cast<const int4*>(w)[i];
  for (int i = 16 * n16 + tid; i < n_w; i += THREADS) W[i] = w[i];
  for (int i = tid; i < 201; i += THREADS) tab[i] = tansig[i];
  if (tid < 15) woff[tid] = woff_g[tid];
  if (tid < 6) acts[tid] = acts_g[tid];
  for (int i = tid; i < S * PS; i += THREADS) ps[i] = 0.f;
  __syncthreads();
  auto load = [&](const float* src, int n, int off) {
    for (int idx = tid; idx < n_valid * n; idx += THREADS)
      ps[(idx / n) * PS + off + idx % n] = src[(size_t)b0 * n + idx];
  };
  load(f, NF, P_F);
  load(hv, DV, P_HV);
  load(hn, DN, P_HN);
  load(hd, DH, P_HD);
  __syncthreads();

  // the stage order of frame_kernel.cu (rnn.rs:343-379)
  rnn_cell::dense_layer<Cell>(ps, P_F, NF, W + woff[0], W + woff[1], DD, P_D, acts[0], tab);
  __syncthreads();
  rnn_cell::gru_gates<Cell>(ps, P_D, DD, P_HV, DV, W + woff[2], W + woff[3], W + woff[4], tab);
  __syncthreads();
  rnn_cell::gru_out<Cell>(ps, P_HV, DV, W + woff[3], acts[1], P_HV2, tab);
  __syncthreads();
  rnn_cell::dense_layer<Cell>(ps, P_HV2, DV, W + woff[13], W + woff[14], 1, P_VAD, acts[5], tab);
  rnn_cell::gather_input<Cell>(ps, P_D, DD, P_HV2, DV, P_F, NF);
  __syncthreads();
  rnn_cell::gru_gates<Cell>(ps, P_GIN, DD + DV + NF, P_HN, DN, W + woff[5], W + woff[6], W + woff[7], tab);
  __syncthreads();
  rnn_cell::gru_out<Cell>(ps, P_HN, DN, W + woff[6], acts[2], P_HN2, tab);
  __syncthreads();
  rnn_cell::gather_input<Cell>(ps, P_HV2, DV, P_HN2, DN, P_F, NF);
  __syncthreads();
  rnn_cell::gru_gates<Cell>(ps, P_GIN, DV + DN + NF, P_HD, DH, W + woff[8], W + woff[9], W + woff[10], tab);
  __syncthreads();
  rnn_cell::gru_out<Cell>(ps, P_HD, DH, W + woff[9], acts[3], P_HD2, tab);
  __syncthreads();
  rnn_cell::dense_layer<Cell>(ps, P_HD2, DH, W + woff[11], W + woff[12], DG, P_G, acts[4], tab);
  __syncthreads();

  auto store = [&](float* dst, int n, int off) {
    for (int idx = tid; idx < n_valid * n; idx += THREADS)
      dst[(size_t)b0 * n + idx] = ps[(idx / n) * PS + off + idx % n];
  };
  store(hv_o, DV, P_HV2);
  store(hn_o, DN, P_HN2);
  store(hd_o, DH, P_HD2);
  store(gains, DG, P_G);
  store(vad, 1, P_VAD);
}

}  // namespace

// tansig (201,), int8 weights (n_w bytes, 16-byte aligned) with their 15
// offsets and 6 activation codes (ops/rnn_kernel.py::pack_weights), f
// (B, 42), states hv (B, 24), hn (B, 48), hd (B, 96); out: the new states,
// gains (B, 22), vad (B,).  Returns cudaGetLastError(), or the error of
// the shared-memory attribute; a model larger than the shared-memory
// weight buffer returns cudaErrorInvalidValue without launching.
extern "C" int nnt_rnn_step(const float* tansig, const int8_t* w, const int* woff, const int* acts,
                            int n_w, const float* f, const float* hv, const float* hn,
                            const float* hd, float* hv_o, float* hn_o, float* hd_o, float* gains,
                            float* vad, int B, void* stream) {
  if (n_w > MAX_W) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(rnn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  rnn_kernel<<<(B + S - 1) / S, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      tansig, w, woff, acts, n_w, f, hv, hn, hd, hv_o, hn_o, hd_o, gains, vad, B);
  return static_cast<int>(cudaGetLastError());
}
