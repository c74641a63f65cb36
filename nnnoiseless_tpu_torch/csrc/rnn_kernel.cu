// Kernel K5: one step of the whole RNN cell for a batch of streams
// (sm_90a, FP32 on CUDA cores).
//
// Replaces the Pallas kernel nnnoiseless_tpu/ops/rnn_pallas.py::_rnn_pallas
// (rnn_step_pallas): dense 42 -> 24, the vad GRU (24), the vad head (1),
// the noise GRU (48) on [d, vad_h, f], the denoise GRU (96) on
// [vad_h, noise_h, f] and the gains head (22), with the 201-entry tansig
// table, in that order (rnn.rs:343-379).  The stages are the register
// tiles of rnn_tile.cuh.
//
// Layout.  Weights: the tiled int8 layout of ops/rnn_kernel.py::pack_tiled
// (rnn_tile::layout), which K2 takes too: six chunks in stage order.  At the
// start thread 0 issues one bulk copy (cp.async.bulk, the TMA's 1-D form)
// per chunk, each completing on its own mbarrier, and every stage waits
// only for its own chunk: the 60 KB of the denoise GRU arrive while the
// earlier stages compute.  Activations: rows of shared memory laid out so
// that each GRU's inputs and state are consecutive rows (d and the new
// vad state are written twice, the features loaded twice), so a stage
// sums over one run of rows.
//
// Stages.  Each is a tile pass (rnn_tile.cuh: a thread sums 4 outputs x
// C streams from shared memory into registers and stores the raw sums),
// a block barrier, and an elementwise pass (bias, scale, activation, the
// GRU blend) with consecutive threads on consecutive streams.  The new
// states stay in their rows and go out at the end, coalesced.
//
// Tiles.  B above SMALL_B: Tile<32, 8, 576>, 32 streams a block, one lane
// a sum in input order (the plain version's order: the products and their
// rounding are the same); 128 blocks at B = 4096, one a SM (215 KB of
// shared memory).  B up to SMALL_B: Tile<1, 1, 576>, one stream a block,
// two a SM, each sum split over up to 32 lanes, so no zero streams are
// computed and the longest chain at B = 1 is 27 steps (the denoise GRU's
// 114 inputs, then its 96 states, over 8 lanes).  Up to SMALL_B = 1024
// the one-stream blocks (four waves at 1024) take no longer than the
// 32-stream tile's single wave (chip_smoke.py phase 7, PERF.md section 6).
//
// What bounds it.  ~87 K multiply-adds per stream: 0.71 GFLOP at B = 4096,
// 10.6 us at the FP32 peak; the states, features and outputs are ~1.7 KB
// a stream, and the 87.5 KB of weights are read once a block, from L2.
// The old kernel issued two shared loads and one I2F per FMA (its SASS,
// kernel_ab.py: 1.49 LDS and 1.02 I2F per FFMA); here a k step of a 4 x 8
// tile is 3 loads, 1 LOP, 4 PRMT, 4 FADD and 32 FFMA.  What is left at
// B = 4096 is issue and latency within a block: the denoise GRU's 72
// column quads x 4 stream groups (288 items) fill half the block's warps,
// its z and r columns for 210 steps.  At B = 1 it is the stages' chains, barriers and launch latency.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rnn_tile.cuh"
#include "smem_once.cuh"

namespace {

using rnn_tile::Runs;
using namespace rnn_tile::layout;

constexpr int TAB = 204;  // tansig table, 201 entries (padded)
constexpr int SMALL_B = 1024;
constexpr int N_CHUNKS = 6;
__constant__ int CHUNK_OFF[N_CHUNKS + 1] = {O_DENSE, O_VAD, O_VADH, O_NOISE, O_DEN, O_GAIN, W_BYTES};

// activation rows
enum : int {
  R_V = 0,                         // [d | hv]            vad GRU
  R_A = R_V + DD + DV,             // [d | hv' | f | hn]  noise GRU
  R_B = R_A + NIN_NOISE + DN,      // [hv' | hn' | f | hd] denoise GRU
  R_H2 = R_B + NIN_DEN + DH,       // hd'
  R_G = R_H2 + DH,                 // GRU scratch: z, r * h, candidate (3 x 96)
  R_T = R_G + 3 * DH,              // raw sums of the other passes
  ROWS = R_T + DH,
};

constexpr int BAR_OFF = W_BYTES + TAB * 4;
constexpr int ACT_OFF = BAR_OFF + 16 * ((N_CHUNKS * 8 + 15) / 16);

template <class T>
constexpr int smem_bytes() { return ACT_OFF + ROWS * T::SP * 4; }

using Big = rnn_tile::Tile<32, 8, 576, 1>;
using Small = rnn_tile::Tile<1, 1, 576, 2>;
static_assert(smem_bytes<Big>() <= 232448, "shared memory");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_wait(const uint64_t* bar) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)) : "memory");
}

// Element k of the block's S x N slice of an input: stream k / N, element
// k % N.
template <int N>
__device__ __forceinline__ float fetch(const float* src, int b0, int k, int n_valid) {
  return k / N < n_valid ? __ldg(src + (size_t)b0 * N + k) : 0.f;
}

template <class T, int N>
__device__ __forceinline__ void place(float* X, int k, int row0, int row1, float v) {
  const int s = k / N, j = k % N;
  X[(row0 + j) * T::SP + s] = v;
  if (row1 >= 0) X[(row1 + j) * T::SP + s] = v;
}

// The block's inputs, S x (42 + 24 + 48 + 96) floats, transposed to their
// rows: each thread issues UNROLL loads before it writes any, so they are
// in flight together; streams past B read as zeros.
template <class T>
__device__ __forceinline__ void load_inputs(float* X, const float* f, const float* hv,
                                            const float* hn, const float* hd, int b0, int n_valid) {
  constexpr int N0 = T::S * NF, N1 = N0 + T::S * DV, N2 = N1 + T::S * DN, TOTAL = N2 + T::S * DH;
  constexpr int UNROLL = 8;
  for (int base = threadIdx.x; base < TOTAL; base += UNROLL * T::THREADS) {
    float v[UNROLL];
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const int idx = base + i * T::THREADS;
      v[i] = idx < N0   ? fetch<NF>(f, b0, idx, n_valid)
             : idx < N1 ? fetch<DV>(hv, b0, idx - N0, n_valid)
             : idx < N2 ? fetch<DN>(hn, b0, idx - N1, n_valid)
             : idx < TOTAL ? fetch<DH>(hd, b0, idx - N2, n_valid) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const int idx = base + i * T::THREADS;
      if (idx < N0) place<T, NF>(X, idx, R_A + DD + DV, R_B + DV + DN, v[i]);
      else if (idx < N1) place<T, DV>(X, idx - N0, R_V + DD, -1, v[i]);
      else if (idx < N2) place<T, DN>(X, idx - N1, R_A + NIN_NOISE, -1, v[i]);
      else if (idx < TOTAL) place<T, DH>(X, idx - N2, R_B + NIN_DEN, -1, v[i]);
    }
  }
}

// Rows of an output, N x S in shared memory, to its (B, N) slice in
// global memory, consecutive threads on consecutive floats.
template <class T, int N>
__device__ __forceinline__ void copy_out(const float* rows, float* dst, int b0, int n_valid) {
  for (int idx = threadIdx.x; idx < n_valid * N; idx += T::THREADS)
    dst[(size_t)b0 * N + idx] = rows[(idx % N) * T::SP + idx / N];
}

template <class T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
rnn_kernel(const float* __restrict__ tansig, const uint8_t* __restrict__ w,
           const int* __restrict__ acts_g, const float* __restrict__ f,
           const float* __restrict__ hv, const float* __restrict__ hn,
           const float* __restrict__ hd, float* __restrict__ hv_o, float* __restrict__ hn_o,
           float* __restrict__ hd_o, float* __restrict__ gains, float* __restrict__ vad, int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* W = smem;
  float* tab = reinterpret_cast<float*>(smem + W_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  float* X = reinterpret_cast<float*>(smem + ACT_OFF);
  constexpr int SP = T::SP;

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * T::S;
  const int n_valid = min(T::S, B - b0);

  if (tid == 0) {
    for (int i = 0; i < N_CHUNKS; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(bars + i)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int i = 0; i < N_CHUNKS; ++i) {
      const int off = CHUNK_OFF[i], bytes = CHUNK_OFF[i + 1] - off;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(smem_addr(bars + i)), "r"(bytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
          :: "r"(smem_addr(W + off)), "l"(w + off), "r"(bytes), "r"(smem_addr(bars + i))
          : "memory");
    }
  }
  for (int i = tid; i < 201; i += T::THREADS) tab[i] = tansig[i];
  int acts[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) acts[i] = __ldg(acts_g + i);
  load_inputs<T>(X, f, hv, hn, hd, b0, n_valid);
  __syncthreads();

  float* G = X + R_G * SP;
  float* TMP = X + R_T * SP;
  auto row = [&](int r, int j, int s) -> float& { return X[(r + j) * SP + s]; };

  bar_wait(bars + 0);
  rnn_tile::dense<T, DD>(Runs<NF>{{X + (R_A + DD + DV) * SP}}, W + O_DENSE, TMP, acts[0], tab, n_valid,
                         [&](int j, int s, float v) { row(R_V, j, s) = v; row(R_A, j, s) = v; });
  __syncthreads();
  bar_wait(bars + 1);
  rnn_tile::gru_gates<T, DV>(Runs<DD>{{X + R_V * SP}}, X + (R_V + DD) * SP, W + O_VAD, G, tab, n_valid);
  __syncthreads();
  rnn_tile::gru_out<T, DD, DV>(X + (R_V + DD) * SP, W + O_VAD, G, TMP, acts[1], tab, n_valid,
                               [&](int j, int s, float v) {
                                 row(R_A + DD, j, s) = v;
                                 row(R_B, j, s) = v;
                               });
  __syncthreads();
  bar_wait(bars + 2);
  rnn_tile::dense<T, 1>(Runs<DV>{{X + (R_A + DD) * SP}}, W + O_VADH, TMP, acts[5], tab, n_valid,
                        [&](int, int s, float v) {
                          if (s < n_valid) vad[b0 + s] = v;
                        });
  bar_wait(bars + 3);
  rnn_tile::gru_gates<T, DN>(Runs<NIN_NOISE>{{X + R_A * SP}}, X + (R_A + NIN_NOISE) * SP, W + O_NOISE, G,
                             tab, n_valid);
  __syncthreads();
  rnn_tile::gru_out<T, NIN_NOISE, DN>(X + (R_A + NIN_NOISE) * SP, W + O_NOISE, G, TMP, acts[2], tab, n_valid,
                                      [&](int j, int s, float v) { row(R_B + DV, j, s) = v; });
  __syncthreads();
  bar_wait(bars + 4);
  rnn_tile::gru_gates<T, DH>(Runs<NIN_DEN>{{X + R_B * SP}}, X + (R_B + NIN_DEN) * SP, W + O_DEN, G, tab,
                             n_valid);
  __syncthreads();
  rnn_tile::gru_out<T, NIN_DEN, DH>(X + (R_B + NIN_DEN) * SP, W + O_DEN, G, TMP, acts[3], tab, n_valid,
                                    [&](int j, int s, float v) { row(R_H2, j, s) = v; });
  __syncthreads();
  bar_wait(bars + 5);
  rnn_tile::dense<T, DG>(Runs<DH>{{X + R_H2 * SP}}, W + O_GAIN, TMP, acts[4], tab, n_valid,
                         [&](int j, int s, float v) { row(R_T, j, s) = v; });  // in place
  __syncthreads();
  copy_out<T, DV>(X + (R_A + DD) * SP, hv_o, b0, n_valid);
  copy_out<T, DN>(X + (R_B + DV) * SP, hn_o, b0, n_valid);
  copy_out<T, DH>(X + R_H2 * SP, hd_o, b0, n_valid);
  copy_out<T, DG>(TMP, gains, b0, n_valid);
}

template <class T>
int launch(const float* tansig, const uint8_t* w, const int* acts, const float* f, const float* hv,
           const float* hn, const float* hd, float* hv_o, float* hn_o, float* hd_o, float* gains,
           float* vad, int B, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T>();
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = smem_once(rnn_kernel<T>, bytes, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  rnn_kernel<T><<<(B + T::S - 1) / T::S, T::THREADS, bytes, stream>>>(
      tansig, w, acts, f, hv, hn, hd, hv_o, hn_o, hd_o, gains, vad, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tansig (201,), the tiled int8 weights (n_w bytes, 16-byte aligned) and
// the 6 activation codes (ops/rnn_kernel.py::pack_tiled), f (B, 42),
// states hv (B, 24), hn (B, 48), hd (B, 96); out: the new states, gains
// (B, 22), vad (B,).  Returns cudaGetLastError(), or the error of the
// shared-memory attribute; weights of another size return
// cudaErrorInvalidValue without launching.
extern "C" int nnt_rnn_step(const float* tansig, const void* w, const int* acts, int n_w,
                            const float* f, const float* hv, const float* hn, const float* hd,
                            float* hv_o, float* hn_o, float* hd_o, float* gains, float* vad, int B,
                            void* stream) {
  if (n_w != W_BYTES) return static_cast<int>(cudaErrorInvalidValue);
  const auto* wb = static_cast<const uint8_t*>(w);
  auto s = static_cast<cudaStream_t>(stream);
  return B <= SMALL_B
             ? launch<Small>(tansig, wb, acts, f, hv, hn, hd, hv_o, hn_o, hd_o, gains, vad, B, s)
             : launch<Big>(tansig, wb, acts, f, hv, hn, hd, hv_o, hn_o, hd_o, gains, vad, B, s);
}
