// Kernel K7: the float trainer's GRU recurrence over whole sequences, forward
// and backward (sm_90a, FP32 on CUDA cores).
//
// Replaces no Pallas kernel: the JAX trainer (nnnoiseless_tpu/training/
// network.py) runs its recurrence as a lax.scan that XLA compiles.  In the
// port the same loop was ~220 dependent small launches a frame, 446k a step
// at 32 x 2000.  ops/gru_seq.py computes each layer's input products over
// all (B, T) rows at once (XW = x @ wi + b); these kernels walk the T
// frames of what is left, the Keras reset_after=False cell
//
//   z = sigmoid(XW_z + h @ wr_z), r = sigmoid(XW_r + h @ wr_r),
//   c = act(XW_c + (r * h) @ wr_c), h' = z * h + (1 - z) * c,
//
// in one launch a layer forward (H (B, T, n) and the gates z, r, c as
// (B, T, 3n)), and its gradient in one launch a layer backward, t from T - 1
// down to 0, carrying dh between frames:
//
//   dh = dH[t] + carry; dz = dh (h[t-1] - c) z (1 - z);
//   dc = dh (1 - z) act'(c); d(rh) = dc @ wr_c^T; dr = d(rh) h[t-1] r (1 - r);
//   carry = dh z + d(rh) r + [dz, dr] @ wr[:, :2n]^T;  dXW[t] = [dz, dr, dc].
//
// The weight gradient is one product over all B * T rows, outside (the
// wrapper).
//
// Layout.  One block a sequence; n padded to NP (32, 64, 96 or 128), KS = 4
// lanes an output: thread (j, p), j = tid / 4, owns output j and sums the
// NP / 4 inputs of part p, the lanes' sums combined by two xor shuffles (all
// four lanes end with the same bits, so each keeps the state and gates in
// registers).  Its 3 x NP / 4 weights (wr[k, j], wr[k, n + j], wr[k, 2n + j]
// for its k, or the row k = j for the backward's transposed products) are
// loaded into registers once and never read again; padding is zero, so a
// padded output stays 0.  The state vectors the products read are in shared
// memory, each part's run of NP / 4 padded by 4 floats so that a warp's four
// float4 loads fall on distinct banks.  A frame's inputs (XW[t]; the
// backward's dH[t], gates[t] and H[t - 1]) stream through a ring of D rows
// in shared memory filled by 4-byte cp.async D - 1 frames ahead, so no load
// from device memory sits on the recurrence.  Two block barriers a frame
// (after the z/r pass, after the candidate pass; the backward's after dz/dc
// and after dr), no atomics: the kernels are deterministic.
//
// What bounds it.  Latency: each frame is two dependent mat-vecs of a
// sequence (3 n^2 multiply-adds, 27,648 at n = 96) and their barriers,
// 2 x T dependent steps a layer; the FP32 work of a frame at n = 96 fills
// ~216 cycles of the SM's four schedulers, the rest the chains' and
// barriers' latency (shuffles, expf and tanhf, two barriers): measured
// 0.48-1.04 us a frame at n = 24..96 on an H100, ~950 cycles even at
// n = 24 (PERF.md section 6, K7).  wr's bytes (110 KB at n = 96) are read once a block,
// and the streamed rows (3n or 5n floats a frame) are far under the card's
// bandwidth.  At B = 32 the blocks fill 32 SMs; more sequences a block would
// only lengthen each frame.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int KS = 4;  // lanes an output's sum is split over
constexpr int D = 8;   // ring rows: frames in flight
constexpr unsigned FULL = 0xffffffffu;
// The four lanes of an output split its stores (h, z, r, c), and 4 x NP
// threads cover a ring row of XW (3n floats) with one copy each.
static_assert(KS == 4, "the lanes' stores and the forward's ring copy assume four lanes an output");

template <int NP>
struct Dims {
  static constexpr int CH = NP / KS;          // inputs a lane sums
  // a part's run in shared memory: 4 mod 8 floats, so that the parts'
  // float4s fall on distinct banks
  static constexpr int STRIDE = CH % 8 == 4 ? CH : CH + 4;
  static constexpr int VEC = KS * STRIDE;     // a padded state vector
  static constexpr int THREADS = NP * KS;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// torch.sigmoid's formula
__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

// Activation codes of model.py: 0 tanh, 1 sigmoid, 2 relu.
__device__ __forceinline__ float act(float x, int code) {
  return code == 0 ? tanhf(x) : code == 1 ? sigm(x) : fmaxf(x, 0.0f);
}

// The derivative as a function of the activation's output y.
__device__ __forceinline__ float act_grad(float y, int code) {
  return code == 0 ? 1.0f - y * y : code == 1 ? y * (1.0f - y) : (y > 0.0f ? 1.0f : 0.0f);
}

__device__ __forceinline__ float lanes_sum(float x) {
#pragma unroll
  for (int o = 1; o < KS; o <<= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// a += v . wa, b += v . wb over one part's CH inputs (v in shared memory)
template <int CH>
__device__ __forceinline__ void dot_shared(const float* v, const float (&wa)[CH], const float (&wb)[CH],
                                           float& a, float& b) {
#pragma unroll
  for (int i = 0; i < CH; i += 4) {
    const float4 p = *reinterpret_cast<const float4*>(v + i);
    a = fmaf(p.x, wa[i], a);
    b = fmaf(p.x, wb[i], b);
    a = fmaf(p.y, wa[i + 1], a);
    b = fmaf(p.y, wb[i + 1], b);
    a = fmaf(p.z, wa[i + 2], a);
    b = fmaf(p.z, wb[i + 2], b);
    a = fmaf(p.w, wa[i + 3], a);
    b = fmaf(p.w, wb[i + 3], b);
  }
}

// a += v . wa, b += u . wb
template <int CH>
__device__ __forceinline__ void dot2(const float* v, const float* u, const float (&wa)[CH],
                                     const float (&wb)[CH], float& a, float& b) {
#pragma unroll
  for (int i = 0; i < CH; i += 4) {
    const float4 p = *reinterpret_cast<const float4*>(v + i);
    const float4 q = *reinterpret_cast<const float4*>(u + i);
    a = fmaf(p.x, wa[i], a);
    b = fmaf(q.x, wb[i], b);
    a = fmaf(p.y, wa[i + 1], a);
    b = fmaf(q.y, wb[i + 1], b);
    a = fmaf(p.z, wa[i + 2], a);
    b = fmaf(q.z, wb[i + 2], b);
    a = fmaf(p.w, wa[i + 3], a);
    b = fmaf(q.w, wb[i + 3], b);
  }
}

template <int CH>
__device__ __forceinline__ float dot1(const float* v, const float (&w)[CH]) {
  float a = 0.0f;
#pragma unroll
  for (int i = 0; i < CH; i += 4) {
    const float4 p = *reinterpret_cast<const float4*>(v + i);
    a = fmaf(p.x, w[i], a);
    a = fmaf(p.y, w[i + 1], a);
    a = fmaf(p.z, w[i + 2], a);
    a = fmaf(p.w, w[i + 3], a);
  }
  return a;
}

// xw (B, T, 3n) -> h_out (B, T, n), gates (B, T, 3n): z, r, c.
template <int NP>
__global__ void __launch_bounds__(NP * KS, 1)
gru_seq_fwd(const float* __restrict__ xw, const float* __restrict__ wr, float* __restrict__ h_out,
            float* __restrict__ gates, int T, int n, int code) {
  using S = Dims<NP>;
  __shared__ __align__(16) float h_s[S::VEC];
  __shared__ __align__(16) float rh_s[S::VEC];
  __shared__ float ring[D][3 * NP];
  const int tid = threadIdx.x, j = tid / KS, part = tid % KS, n3 = 3 * n;
  const bool live = j < n;
  float wz[S::CH], wrr[S::CH], wc[S::CH];
#pragma unroll
  for (int i = 0; i < S::CH; ++i) {
    const int k = part * S::CH + i;
    const bool ok = live && k < n;
    wz[i] = ok ? wr[(size_t)k * n3 + j] : 0.0f;
    wrr[i] = ok ? wr[(size_t)k * n3 + n + j] : 0.0f;
    wc[i] = ok ? wr[(size_t)k * n3 + 2 * n + j] : 0.0f;
  }
  for (int i = tid; i < S::VEC; i += S::THREADS) h_s[i] = rh_s[i] = 0.0f;
  const size_t row0 = (size_t)blockIdx.x * T;
  auto fetch = [&](int t) {  // XW[t] into its ring row
    if (t < T && tid < n3) cp_async4(&ring[t % D][tid], xw + (row0 + t) * n3 + tid);
    cp_commit();
  };
  for (int t = 0; t < D - 1; ++t) fetch(t);
  cp_wait<D - 2>();
  __syncthreads();
  const int slot = (j / S::CH) * S::STRIDE + j % S::CH;
  const float* hv = h_s + part * S::STRIDE;
  const float* rv = rh_s + part * S::STRIDE;
  float h = 0.0f;
  for (int t = 0; t < T; ++t) {
    const float* x = ring[t % D];
    const float xz = live ? x[j] : 0.0f, xr = live ? x[n + j] : 0.0f, xc = live ? x[2 * n + j] : 0.0f;
    fetch(t + D - 1);  // into the row frame t - 1 read
    float az = 0.0f, ar = 0.0f;
    dot_shared<S::CH>(hv, wz, wrr, az, ar);
    const float z = sigm(xz + lanes_sum(az)), r = sigm(xr + lanes_sum(ar));
    if (part == 0) rh_s[slot] = r * h;
    __syncthreads();
    const float c = act(xc + lanes_sum(dot1<S::CH>(rv, wc)), code);
    h = z * h + (1.0f - z) * c;
    if (part == 0) h_s[slot] = h;
    if (live) {  // the four stores spread over the four lanes
      const size_t at = row0 + t;
      if (part == 0) h_out[at * n + j] = h;
      else gates[at * n3 + (part - 1) * n + j] = part == 1 ? z : part == 2 ? r : c;
    }
    cp_wait<D - 2>();  // frame t + 1's row has landed
    __syncthreads();
  }
}

// dh (B, T, n), h (B, T, n), gates (B, T, 3n) -> dxw (B, T, 3n).
template <int NP>
__global__ void __launch_bounds__(NP * KS, 1)
gru_seq_bwd(const float* __restrict__ dh_in, const float* __restrict__ h_in,
            const float* __restrict__ gates, const float* __restrict__ wr, float* __restrict__ dxw,
            int T, int n, int code) {
  using S = Dims<NP>;
  __shared__ __align__(16) float gz_s[S::VEC];
  __shared__ __align__(16) float gc_s[S::VEC];
  __shared__ __align__(16) float gr_s[S::VEC];
  __shared__ float ring[D][5 * NP];  // dH[t] | z, r, c | H[t - 1]
  const int tid = threadIdx.x, k = tid / KS, part = tid % KS, n3 = 3 * n;
  const bool live = k < n;
  // row k of each gate's block: the products with wr^T
  float wz[S::CH], wrr[S::CH], wc[S::CH];
#pragma unroll
  for (int i = 0; i < S::CH; ++i) {
    const int j = part * S::CH + i;
    const bool ok = live && j < n;
    wz[i] = ok ? wr[(size_t)k * n3 + j] : 0.0f;
    wrr[i] = ok ? wr[(size_t)k * n3 + n + j] : 0.0f;
    wc[i] = ok ? wr[(size_t)k * n3 + 2 * n + j] : 0.0f;
  }
  for (int i = tid; i < S::VEC; i += S::THREADS) gz_s[i] = gc_s[i] = gr_s[i] = 0.0f;
  const size_t row0 = (size_t)blockIdx.x * T;
  auto fetch = [&](int t) {  // frame t's inputs into its ring row
    if (t >= 0) {
      for (int e = tid; e < 5 * n; e += S::THREADS) {
        const float* src = e < n ? dh_in + (row0 + t) * n + e
                           : e < 4 * n ? gates + (row0 + t) * n3 + (e - n)
                           : t > 0 ? h_in + (row0 + t - 1) * n + (e - 4 * n) : nullptr;
        if (src) cp_async4(&ring[t % D][e], src);
      }
    }
    cp_commit();
  };
  for (int t = T - 1; t > T - D; --t) fetch(t);
  cp_wait<D - 2>();
  __syncthreads();
  const int slot = (k / S::CH) * S::STRIDE + k % S::CH;
  const float* zv = gz_s + part * S::STRIDE;
  const float* cv = gc_s + part * S::STRIDE;
  const float* rv = gr_s + part * S::STRIDE;
  float carry = 0.0f;
  for (int t = T - 1; t >= 0; --t) {
    const float* x = ring[t % D];
    const float dh = live ? x[k] + carry : 0.0f;
    const float z = live ? x[n + k] : 0.0f, r = live ? x[2 * n + k] : 0.0f;
    const float c = live ? x[3 * n + k] : 0.0f, hp = live && t > 0 ? x[4 * n + k] : 0.0f;
    fetch(t - D + 1);  // into the row frame t + 1 read
    const float dz = dh * (hp - c) * (z * (1.0f - z));
    const float dc = dh * (1.0f - z) * act_grad(c, code);
    const size_t at = (row0 + t) * n3;
    if (part == 0) gz_s[slot] = dz;
    if (part == 1) gc_s[slot] = dc;
    if (live && part == 2) dxw[at + k] = dz;
    if (live && part == 3) dxw[at + 2 * n + k] = dc;
    __syncthreads();
    float u = 0.0f, v = 0.0f;
    dot2<S::CH>(cv, zv, wc, wz, u, v);
    u = lanes_sum(u);  // d(r h)[k]
    v = lanes_sum(v);
    const float dr = u * hp * (r * (1.0f - r));
    if (part == 0) gr_s[slot] = dr;
    if (live && part == 1) dxw[at + n + k] = dr;
    cp_wait<D - 2>();  // frame t - 1's row has landed
    __syncthreads();
    carry = dh * z + u * r + v + lanes_sum(dot1<S::CH>(rv, wrr));
  }
}

template <int NP>
cudaError_t launch_fwd(const float* xw, const float* wr, float* h, float* g, int B, int T, int n, int code,
                       cudaStream_t s) {
  gru_seq_fwd<NP><<<B, NP * KS, 0, s>>>(xw, wr, h, g, T, n, code);
  return cudaGetLastError();
}

template <int NP>
cudaError_t launch_bwd(const float* dh, const float* h, const float* g, const float* wr, float* dxw, int B,
                       int T, int n, int code, cudaStream_t s) {
  gru_seq_bwd<NP><<<B, NP * KS, 0, s>>>(dh, h, g, wr, dxw, T, n, code);
  return cudaGetLastError();
}

}  // namespace

// xw (B, T, 3n), wr (n, 3n) -> h (B, T, n), gates (B, T, 3n); n in 1..128,
// code the candidate's activation.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an n out of range.
extern "C" int nnt_gru_seq_fwd(const float* xw, const float* wr, float* h, float* gates, int B, int T, int n,
                               int code, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > 128) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = n <= 32   ? launch_fwd<32>(xw, wr, h, gates, B, T, n, code, s)
                        : n <= 64 ? launch_fwd<64>(xw, wr, h, gates, B, T, n, code, s)
                        : n <= 96 ? launch_fwd<96>(xw, wr, h, gates, B, T, n, code, s)
                                  : launch_fwd<128>(xw, wr, h, gates, B, T, n, code, s);
  return static_cast<int>(e);
}

// dh, h (B, T, n), gates (B, T, 3n), wr (n, 3n) -> dxw (B, T, 3n).  As
// nnt_gru_seq_fwd for n and the return.
extern "C" int nnt_gru_seq_bwd(const float* dh, const float* h, const float* gates, const float* wr, float* dxw,
                               int B, int T, int n, int code, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > 128) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = n <= 32   ? launch_bwd<32>(dh, h, gates, wr, dxw, B, T, n, code, s)
                        : n <= 64 ? launch_bwd<64>(dh, h, gates, wr, dxw, B, T, n, code, s)
                        : n <= 96 ? launch_bwd<96>(dh, h, gates, wr, dxw, B, T, n, code, s)
                                  : launch_bwd<128>(dh, h, gates, wr, dxw, B, T, n, code, s);
  return static_cast<int>(e);
}
