// The stages of the RNN cell (reference src/rnn.rs:242-379) as kernel K2
// (frame_kernel.cuh) runs them.  Kernel K5 (rnn_kernel.cu) runs its own
// register-tiled stages (rnn_tile.cuh) and takes only tansig and act
// from here.
//
// Every stage runs over a tile of L::S streams with L::THREADS threads.
// Stream s keeps its vectors in an L::PS-float block of shared memory,
// ps + s * L::PS; the GRU gate scratch (3 x the widest GRU) starts at
// offset L::GS of that block and the GRU input vector at L::GIN.  Weights
// are int8 values (exact), read through whatever pointer the kernel
// passes; pre-activations accumulate raw int8 values against f32 inputs and
// are scaled by 1/256 before the table activation, as ops/rnn.py does.

#pragma once

#include <math.h>
#include <stdint.h>

namespace rnn_cell {

constexpr float SCALE = 0.00390625f;  // 1/256 weight scale

// The tile geometry a kernel runs the stages with.
template <int S_, int THREADS_, int PS_, int GS_, int GIN_>
struct Layout {
  static constexpr int S = S_, THREADS = THREADS_, PS = PS_, GS = GS_, GIN = GIN_;
};

// ops/activations.py::tansig_approx with the table; NaN -> 1.
static __device__ float tansig(float x, const float* tab) {
  if (!(x < 8.f)) return 1.f;
  if (!(x > -8.f)) return -1.f;
  const float sign = x < 0.f ? -1.f : 1.f;
  const float ax = fminf(fabsf(x), 7.99f);
  const float fi = floorf(__fadd_rn(0.5f, __fmul_rn(25.f, ax)));
  const float frac = __fsub_rn(ax, __fmul_rn(0.04f, fi));
  float y = tab[(int)fi];
  const float dy = __fsub_rn(1.f, __fmul_rn(y, y));
  y = __fadd_rn(y, __fmul_rn(__fmul_rn(frac, dy), __fsub_rn(1.f, __fmul_rn(y, frac))));
  return sign * y;
}

// Activation codes of model.py: 0 tanh, 1 sigmoid, 2 relu.
static __device__ float act(float x, int code, const float* tab) {
  if (code == 0) return tansig(x, tab);
  if (code == 1) return __fadd_rn(0.5f, __fmul_rn(0.5f, tansig(__fmul_rn(0.5f, x), tab)));
  return fmaxf(x, 0.f);
}

template <class L>
__device__ void dense_layer(float* ps, int in_off, int nin, const int8_t* w, const int8_t* bias,
                            int nout, int out_off, int code, const float* tab) {
  for (int idx = threadIdx.x; idx < L::S * nout; idx += L::THREADS) {
    const int s = idx / nout, j = idx % nout;
    const float* x = ps + s * L::PS + in_off;
    float acc = 0.f;
    for (int i = 0; i < nin; ++i) acc = fmaf(x[i], (float)w[i * nout + j], acc);
    ps[s * L::PS + out_off + j] = act(__fmul_rn(SCALE, __fadd_rn((float)bias[j], acc)), code, tab);
  }
}

// GRU, first half: z, r*h and the candidate's input pre-activation into
// the gate scratch (rnn.rs:293-330, r pre-multiplied by the state).
template <class L>
__device__ void gru_gates(float* ps, int in_off, int nin, int h_off, int n, const int8_t* wi,
                          const int8_t* wr, const int8_t* bias, const float* tab) {
  const int n3 = 3 * n;
  for (int idx = threadIdx.x; idx < L::S * n3; idx += L::THREADS) {
    const int s = idx / n3, j = idx % n3;
    const float* x = ps + s * L::PS + in_off;
    const float* h = ps + s * L::PS + h_off;
    float* gs = ps + s * L::PS + L::GS;
    float gi = 0.f;
    for (int i = 0; i < nin; ++i) gi = fmaf(x[i], (float)wi[i * n3 + j], gi);
    const float pre = __fadd_rn((float)bias[j], gi);
    if (j < 2 * n) {
      float rz = 0.f;
      for (int i = 0; i < n; ++i) rz = fmaf(h[i], (float)wr[i * n3 + j], rz);
      const float sg = act(__fmul_rn(SCALE, __fadd_rn(pre, rz)), 1, tab);
      gs[j] = j < n ? sg : __fmul_rn(h[j - n], sg);
    } else {
      gs[j] = pre;
    }
  }
}

// GRU, second half: h' = z h + (1 - z) act(candidate).
template <class L>
__device__ void gru_out(float* ps, int h_off, int n, const int8_t* wr, int code, int out_off,
                        const float* tab) {
  const int n3 = 3 * n;
  for (int idx = threadIdx.x; idx < L::S * n; idx += L::THREADS) {
    const int s = idx / n, j = idx % n;
    const float* gs = ps + s * L::PS + L::GS;
    const float h = ps[s * L::PS + h_off + j];
    float rec = 0.f;
    for (int i = 0; i < n; ++i) rec = fmaf(gs[n + i], (float)wr[i * n3 + 2 * n + j], rec);
    const float hh = act(__fmul_rn(SCALE, __fadd_rn(gs[2 * n + j], rec)), code, tab);
    const float z = gs[j];
    ps[s * L::PS + out_off + j] = __fadd_rn(__fmul_rn(z, h), __fmul_rn(__fsub_rn(1.f, z), hh));
  }
}

// Copy input segments into the per-stream GRU input vector.
template <class L>
__device__ void gather_input(float* ps, int off0, int n0, int off1, int n1, int off2, int n2) {
  const int n = n0 + n1 + n2;
  for (int idx = threadIdx.x; idx < L::S * n; idx += L::THREADS) {
    const int s = idx / n, i = idx % n;
    float* p = ps + s * L::PS;
    p[L::GIN + i] = i < n0 ? p[off0 + i] : i < n0 + n1 ? p[off1 + i - n0] : p[off2 + i - n0 - n1];
  }
}

}  // namespace rnn_cell
