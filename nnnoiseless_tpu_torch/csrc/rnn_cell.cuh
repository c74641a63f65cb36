// The RNN cell's scalar parts (reference src/rnn.rs:242-379): the 1/256
// weight scale and the table activations, which the register-tiled stages
// of rnn_tile.cuh (kernels K2 and K5) apply to their sums.  Pre-activations
// accumulate raw int8 values against f32 inputs and are scaled by 1/256
// before the table activation, as ops/rnn.py does.

#pragma once

#include <math.h>

namespace rnn_cell {

constexpr float SCALE = 0.00390625f;  // 1/256 weight scale

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

}  // namespace rnn_cell
