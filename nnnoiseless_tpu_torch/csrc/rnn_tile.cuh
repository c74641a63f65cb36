// Register-tiled stages of the RNN cell (reference src/rnn.rs:242-379),
// used by kernels K2 (frame_kernel.cuh) and K5 (rnn_kernel.cu).  Per
// product the arithmetic of ops/rnn.py (int8 weights exact in f32, the raw
// sum plus the bias, then the 1/256 scale and the table activation); the
// summing order differs from one sum in input order only where a sum is
// split over lanes.
//
// Tile<S, C, THREADS, MIN_BLOCKS, SP, LDG, UNROLL>: a block owns S streams
// and runs THREADS threads.  Activations live in shared memory as rows,
// one row per vector element and one column per stream (row stride SP
// floats, by default S + 4; a 16-byte multiple for S > 1, so a thread
// reads the C streams of a row as C / 4 float4s).  Weights are int8,
// row-major (inputs x outputs) with the output count padded to a multiple
// of 4, so one 32-bit load gives the 4 weights of a thread's 4 outputs at
// one input: in shared memory (K5), or in global memory read through the
// read-only path with LDG (K2).  A stage's input is a Runs<K...>: runs of
// K consecutive rows each, anywhere in shared memory, against consecutive
// weight rows; each run's sum continues on the same accumulators, so a
// sum in one lane keeps the input order across runs.
//
// A work item is (output quad q, stream group g of C streams, lane l of
// KS): it sums inputs k = l, l + KS, ... into 4 x C accumulators, one
// 32-bit weight load and C / 4 float4 loads per k for 4 C FMAs; the KS
// lanes of an item are neighbours in a warp and add their partial sums by
// shuffles (xor KS/2, ..., 1), and lane 0 stores the raw sums; the
// bias, scale and activation follow in an elementwise pass.  KS is 1 for
// a tile of many streams (input order, as the plain version sums); for
// the one-stream tile it is the largest power of 2, at most 32, with
// quads x KS <= THREADS, so each chain stays short.
//
// Weights are widened once per k and output, not once per FMA: a byte
// b = w + 128 (the int8 word xor 0x80808080) placed by PRMT in the
// mantissa of 2^23 gives the float 2^23 + b, and subtracting 2^23 + 128 is
// exact.  ops/rnn_kernel.py::rnn_step_staged repeats the summing order.

#pragma once

#include <stdint.h>

#include "rnn_cell.cuh"

namespace rnn_tile {

// The standard model's widths and its tiled weight layout
// (ops/rnn_kernel.py::pack_tiled, TILED), which K2 and K5 both take: six
// chunks in stage order, each 16-byte aligned, [dense w | b], [vad wi; wr
// | b], [vad head w | b], [noise wi; wr | b], [denoise wi; wr | b], [gains
// w | b], every matrix (inputs x outputs) with its outputs padded to a
// multiple of 4.  Byte offsets of the chunks.
namespace layout {
constexpr int NF = 42, DD = 24, DV = 24, DN = 48, DH = 96, DG = 22;
constexpr int NIN_NOISE = DD + DV + NF, NIN_DEN = DV + DN + NF;
constexpr int align16(int x) { return (x + 15) / 16 * 16; }
constexpr int pad4(int x) { return (x + 3) / 4 * 4; }
constexpr int gru_bytes(int nin, int n) { return (nin + n) * 3 * n + 3 * n; }
constexpr int O_DENSE = 0;
constexpr int O_VAD = O_DENSE + align16(NF * DD + DD);
constexpr int O_VADH = O_VAD + align16(gru_bytes(DD, DV));
constexpr int O_NOISE = O_VADH + align16(DV * 4 + 1);
constexpr int O_DEN = O_NOISE + align16(gru_bytes(NIN_NOISE, DN));
constexpr int O_GAIN = O_DEN + align16(gru_bytes(NIN_DEN, DH));
constexpr int W_BYTES = O_GAIN + align16(DH * pad4(DG) + DG);
static_assert(W_BYTES == 87808, "the tiled layout of ops/rnn_kernel.py::pack_tiled");
}  // namespace layout

template <int S_, int C_, int THREADS_, int MIN_BLOCKS_, int SP_ = S_ == 1 ? 1 : S_ + 4,
          bool LDG_ = false, int UNROLL_ = 4>
struct Tile {
  static constexpr int S = S_, C = C_, THREADS = THREADS_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int G = S / C;   // stream groups
  static constexpr int SP = SP_;    // row stride, floats
  static constexpr bool LDG = LDG_;  // weights in global memory
  static constexpr int UNROLL = UNROLL_;  // k steps unrolled, their weight loads issued together
  static_assert(S % C == 0 && (C == 1 || C % 4 == 0) && THREADS % 32 == 0, "bad tile");
  static_assert(S == 1 ? SP == 1 : SP >= S && SP % 4 == 0, "bad row stride");
};

// Runs of K rows each: x[i] points at row 0 of run i.
template <int... K>
struct Runs {
  static constexpr int N = (K + ...);  // rows in all
  const float* x[sizeof...(K)];
};

__host__ __device__ constexpr int pow2_floor(int x) { return x >= 2 ? 2 * pow2_floor(x / 2) : 1; }

// Lanes a sum of a stage with `quads` output quads is split over.  The
// one-stream tile splits each sum so that its chain is short; a tile of
// many streams has parallel work enough and sums in input order, as the
// plain version does.
template <class T>
__host__ __device__ constexpr int lanes(int quads) {
  return T::S > 1 ? 1 : T::THREADS / quads >= 32 ? 32 : pow2_floor(T::THREADS / quads);
}

// The 32-bit word of 4 weights at p, and one bias byte.
template <class T>
__device__ __forceinline__ uint32_t weight_word(const uint8_t* p) {
  if constexpr (T::LDG) return __ldg(reinterpret_cast<const unsigned int*>(p));
  else return *reinterpret_cast<const uint32_t*>(p);
}

template <class T>
__device__ __forceinline__ float bias_at(const int8_t* p) {
  if constexpr (T::LDG) return (float)__ldg(reinterpret_cast<const signed char*>(p));
  else return (float)*p;
}

__device__ __forceinline__ void widen4(uint32_t packed, float (&w)[4]) {
  const uint32_t u = packed ^ 0x80808080u;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    w[r] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u + r)), 8388736.f);
}

template <class T>
__device__ __forceinline__ void load_row(const float* p, float (&x)[T::C]) {
  if constexpr (T::C == 1) {
    x[0] = *p;
  } else {
#pragma unroll
    for (int i = 0; i < T::C / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      x[4 * i] = v.x, x[4 * i + 1] = v.y, x[4 * i + 2] = v.z, x[4 * i + 3] = v.w;
    }
  }
}

// acc[r][c] += x[k][c] * w[k][r] over k = l, l + KS, ... < K; x points at
// the group's first stream in row 0, w at the quad's first output in row 0.
template <class T, int KS, int K>
__device__ __forceinline__ void tile_sum(float (&acc)[4][T::C], const float* x, const uint8_t* w,
                                         int ldw, int l) {
#pragma unroll (T::UNROLL)
  for (int k = l; k < K; k += KS) {
    float wf[4], xv[T::C];
    widen4(weight_word<T>(w + k * ldw), wf);
    load_row<T>(x + k * T::SP, xv);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < T::C; ++c) acc[r][c] = fmaf(xv[c], wf[r], acc[r][c]);
  }
}

// tile_sum over the runs in turn, run i against weight rows from the sum
// of the earlier runs' K on; s0: the group's first stream.
template <class T, int KS, int... K>
__device__ __forceinline__ void tile_sums(float (&acc)[4][T::C], const Runs<K...>& in, int s0,
                                         const uint8_t* w, int ldw, int l) {
  static_assert(sizeof...(K) == 1 || KS == 1, "a sum over several runs is one lane in input order");
  int i = 0, k0 = 0;
  ((tile_sum<T, KS, K>(acc, in.x[i] + s0, w + k0 * ldw, ldw, l), k0 += K, ++i), ...);
}

// Lane l of KS: every lane ends with the sum of the KS partial sums.
template <class T, int KS>
__device__ __forceinline__ void lane_sum(float (&acc)[4][T::C]) {
#pragma unroll
  for (int o = KS / 2; o > 0; o /= 2)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < T::C; ++c) acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], o);
}

// Calls body(q, g, l, active) for every item of a stage, in rounds of
// THREADS; every thread of the block takes part in each round (the
// shuffles need whole warps).  active: a real item whose group holds a
// valid stream.
template <class T, int Q, int KS, class F>
__device__ __forceinline__ void for_items(int n_valid, F&& body) {
  constexpr int N = Q * T::G * KS;
  for (int base = 0; base < N; base += T::THREADS) {
    const int idx = base + threadIdx.x;
    const int l = idx % KS, g = (idx / KS) % T::G, q = idx / (KS * T::G);
    body(q, g, l, idx < N && g * T::C < n_valid);
  }
}

// Lane 0 of an item stores its 4 x C sums as rows j0..j0+3 of `raw`, in
// float4s: along the streams for C >= 4, along the outputs for S = 1.
template <class T>
__device__ __forceinline__ void store_raw(float* raw, int j0, int s0, const float (&acc)[4][T::C]) {
  if constexpr (T::C == 1) {
    static_assert(T::SP == 1, "C = 1 is the one-stream tile");
    *reinterpret_cast<float4*>(raw + j0) = make_float4(acc[0][0], acc[1][0], acc[2][0], acc[3][0]);
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int i = 0; i < T::C / 4; ++i)
        *reinterpret_cast<float4*>(raw + (j0 + r) * T::SP + s0 + 4 * i) =
            make_float4(acc[r][4 * i], acc[r][4 * i + 1], acc[r][4 * i + 2], acc[r][4 * i + 3]);
  }
}

// raw rows j0..j0+3 += the item's sums (the same thread stored them).
template <class T>
__device__ __forceinline__ void add_raw(float* raw, int j0, int s0, const float (&acc)[4][T::C]) {
  if constexpr (T::C == 1) {
    float4* p = reinterpret_cast<float4*>(raw + j0);
    const float4 v = *p;
    *p = make_float4(__fadd_rn(v.x, acc[0][0]), __fadd_rn(v.y, acc[1][0]), __fadd_rn(v.z, acc[2][0]),
                     __fadd_rn(v.w, acc[3][0]));
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int i = 0; i < T::C / 4; ++i) {
        float4* p = reinterpret_cast<float4*>(raw + (j0 + r) * T::SP + s0 + 4 * i);
        const float4 v = *p;
        *p = make_float4(__fadd_rn(v.x, acc[r][4 * i]), __fadd_rn(v.y, acc[r][4 * i + 1]),
                         __fadd_rn(v.z, acc[r][4 * i + 2]), __fadd_rn(v.w, acc[r][4 * i + 3]));
      }
  }
}

// The tile pass of a stage: Q output quads, each the sum over the input
// rows; raw sums to rows of `raw`.
template <class T, int Q, class In>
__device__ __forceinline__ void sums(const In& in, const uint8_t* w, int ldw, float* raw, int n_valid) {
  constexpr int KS = lanes<T>(Q);
  for_items<T, Q, KS>(n_valid, [&](int q, int g, int l, bool active) {
    float acc[4][T::C] = {};
    const int j0 = 4 * q, s0 = g * T::C;
    if (active) tile_sums<T, KS>(acc, in, s0, w + j0, ldw, l);
    lane_sum<T, KS>(acc);
    if (active && l == 0) store_raw<T>(raw, j0, s0, acc);
  });
}

// Each stage is a tile pass, a block barrier, then an elementwise pass
// over (output, stream) with consecutive threads on consecutive streams:
// one short loop, not the tile's 4 C outputs unrolled in every thread,
// so the code stays small and shared memory is read and written without
// bank conflicts.  The caller puts a barrier after each stage.
template <class T, int ROWS, class Value, class Put>
__device__ __forceinline__ void elementwise(Value&& value, Put&& put) {
  for (int idx = threadIdx.x; idx < ROWS * T::S; idx += T::THREADS) {
    const int j = idx / T::S, s = idx % T::S;
    put(j, s, value(j, s));
  }
}

// Dense layer In::N -> NOUT: store(j, s, act(scale (bias + sum))).  w:
// the (In::N, NOUT padded to 4) int8 matrix, then NOUT bias bytes; raw:
// scratch rows for the sums.
template <class T, int NOUT, class In, class Store>
__device__ void dense(const In& in, const uint8_t* w, float* raw, int code, const float* tab,
                      int n_valid, Store&& store) {
  constexpr int NO4 = (NOUT + 3) / 4 * 4;
  sums<T, NO4 / 4>(in, w, NO4, raw, n_valid);
  __syncthreads();
  const int8_t* bias = reinterpret_cast<const int8_t*>(w + In::N * NO4);
  elementwise<T, NOUT>(
      [&](int j, int s) {
        return rnn_cell::act(
            __fmul_rn(rnn_cell::SCALE, __fadd_rn(bias_at<T>(bias + j), raw[j * T::SP + s])), code, tab);
      },
      store);
}

// GRU of width N on the In::N input rows of `in`, first half.  h: the N
// state rows; w: [wi; wr], (In::N + N, 3N) int8, then 3N bias bytes.
// Every column's pre-activation is bias + the input sum; z and r then add
// the state's sum, (bias + input sum) + state sum, as the plain version
// associates it.  gs: 3N scratch rows, left holding z, r * h and the
// candidate's pre-activation.
template <class T, int N, class In>
__device__ void gru_gates(const In& in, const float* h, const uint8_t* w, float* gs, const float* tab,
                          int n_valid) {
  constexpr int NIN = In::N, N3 = 3 * N, Q = N3 / 4, KS = lanes<T>(Q);
  static_assert(N % 4 == 0, "a quad must not straddle two gates");
  const int8_t* bias = reinterpret_cast<const int8_t*>(w + (NIN + N) * N3);
  for_items<T, Q, KS>(n_valid, [&](int q, int g, int l, bool active) {
    const int j0 = 4 * q, s0 = g * T::C;
    const bool gate = active && j0 < 2 * N;
    {
      // the bias loads go ahead of the sum, and an inactive item (its quad
      // may lie past the buffer) reads none
      float b[4], acc[4][T::C] = {};
#pragma unroll
      for (int r = 0; r < 4; ++r) b[r] = active ? bias_at<T>(bias + j0 + r) : 0.f;
      if (active) tile_sums<T, KS>(acc, in, s0, w + j0, N3, l);
      lane_sum<T, KS>(acc);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < T::C; ++c) acc[r][c] = __fadd_rn(b[r], acc[r][c]);
      if (active && l == 0) store_raw<T>(gs, j0, s0, acc);
    }
    float acc[4][T::C] = {};
    if (gate) tile_sum<T, KS, N>(acc, h + s0, w + NIN * N3 + j0, N3, l);
    lane_sum<T, KS>(acc);
    if (gate && l == 0) add_raw<T>(gs, j0, s0, acc);
  });
  __syncthreads();
  elementwise<T, 2 * N>(
      [&](int j, int s) {
        const float sg = rnn_cell::act(__fmul_rn(rnn_cell::SCALE, gs[j * T::SP + s]), 1, tab);
        return j < N ? sg : __fmul_rn(h[(j - N) * T::SP + s], sg);
      },
      [&](int j, int s, float v) { gs[j * T::SP + s] = v; });
}

// GRU, second half: store(j, s, z h + (1 - z) act(scale (cand + rec))),
// rec the sum of r * h against wr's candidate columns; h: the N state
// rows; raw: N scratch rows.
template <class T, int NIN, int N, class Store>
__device__ void gru_out(const float* h, const uint8_t* w, const float* gs, float* raw, int code,
                        const float* tab, int n_valid, Store&& store) {
  constexpr int N3 = 3 * N;
  sums<T, N / 4>(Runs<N>{{gs + N * T::SP}}, w + NIN * N3 + 2 * N, N3, raw, n_valid);
  __syncthreads();
  elementwise<T, N>(
      [&](int j, int s) {
        const float hh = rnn_cell::act(
            __fmul_rn(rnn_cell::SCALE, __fadd_rn(gs[(2 * N + j) * T::SP + s], raw[j * T::SP + s])),
            code, tab);
        const float zz = gs[j * T::SP + s], hj = h[j * T::SP + s];
        return __fadd_rn(__fmul_rn(zz, hj), __fmul_rn(__fsub_rn(1.f, zz), hh));
      },
      store);
}

}  // namespace rnn_tile
