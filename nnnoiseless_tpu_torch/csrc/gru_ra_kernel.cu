// Kernel K8: RNNoise 0.2's reset-after GRU recurrence over whole sequences,
// forward and backward (sm_90a, FP32 on CUDA cores; no TF32).
//
// Replaces no Pallas kernel: the JAX package has no RNNoise 0.2 trainer.  In
// the port the recurrence was a Python loop over 1,996 frames a layer, a
// small product and ~20 small kernels a frame-layer, ~168k device operations
// a train step at 128 x 2000.  training/rn02.py computes each layer's input
// products over all (B, T) rows at once (XW = x W_ih^T + b_ih); these
// kernels walk the frames of what is left, torch.nn.GRU's cell (gates in
// torch's r, z, n order):
//
//   HW = h W_hh^T + b_hh;  r, z = sigmoid(XW_rz + HW_rz);  hn = HW_n;
//   n = tanh(XW_n + r hn);  h' = lerp(n, h, z) = (1 - z) n + z h,
//
// in one launch a layer forward (H (B, T, n) and the gates r, z, n, hn as
// (B, T, 4n)), and its gradient in one launch a layer backward, t from T - 1
// down to 0, carrying dh between frames:
//
//   dh = dH[t] + carry;  dn = dh (1 - z)(1 - n^2);  dz = dh (h[t-1] - n) z (1 - z);
//   dhn = dn r;  dr = dn hn r (1 - r);  dXW[t] = [dr, dz, dn];  dHW[t] = [dr, dz, dhn];
//   carry = dh z + dHW[t] W_hh.
//
// W_hh's and b_hh's gradients are one product and one sum over all B * T
// rows of dHW, outside (ops/gru_reset_after.py).
//
// Layout.  W_hh (3n x n, 1.77 MB at n = 384) fits on no one SM, so a
// thread-block cluster of CL = 16 blocks (a non-portable size) shares it: each
// block owns U = 24 hidden units (n is padded to 16 U = 384 with zero rows
// and columns) and holds, in registers, read once a launch, the 3U rows of
// W_hh of its units' r, z and n (72 x 384 floats, 110.6 KB a block; the
// forward and the backward split them over the threads differently).  A
// cluster walks a group of bc sequences, all of its frames; the groups are
// independent, so only the blocks of a cluster talk.  The host asks cudaOccupancyMaxActiveClusters how many
// clusters the card seats at once and sets bc = ceil(B / seated) (at most
// BC_MAX), so that every group runs in one wave (an H100 SXM seats 7, so
// B = 128 runs as 7 groups of 19).
//
// Forward, a frame: thread (u, p) of a block's 16U owns unit u's three rows
// over input part p (U of the 16U inputs) and sums them against the
// group's states, 16, 8 or 4 sequences at a time (a chunk), reading h from
// shared memory as float4s that the unit pair of a warp shares (16 parts'
// runs padded to fall on distinct banks).  A reduce-scatter of xor shuffles
// leaves the parts of a unit with each sequence's three sums, so the gates of
// (unit u, a sequence) are computed where its r, z and n meet.  The block's
// new h slice goes through a staging row, with float4 stores through
// distributed shared memory (DSMEM), into the next of two h buffers of every
// block of the cluster.  Backward, a frame: the gate threads turn (dH[t], the
// saved gates, h[t-1], the carry) into dHW's slice of the block's units;
// after a block barrier the lane pair (2c, 2c + 1) holds columns 2c, 2c + 1
// of the block's 3U rows, each lane half of the rows (8 multiply-adds a
// float4 of dHW), forms the block's part of dHW W_hh for its two columns,
// and after one shuffle each lane stores its column's into the receive
// buffer of the column's owner, which sums the 16 parts in block order.  So
// the backward moves as many bytes through DSMEM as the forward (the block's
// slice of 16 partial sums in place of all 3n of dHW), and both read the same
// rows of W_hh.
//
// The exchange's stores are st.async, each counting its bytes off the
// receiving block's mbarrier of the frame, so a block waits for its own data
// and for no cluster barrier: a frame is one block barrier (the gates'
// staging, the ring), the exchange, the frame's outputs (staged,
// double-buffered, written a run of U at a time) and the next fetch, then
// the wait for the frame's data.  Each
// frame's inputs (XW[t]; dH[t], the gates and H[t - 1]) stream through a ring
// of D frames in shared memory, filled by cp.async (16 bytes where n is a
// multiple of 4, else 4) two frames ahead, so no load from device memory sits
// on the recurrence.  No atomics, fixed summation orders: the kernels are
// deterministic.
//
// What bounds it.  Latency of dependent steps: a layer-direction is 1,996
// frames, each a product of 128 x 1,152 x 384 = 56.6M multiply-adds that
// cannot start before the last frame's state is everywhere, a 1.69 us floor
// a frame at 67 TFLOP/s, 3.37 ms a layer-direction.  The design puts each
// frame's product on the SMs of every seated cluster at once (112 at B =
// 128), with W_hh never re-read from memory and nothing but the state (1.8 KB
// a block a frame) crossing between SMs, so a frame costs its share of the
// FP32 rate plus the gates, one block barrier and one exchange's latency.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CL = 16;      // blocks a cluster
constexpr int PARTS = 16;   // forward: input parts an output's sum is split over (a half warp)
constexpr int SC = 16;      // sequences a chunk at most: one a part after the reduce-scatter
constexpr int BC_MAX = 32;  // sequences a cluster at most
constexpr int D = 4;        // ring rows: the frame read and the D - 2 in flight beyond it, and one free
constexpr int U = 24;       // hidden units a block
constexpr int NT = CL * U;  // threads a block; also the padded width, the widest n
constexpr int STRIDE = U + 4;            // a part's run, padded: the 16 parts' float4s on distinct banks
constexpr int ROW = PARTS * STRIDE + 4;  // one sequence's h
constexpr int XR = 3 * U + 4;            // forward ring: a sequence's XW slice
constexpr int FST = 5 * U + 4;           // forward staging: h, r, z, n, hn
constexpr int YR = 6 * U + 4;            // backward ring: dH, r, z, n, hn, H[t-1]
constexpr int DW = 3 * U + 4;            // backward: a sequence's dHW slice
constexpr int BST = 4 * U + 4;           // backward staging: dr, dz, dn, dhn
constexpr int R2 = 3 * U / 2;            // backward: a thread's half of the block's rows
constexpr unsigned FULL = 0xffffffffu;
static_assert(PARTS == CL && SC == PARTS, "a unit's slot in an h row and the reduce-scatter assume 16 of each");
static_assert(U % 8 == 0 && R2 % 4 == 0, "a part's run, a block's slice and a thread's rows are float4s");

size_t fwd_floats(int bcp) { return 4 + (size_t)bcp * (2 * ROW + 2 * FST + D * XR); }
size_t bwd_floats(int bcp) {
  return 4 + (size_t)bcp * (2 * CL * U + 2 * DW + 2 * BST + D * YR) + (size_t)(bcp / SC) * NT;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The address of this block's shared-memory word `local` in block `rank` of
// the cluster.
__device__ __forceinline__ unsigned cluster_addr(unsigned local, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(local), "r"(rank));
  return r;
}

// A frame's exchange lands in the receiving block's shared memory by st.async,
// each store counting its bytes off that block's mbarrier of the frame; the
// block's own arrival, with the bytes it expects, completes the phase once
// they are in.  So a block waits for its data and for nothing else: no
// cluster barrier a frame.
__device__ __forceinline__ void mbar_init(unsigned mb) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(mb) : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned mb, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mb), "r"(bytes) : "memory");
}

// Wait for the phase of parity `parity` of the mbarrier; a phase that never
// completes (a byte count that does not add up) traps instead of hanging.
__device__ __forceinline__ void mbar_wait(unsigned mb, unsigned parity) {
  for (unsigned spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mb), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1u << 24)) __trap();
  }
}

// 16 bytes into shared memory of a block of the cluster, counted off its
// mbarrier (both cluster addresses).
__device__ __forceinline__ void st_async4(unsigned dst, float4 v, unsigned mb) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n"
               ::"r"(dst), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(mb)
               : "memory");
}

// torch.sigmoid's formula
__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

// torch.lerp(a, b, w)'s formula
__device__ __forceinline__ float lerp_t(float a, float b, float w) {
  return w < 0.5f ? a + w * (b - a) : b - (b - a) * (1.0f - w);
}

// One halving of the reduce-scatter: of the 2 HALF sequences a lane holds,
// the lanes with bit OFF set keep the upper HALF, the others the lower, each
// adding its partner's part of the kept half.
template <int NS, int HALF, int OFF>
__device__ __forceinline__ void halve(float (&acc)[NS][3], int p) {
  const bool up = p & OFF;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const float lo = acc[i][g], hi = acc[i + HALF][g];
      acc[i][g] = (up ? hi : lo) + __shfl_xor_sync(FULL, up ? lo : hi, OFF);
    }
  }
}

// The lanes OFF apart add their sums of one sequence.
template <int NS, int OFF>
__device__ __forceinline__ void pair_sum(float (&acc)[NS][3]) {
#pragma unroll
  for (int g = 0; g < 3; ++g) acc[0][g] += __shfl_xor_sync(FULL, acc[0][g], OFF);
}

// acc[s][g]: part p's sums of NS (16, 8 or 4) sequences' three gates ->
// acc[0][g]: the sums over all 16 parts of sequence p >> (4 - log2 NS)'s, in
// every lane of the part (halvings while a lane holds more than one
// sequence, then pair sums).
template <int NS>
__device__ __forceinline__ void reduce_scatter(float (&acc)[NS][3], int p) {
  halve<NS, NS / 2, 8>(acc, p);
  halve<NS, NS / 4, 4>(acc, p);
  if constexpr (NS >= 8) halve<NS, NS / 8, 2>(acc, p);
  else pair_sum<NS, 2>(acc);
  if constexpr (NS >= 16) halve<NS, 1, 1>(acc, p);
  else pair_sum<NS, 1>(acc);
}

// acc[s][g] += h[s][part] . w[g] over NS sequences, h's part runs ROW apart
// from hp0.
template <int NS>
__device__ __forceinline__ void chunk_products(const float* hp0, const float (&w)[3][U], float (&acc)[NS][3]) {
#pragma unroll
  for (int q = 0; q < U; q += 4) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(hp0 + s * ROW + q);
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        acc[s][g] = fmaf(v.x, w[g][q], acc[s][g]);
        acc[s][g] = fmaf(v.y, w[g][q + 1], acc[s][g]);
        acc[s][g] = fmaf(v.z, w[g][q + 2], acc[s][g]);
        acc[s][g] = fmaf(v.w, w[g][q + 3], acc[s][g]);
      }
    }
  }
}

// What a forward frame's chunk needs besides its own arrays.
struct FwdFrame {
  const float* hc;    // this frame's h buffer
  const float* xrow;  // this frame's ring row
  float* stage;       // this frame's staging rows
  float br, bz, bn;   // the thread's unit's b_hh
  int p, u, rank, nseq;
  bool unit;
};

// Sequences c0 .. c0 + NS - 1 of a forward frame: their products, the
// reduce-scatter, and the gates of (unit u, sequence c0 + (p >> (4 - log2 NS)))
// into the staging row, by the first lane of the parts that hold it.
template <int NS>
__device__ __forceinline__ void fwd_chunk(const FwdFrame& f, const float (&w)[3][U], int c0) {
  constexpr int SHIFT = NS == 16 ? 0 : NS == 8 ? 1 : 2;
  float acc[NS][3];
#pragma unroll
  for (int s = 0; s < NS; ++s) acc[s][0] = acc[s][1] = acc[s][2] = 0.0f;
  chunk_products<NS>(f.hc + c0 * ROW + f.p * STRIDE, w, acc);
  reduce_scatter<NS>(acc, f.p);
  const int s = c0 + (f.p >> SHIFT);
  if (f.p & ((1 << SHIFT) - 1)) return;
  float h = 0.0f, r = 0.0f, z = 0.0f, nn = 0.0f, hn = 0.0f;
  if (f.unit && s < f.nseq) {
    const float* x = f.xrow + s * XR;
    r = sigm(x[f.u] + (acc[0][0] + f.br));
    z = sigm(x[U + f.u] + (acc[0][1] + f.bz));
    hn = acc[0][2] + f.bn;
    nn = tanhf(x[2 * U + f.u] + r * hn);
    h = lerp_t(nn, f.hc[s * ROW + f.rank * STRIDE + f.u], z);
  }
  float* st = f.stage + s * FST + f.u;
  st[0] = h;
  st[U] = r;
  st[2 * U] = z;
  st[3 * U] = nn;
  st[4 * U] = hn;
}

// xw (B, T, 3n), whh (3n, n), bhh (3n) -> h_out (B, T, n), gates (B, T, 4n):
// r, z, n, hn.  A cluster a group of bc sequences.
__global__ void __launch_bounds__(NT, 1)
gru_ra_fwd(const float* __restrict__ xw, const float* __restrict__ whh, const float* __restrict__ bhh,
           float* __restrict__ h_out, float* __restrict__ gates, int B, int T, int n, int bc) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, u = tid / PARTS, p = tid % PARTS;
  const int j = rank * U + u;  // the unit of this thread's gates
  const bool unit = j < n;
  const int bcp = (bc + SC - 1) / SC * SC, bc4 = (bc + 3) / 4 * 4;
  const int seq0 = static_cast<int>(blockIdx.x / CL) * bc;
  const int nseq = min(bc, B - seq0);  // the group's sequences
  const int n3 = 3 * n, n4 = 4 * n;
  // every run of a block's units is float4s of memory
  const bool vec = n % 4 == 0 && ((reinterpret_cast<size_t>(xw) | reinterpret_cast<size_t>(h_out) |
                                   reinterpret_cast<size_t>(gates)) & 15) == 0;
  const unsigned mbar = smem_u32(smem);        // two mbarriers: h(t) lands on the one of t + 1's parity
  float* hbuf = smem + 4;                      // [2][bcp][ROW]
  float* stages = hbuf + 2 * bcp * ROW;        // [2][bcp][FST]
  float* ring = stages + 2 * bcp * FST;        // [D][bcp][XR]

  float w[3][U];  // W_hh[g n + j, p U + i]
#pragma unroll
  for (int g = 0; g < 3; ++g) {
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int k = p * U + i;
      w[g][i] = unit && k < n ? whh[(size_t)(g * n + j) * n + k] : 0.0f;
    }
  }
  FwdFrame f;
  f.br = unit ? bhh[j] : 0.0f;
  f.bz = unit ? bhh[n + j] : 0.0f;
  f.bn = unit ? bhh[2 * n + j] : 0.0f;
  f.p = p;
  f.u = u;
  f.rank = rank;
  f.nseq = nseq;
  f.unit = unit;
  for (int i = tid; i < 2 * bcp * ROW; i += NT) hbuf[i] = 0.0f;

  auto fetch = [&](int t) {  // the block's slice of XW[t] into its ring row
    if (t < T) {
      float* row = ring + (size_t)(t % D) * bcp * XR;
      const float* src = xw + ((size_t)seq0 * T + t) * n3 + rank * U;
      if (vec) {
        constexpr int V = U / 4;
        for (int e = tid; e < nseq * 3 * V; e += NT) {
          const int s = e / (3 * V), r = e - s * 3 * V, g = r / V, v = r - g * V;
          float* dst = row + s * XR + g * U + 4 * v;
          if (rank * U + 4 * v < n) cp_async16(dst, src + (size_t)s * T * n3 + g * n + 4 * v);
          else *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      } else {
        for (int e = tid; e < nseq * 3 * U; e += NT) {
          const int s = e / (3 * U), r = e - s * 3 * U, g = r / U, i = r - g * U;
          float* dst = row + s * XR + r;
          if (rank * U + i < n) cp_async4(dst, src + (size_t)s * T * n3 + g * n + i);
          else *dst = 0.0f;
        }
      }
    }
    cp_commit();
  };
  if (tid == 0) {
    mbar_init(mbar);
    mbar_init(mbar + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int t = 0; t < D - 1; ++t) fetch(t);
  cp_wait<D - 2>();
  // every block has started, zeroed its h buffers and set up its mbarriers;
  // frame 0 has landed
  cluster.sync();
  const unsigned xch_bytes = CL * nseq * U * sizeof(float);  // a frame's h slices from every block

  for (int t = 0; t < T; ++t) {
    const unsigned mb = mbar + 8 * ((t + 1) & 1);  // h(t)'s
    if (tid == 0) mbar_expect(mb, xch_bytes);
    f.hc = hbuf + (t & 1) * bcp * ROW;
    f.xrow = ring + (size_t)(t % D) * bcp * XR;
    f.stage = stages + (t & 1) * bcp * FST;
    float* hnext = hbuf + ((t + 1) & 1) * bcp * ROW;
    int c0 = 0;
    for (; c0 + 16 <= bc4; c0 += 16) fwd_chunk<16>(f, w, c0);
    if (c0 + 8 <= bc4) {
      fwd_chunk<8>(f, w, c0);
      c0 += 8;
    }
    if (c0 < bc4) fwd_chunk<4>(f, w, c0);
    cp_wait<D - 3>();  // frame t + 1's slice has landed
    __syncthreads();
    // the block's slice of h' for the group's sequences into the next h
    // buffer of every block of the cluster
    constexpr int V = U / 4;
    for (int e = tid; e < CL * nseq * V; e += NT) {
      const int q = e / (nseq * V), rr = e - q * nseq * V, s = rr / V, v = rr - s * V;
      const float4 val = *reinterpret_cast<const float4*>(f.stage + s * FST + 4 * v);
      const unsigned dst = smem_u32(hnext + s * ROW + rank * STRIDE + 4 * v);
      st_async4(cluster_addr(dst, q), val, cluster_addr(mb, q));
    }
    // every thread is past frame t's gates, so frame t - 1's ring row is free
    fetch(t + D - 1);
    if (vec) {  // H[t] and the gates, a run of U at a time
      for (int e = tid; e < nseq * 5 * V; e += NT) {
        const int s = e / (5 * V), r = e - s * 5 * V, g = r / V, v = r - g * V, jj = rank * U + 4 * v;
        if (jj < n) {
          const size_t at = (size_t)(seq0 + s) * T + t;
          const float4 val = *reinterpret_cast<const float4*>(f.stage + s * FST + g * U + 4 * v);
          float* dst = g == 0 ? h_out + at * n + jj : gates + at * n4 + (g - 1) * n + jj;
          *reinterpret_cast<float4*>(dst) = val;
        }
      }
    } else {
      for (int e = tid; e < nseq * 5 * U; e += NT) {
        const int s = e / (5 * U), r = e - s * 5 * U, g = r / U, jj = rank * U + (r - g * U);
        if (jj < n) {
          const size_t at = (size_t)(seq0 + s) * T + t;
          const float v = f.stage[s * FST + r];
          if (g == 0) h_out[at * n + jj] = v;
          else gates[at * n4 + (g - 1) * n + jj] = v;
        }
      }
    }
    mbar_wait(mb, (t >> 1) & 1);  // h(t) is in
  }
  cluster.sync();  // no block leaves while another may still store into it
}

// dh (B, T, n), h (B, T, n), gates (B, T, 4n), whh (3n, n) -> dxw (B, T, 3n):
// dr, dz, dn; dhw (B, T, 3n): dr, dz, dhn.
__global__ void __launch_bounds__(NT, 1)
gru_ra_bwd(const float* __restrict__ dh_in, const float* __restrict__ h_in, const float* __restrict__ gates,
           const float* __restrict__ whh, float* __restrict__ dxw, float* __restrict__ dhw, int B, int T, int n,
           int bc) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, u = tid / PARTS, p = tid % PARTS;
  const int j = rank * U + u;  // the unit of this thread's gates
  const bool unit = j < n;
  // products: columns 2 cp and 2 cp + 1 of W_hh over the half rg of the
  // block's 3U rows; after the pair's exchange, column k = tid
  const int cp = tid >> 1, rg = tid & 1, k = tid;
  const int bcp = (bc + SC - 1) / SC * SC, chunks = bcp / SC;
  const int seq0 = static_cast<int>(blockIdx.x / CL) * bc;
  const int nseq = min(bc, B - seq0);
  const int n3 = 3 * n, n4 = 4 * n;
  const bool vec = n % 4 == 0 && ((reinterpret_cast<size_t>(dh_in) | reinterpret_cast<size_t>(h_in) |
                                   reinterpret_cast<size_t>(gates) | reinterpret_cast<size_t>(dxw) |
                                   reinterpret_cast<size_t>(dhw)) & 15) == 0;
  const unsigned mbar = smem_u32(smem);     // two mbarriers: frame t's parts land on the one of t's parity
  float* recv = smem + 4;                   // [2][CL][U][bcp]: the blocks' parts of dHW W_hh
  float* dls = recv + 2 * CL * U * bcp;     // [2][bcp][DW]: the block's slice of dHW[t]
  float* stages = dls + 2 * bcp * DW;       // [2][bcp][BST]
  float* ring = stages + 2 * bcp * BST;     // [D][bcp][YR]
  float* dhz = ring + D * bcp * YR;         // [chunks][NT]: dh z of the thread's gates

  float wk[R2][2];  // W_hh[g n + rank U + i, 2 cp + c] for the block's row rg R2 + ...
#pragma unroll
  for (int e = 0; e < R2; ++e) {
    const int row = rg * R2 + e, g = row / U, jj = rank * U + (row - g * U);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = 2 * cp + c;
      wk[e][c] = jj < n && col < n ? whh[(size_t)(g * n + jj) * n + col] : 0.0f;
    }
  }

  auto fetch = [&](int t) {  // dH[t], gates[t], H[t - 1] of the block's units into their ring row
    if (t >= 0) {
      float* row = ring + (size_t)(t % D) * bcp * YR;
      if (vec) {
        constexpr int V = U / 4;
        for (int e = tid; e < nseq * 6 * V; e += NT) {
          const int s = e / (6 * V), r = e - s * 6 * V, part = r / V, v = r - part * V, jj = rank * U + 4 * v;
          const size_t at = (size_t)(seq0 + s) * T + t;
          float* dst = row + s * YR + part * U + 4 * v;
          if (jj >= n || (part == 5 && t == 0))
            *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          else if (part == 0) cp_async16(dst, dh_in + at * n + jj);
          else if (part < 5) cp_async16(dst, gates + at * n4 + (part - 1) * n + jj);
          else cp_async16(dst, h_in + (at - 1) * n + jj);
        }
      } else {
        for (int e = tid; e < nseq * 6 * U; e += NT) {
          const int s = e / (6 * U), r = e - s * 6 * U, part = r / U, jj = rank * U + (r - part * U);
          const size_t at = (size_t)(seq0 + s) * T + t;
          float* dst = row + s * YR + r;
          if (jj >= n || (part == 5 && t == 0)) *dst = 0.0f;
          else if (part == 0) cp_async4(dst, dh_in + at * n + jj);
          else if (part < 5) cp_async4(dst, gates + at * n4 + (part - 1) * n + jj);
          else cp_async4(dst, h_in + (at - 1) * n + jj);
        }
      }
    }
    cp_commit();
  };
  if (tid == 0) {
    mbar_init(mbar);
    mbar_init(mbar + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int t = T - 1; t > T - D; --t) fetch(t);
  cp_wait<D - 2>();
  cluster.sync();
  // a frame's parts from every block: U columns of (nseq rounded up to 4) sums
  const unsigned xch_bytes = CL * U * ((nseq + 3) / 4 * 4) * sizeof(float);

  for (int t = T - 1; t >= 0; --t) {
    const unsigned mb = mbar + 8 * (t & 1);  // frame t's parts
    if (tid == 0) mbar_expect(mb, xch_bytes);
    const float* yrow = ring + (size_t)(t % D) * bcp * YR;
    const float* rv = recv + ((t + 1) & 1) * CL * U * bcp;  // frame t + 1's parts
    float* stage = stages + (t & 1) * bcp * BST;
    float* dl = dls + (t & 1) * bcp * DW;
    for (int c = 0; c < chunks; ++c) {
      const int s = c * SC + p;
      float dr = 0.0f, dz = 0.0f, dn = 0.0f, dhn = 0.0f;
      if (unit && s < nseq) {
        float carry = 0.0f;
        if (t < T - 1) {
          float part = 0.0f;
#pragma unroll
          for (int b = 0; b < CL; ++b) part += rv[(b * U + u) * bcp + s];
          carry = dhz[c * NT + tid] + part;
        }
        const float* y = yrow + s * YR;
        const float dh = y[u] + carry, r = y[U + u], z = y[2 * U + u], nn = y[3 * U + u];
        const float hn = y[4 * U + u], hp = y[5 * U + u];
        dn = dh * (1.0f - z) * (1.0f - nn * nn);
        dz = dh * (hp - nn) * (z * (1.0f - z));
        dhn = dn * r;
        dr = dn * hn * (r * (1.0f - r));
        dhz[c * NT + tid] = dh * z;
      }
      float* d = dl + s * DW + u;
      d[0] = dr;
      d[U] = dz;
      d[2 * U] = dhn;
      float* st = stage + s * BST + u;
      st[0] = dr;
      st[U] = dz;
      st[2 * U] = dn;
      st[3 * U] = dhn;
    }
    cp_wait<D - 3>();  // frame t - 1's slice has landed
    __syncthreads();
    // column k of the block's part of dHW[t] W_hh, into unit k's owner, 4
    // sequences a store; the lane pair (rg 0, 1) sums the two halves of the rows
    const unsigned out = cluster_addr(smem_u32(recv + (((t & 1) * CL + rank) * U + k % U) * bcp), k / U);
    const unsigned out_mb = cluster_addr(mb, k / U);
    for (int s0 = 0; s0 < nseq; s0 += 4) {
      float a[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) a[q][0] = a[q][1] = 0.0f;
      const float* d0 = dl + s0 * DW + rg * R2;
#pragma unroll
      for (int e = 0; e < R2; e += 4) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 x = *reinterpret_cast<const float4*>(d0 + q * DW + e);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            a[q][c] = fmaf(x.x, wk[e][c], a[q][c]);
            a[q][c] = fmaf(x.y, wk[e + 1][c], a[q][c]);
            a[q][c] = fmaf(x.z, wk[e + 2][c], a[q][c]);
            a[q][c] = fmaf(x.w, wk[e + 3][c], a[q][c]);
          }
        }
      }
      float sum[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        sum[q] = (rg ? a[q][1] : a[q][0]) + __shfl_xor_sync(FULL, rg ? a[q][0] : a[q][1], 1);
      st_async4(out + 4 * s0, make_float4(sum[0], sum[1], sum[2], sum[3]), out_mb);
    }
    // every thread is past frame t's gates, so frame t + 1's ring row is free
    fetch(t - D + 1);
    if (vec) {  // dXW[t] and dHW[t], a run of U at a time
      constexpr int V = U / 4;
      for (int e = tid; e < nseq * 4 * V; e += NT) {
        const int s = e / (4 * V), r = e - s * 4 * V, g = r / V, v = r - g * V, jj = rank * U + 4 * v;
        if (jj < n) {
          const size_t at = ((size_t)(seq0 + s) * T + t) * n3;
          const float4 val = *reinterpret_cast<const float4*>(stage + s * BST + g * U + 4 * v);
          if (g != 3) *reinterpret_cast<float4*>(dxw + at + g * n + jj) = val;
          if (g != 2) *reinterpret_cast<float4*>(dhw + at + (g == 3 ? 2 : g) * n + jj) = val;
        }
      }
    } else {
      for (int e = tid; e < nseq * 4 * U; e += NT) {
        const int s = e / (4 * U), r = e - s * 4 * U, g = r / U, jj = rank * U + (r - g * U);
        if (jj < n) {
          const size_t at = ((size_t)(seq0 + s) * T + t) * n3;
          const float v = stage[s * BST + r];
          if (g != 3) dxw[at + g * n + jj] = v;
          if (g != 2) dhw[at + (g == 3 ? 2 : g) * n + jj] = v;
        }
      }
    }
    mbar_wait(mb, ((T - 1 - t) >> 1) & 1);  // frame t's parts are in
  }
  cluster.sync();  // no block leaves while another may still store into it
}

// A launch configuration of `blocks` blocks in clusters of CL.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int blocks, int threads, size_t smem, cudaStream_t st) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Launch `kern` over B sequences: bc = ceil(B / seated) of them a cluster (at
// most BC_MAX), `floats(bcp)` floats of shared memory a block.  `seated`, the
// clusters the card seats at once, is asked of cudaOccupancyMaxActiveClusters
// at the first launch (with the kernel's attributes set) and kept by the
// caller.  plan (3 ints, may be null) <- seated, bc, clusters launched.
template <typename... Args, typename... Act>
cudaError_t launch(void (*kern)(Args...), size_t (*floats)(int), int& seated, int B, int* plan, cudaStream_t st,
                   Act... args) {
  if (seated < 0) {
    const size_t most = floats(BC_MAX) * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    ClusterLaunch probe(CL, NT, most, st);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&seated, kern, &probe.cfg);
    if (e == cudaSuccess && seated < 1) e = cudaErrorInvalidConfiguration;
    if (e != cudaSuccess) {
      seated = -1;
      return e;
    }
  }
  const int even = (B + seated - 1) / seated, bc = even < BC_MAX ? even : BC_MAX, clusters = (B + bc - 1) / bc;
  if (plan) {
    plan[0] = seated;
    plan[1] = bc;
    plan[2] = clusters;
  }
  ClusterLaunch grid(clusters * CL, NT, floats((bc + SC - 1) / SC * SC) * sizeof(float), st);
  const cudaError_t e = cudaLaunchKernelEx(&grid.cfg, kern, args..., bc);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

int fwd_seated = -1, bwd_seated = -1;  // each kernel's clusters seated at once, asked at its first launch

}  // namespace

// xw (B, T, 3n), whh (3n, n), bhh (3n) -> h (B, T, n), gates (B, T, 4n); n in
// 1..384; plan (3 ints, or null) <- the clusters the card seats at once, the
// sequences a cluster, the clusters launched.  Returns the launch's CUDA
// error, or cudaErrorInvalidValue for an n out of range.
extern "C" int nnt_gru_ra_fwd(const float* xw, const float* whh, const float* bhh, float* h, float* gates, int B,
                              int T, int n, int* plan, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > NT || B < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(gru_ra_fwd, fwd_floats, fwd_seated, B, plan, s, xw, whh, bhh, h, gates, B, T, n));
}

// dh, h (B, T, n), gates (B, T, 4n), whh (3n, n) -> dxw, dhw (B, T, 3n).  As
// nnt_gru_ra_fwd for n, plan and the return.
extern "C" int nnt_gru_ra_bwd(const float* dh, const float* h, const float* gates, const float* whh, float* dxw,
                              float* dhw, int B, int T, int n, int* plan, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > NT || B < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch(gru_ra_bwd, bwd_floats, bwd_seated, B, plan, s, dh, h, gates, whh, dxw, dhw, B, T, n));
}
