// A bf16 tensor-core 64 x 64 tile product (mma.sync m16n8k16, float32
// accumulators), for the mLSTM backward's tensor-core route
// (csrc/mlstm_bwd.cu); csrc/tile_f32.cuh is its float32 CUDA-core sibling.
//
// A block of 128 threads (4 warps) owns one 64 x N output tile, N = 8 NJ
// (64 or 128: the wider tile reads half the A operand per product, and L2
// bandwidth, not the tensor cores, bounds these products); warp w
// accumulates rows 16 w .. 16 w + 15, all N columns, in the mma layout:
// acc[j][e] is row 16 w + lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) +
// e % 2.  Operands come through loader functors, as in tile_f32.cuh, so
// one routine serves every product whatever the layout, scaling and
// masking of its operands.  A loader states one operand, A (64 rows x K)
// or B (K x 64 columns), by its non-contracted index m (A's row, B's
// column) and the contraction index k, and fetches 8 values at once:
//   kKMajor: values (m, k + i)  (the 8 run along k: staged [m][k]);
//   else:    values (m + i, k)  (the 8 run along m: staged [k][m]);
// whichever the operand's memory holds contiguously, so a fetch is one
// 16-byte load.  A fetch has two phases: `load(m, k)` issues the loads and
// returns them raw (a `Raw` of the loader's own), `pack(raw)` applies the
// loader's scaling and masks and returns the 8 values as bf16 (rounded to
// nearest even; a plain bf16 operand passes through untouched).  A loader
// returns 0 outside its operand.  Each 32-deep slice of A and B is staged
// in shared memory as bf16, double-buffered: the next slice's loads are in
// flight while the current one is multiplied, and packed and stored after,
// one barrier a slice; ldmatrix feeds the fragments, .trans where the slice
// is [k][m].  The sum over k runs in a fixed order, so results repeat bit
// for bit.
#pragma once

#include "common.cuh"

namespace ham {
namespace tc {

constexpr int kT = 64;          // output rows of a tile
constexpr int kWide = 128;      // most columns of a tile
constexpr int kK = 32;          // contraction slice staged at once
constexpr int kThreads = 128;   // 4 warps of 16 output rows
constexpr int kLdK = kK + 8;    // row pitch (bf16) of a [m][kK] slice: conflict-free ldmatrix
// row pitch of a [kK][m] slice of m columns
__host__ __device__ constexpr int ld_m(int m) { return m + 8; }
// bf16 elements of a staged slice of m rows or columns, either layout
__host__ __device__ constexpr int slice(int m) {
  return m * kLdK > kK * ld_m(m) ? m * kLdK : kK * ld_m(m);
}

// Shared memory of the products of a kernel whose tiles are at most W
// columns wide (a kernel of 64-column tiles keeps to the smaller one, so
// more of its blocks fit an SM)
template <int W>
struct SmemW {
  static constexpr int kW = W;
  __align__(16) __nv_bfloat16 a[2][slice(kT)];
  __align__(16) __nv_bfloat16 b[2][slice(W)];
  float red[kThreads / 32][W];  // per-warp column partials (col_sum)
  float blk[kThreads / 32];     // per-warp sums (block_sum)
};
using Smem = SmemW<kWide>;
using Smem64 = SmemW<kT>;

__device__ __forceinline__ int lane() { return static_cast<int>(threadIdx.x) % 32; }
__device__ __forceinline__ int warp() { return static_cast<int>(threadIdx.x) / 32; }
// row and column of accumulator element (j, e)
__device__ __forceinline__ int row(int e) { return 16 * warp() + lane() / 4 + 8 * (e >> 1); }
__device__ __forceinline__ int col(int j, int e) { return 8 * j + 2 * (lane() % 4) + (e & 1); }

template <int NJ>
__device__ __forceinline__ void zero(float (&acc)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

template <int NJ>
__device__ __forceinline__ void scale(float (&acc)[NJ][4], float s) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= s;
}

// 8 bf16 (one 16-byte load) as floats, and back
__device__ __forceinline__ void unpack8(const uint4& u, float (&x)[8]) {
  Vec<__nv_bfloat16>::to_float(u, x);
}
__device__ __forceinline__ uint4 pack8(const float (&x)[8]) {
  return make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]), pack_bf16(x[4], x[5]),
                    pack_bf16(x[6], x[7]));
}

// the 8 bf16 of u with those at index >= keep (0..8) zeroed
__device__ __forceinline__ uint4 keep_first(uint4 u, int keep) {
  unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = 2 * i >= keep ? 0u : 2 * i + 1 >= keep ? (w[i] & 0xffffu) : w[i];
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// one thread's share of a slice of an operand of M (non-contracted) by kK
template <class Ld, int M>
struct Share {
  static constexpr int kN = M * kK / 8 / kThreads;  // vectors a thread
  typename Ld::Raw raw[kN];
  bool on[kN];
};

template <class Ld, int M>
__device__ __forceinline__ void slice_index(int v, int& m, int& k) {
  m = Ld::kKMajor ? v / (kK / 8) : (v % (M / 8)) * 8;
  k = Ld::kKMajor ? (v % (kK / 8)) * 8 : v / (M / 8);
}

template <class Ld, int M>
__device__ __forceinline__ void fetch(Share<Ld, M>& sh, const Ld& ld, int kb, int k1) {
#pragma unroll
  for (int u = 0; u < Share<Ld, M>::kN; ++u) {
    int m, k;
    slice_index<Ld, M>(static_cast<int>(threadIdx.x) + u * kThreads, m, k);
    sh.on[u] = kb + k < k1;
    if (sh.on[u]) sh.raw[u] = ld.load(m, kb + k);
  }
}

template <class Ld, int M>
__device__ __forceinline__ void put(__nv_bfloat16* dst, const Share<Ld, M>& sh, const Ld& ld,
                                    int kb, int k1) {
#pragma unroll
  for (int u = 0; u < Share<Ld, M>::kN; ++u) {
    int m, k;
    slice_index<Ld, M>(static_cast<int>(threadIdx.x) + u * kThreads, m, k);
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (sh.on[u]) {
      x = ld.pack(sh.raw[u]);
      if (Ld::kKMajor && kb + k + 8 > k1) x = keep_first(x, k1 - kb - k);
    }
    *reinterpret_cast<uint4*>(dst + (Ld::kKMajor ? m * kLdK + k : k * ld_m(M) + m)) = x;
  }
}

// acc += A[:, k0:k1] B[k0:k1, :] for a 64 x 8 NJ tile; k0 a multiple of 8.
// Every thread of the block calls it (it synchronises the block).
template <int NJ, class LA, class LB, class SM>
__device__ __forceinline__ void mma(float (&acc)[NJ][4], const LA& A, const LB& B, int k0, int k1,
                                    SM& sm) {
  constexpr int N = 8 * NJ;
  static_assert((N == kT || N == kWide) && N <= SM::kW, "tile width");
  if (k0 >= k1) return;
  const int ln = lane(), m0 = 16 * warp();
  Share<LA, kT> sa;
  Share<LB, N> sb;
  fetch(sa, A, k0, k1);
  fetch(sb, B, k0, k1);
  put(sm.a[0], sa, A, k0, k1);
  put(sm.b[0], sb, B, k0, k1);
  __syncthreads();
  int buf = 0;
  for (int kb = k0; kb < k1; kb += kK, buf ^= 1) {
    const bool more = kb + kK < k1;
    if (more) {  // the next slice's loads, in flight during the products
      fetch(sa, A, kb + kK, k1);
      fetch(sb, B, kb + kK, k1);
    }
    const __nv_bfloat16* a = sm.a[buf];
    const __nv_bfloat16* b = sm.b[buf];
#pragma unroll
    for (int kk = 0; kk < kK / 16; ++kk) {
      unsigned af[4];
      if constexpr (LA::kKMajor)
        ldmatrix_x4(af, a + (m0 + (ln & 15)) * kLdK + kk * 16 + (ln >> 4) * 8);
      else
        ldmatrix_x4_trans(af, a + (kk * 16 + (ln >> 4) * 8 + (ln & 7)) * ld_m(kT) + m0 +
                                  ((ln >> 3) & 1) * 8);
#pragma unroll
      for (int np = 0; np < NJ / 2; ++np) {
        unsigned bf[4];
        if constexpr (LB::kKMajor)
          ldmatrix_x4(bf, b + (np * 16 + (ln & 7) + (ln >> 4) * 8) * kLdK + kk * 16 +
                              ((ln >> 3) & 1) * 8);
        else
          ldmatrix_x4_trans(bf, b + (kk * 16 + (ln & 15)) * ld_m(N) + np * 16 + (ln >> 4) * 8);
        mma_bf16(acc[2 * np], af, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
      }
    }
    if (more) {  // buf ^ 1 was last read before the previous barrier
      put(sm.a[buf ^ 1], sa, A, kb + kK, k1);
      put(sm.b[buf ^ 1], sb, B, kb + kK, k1);
    }
    __syncthreads();
  }
}

// Store the tile to out[r * ld + c] (float32, every element), and as bf16
// to out16 unless null.
template <int NJ>
__device__ __forceinline__ void store_tile(float* out, __nv_bfloat16* out16, int64_t ld,
                                           const float (&acc)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int64_t at = row(2 * hh) * ld + col(j, 0);
      if (out)
        *reinterpret_cast<float2*>(out + at) = make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
      if (out16)
        *reinterpret_cast<unsigned*>(out16 + at) = pack_bf16(acc[j][2 * hh], acc[j][2 * hh + 1]);
    }
}

// Sum over a row's 8 NJ columns of the per-element values v: returned for
// the thread's rows row(0) (hh 0) and row(2) (hh 1), to all 4 lanes of the
// row's quad; the thread's 2 NJ columns in order, then the quad's tree.
template <int NJ>
__device__ __forceinline__ float row_sum(const float (&v)[NJ][4], int hh) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) s += v[j][2 * hh] + v[j][2 * hh + 1];
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s;
}

// Sum over the tile's 64 rows of the per-element values v, per column:
// returned to threads 0 .. 8 NJ - 1 (thread c holds column c); each warp's
// 16 rows by a fixed lane tree, then the 4 warps in order.
template <int NJ, class SM>
__device__ __forceinline__ float col_sum(const float (&v)[NJ][4], SM& sm) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float s = v[j][i] + v[j][2 + i];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (lane() < 4) sm.red[warp()][col(j, i)] = s;
    }
  __syncthreads();
  float s = 0.f;
  const int tid = static_cast<int>(threadIdx.x);
  if (tid < 8 * NJ)
    for (int w = 0; w < kThreads / 32; ++w) s += sm.red[w][tid];
  __syncthreads();
  return s;
}

// Sum of one value a thread over the block in a fixed order, returned to
// every thread.
template <class SM>
__device__ __forceinline__ float block_sum(float x, SM& sm) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if (lane() == 0) sm.blk[warp()] = x;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) s += sm.blk[w];
  __syncthreads();
  return s;
}

}  // namespace tc
}  // namespace ham
