// A float32 64 x 64 tile product on the CUDA cores, shared by the mLSTM and
// SSD backward kernels (csrc/mlstm_bwd.cu, csrc/mamba2_ssd_bwd.cu).
//
// A block of 256 threads (16 x 16) owns one 64 x 64 output tile; thread
// (ty, tx) accumulates rows 4 ty .. 4 ty + 3 and columns 4 tx .. 4 tx + 3 in
// registers.  Operands come through loader functors, so one routine serves
// every product of both backward passes whatever the layout, scaling and
// masking of its operands:
//   A(r, k): row r (0..63) of the tile, contraction index k;
//   B(k, c): contraction index k, column c (0..63) of the tile;
// each with `kKFast`, whether consecutive k are adjacent in memory (then
// consecutive threads load along k, else along the tile's rows/columns), so
// global loads stay coalesced.  A loader returns 0 outside its operand.
// Each 16-deep slice of A and B is staged in shared memory as float32; the
// sum over k runs in a fixed order, so results repeat bit for bit.
#pragma once

#include "common.cuh"

namespace ham {
namespace tile {

constexpr int kT = 64;         // tile edge
constexpr int kK = 16;         // contraction slice staged at once
constexpr int kThreads = 256;  // 16 x 16 threads, a 4 x 4 micro-tile each
constexpr int kLd = kT + 4;    // row pitch of a staged slice (floats)

struct Smem {
  __align__(16) float a[kK][kLd];
  __align__(16) float b[kK][kLd];
  float red[kT][17];   // row or column partial sums (reduce_rows / reduce_cols)
  float blk[kThreads];  // block sums (reduce_block)
};

template <typename T> __device__ __forceinline__ float ldf(const T* p);
template <> __device__ __forceinline__ float ldf<float>(const float* p) { return *p; }
template <> __device__ __forceinline__ float ldf<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ int tx() { return static_cast<int>(threadIdx.x) % 16; }
__device__ __forceinline__ int ty() { return static_cast<int>(threadIdx.x) / 16; }

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

__device__ __forceinline__ void scale(float (&acc)[4][4], float s) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] *= s;
}

// Loaders of a row-major float32 matrix m (ld floats a row), kept in the
// kernels' scratch:
// A(r, k) = m[r0 + r][k]
struct MatRowK {
  static constexpr bool kKFast = true;
  const float* m; int64_t ld; int r0;
  __device__ float operator()(int r, int k) const { return m[(r0 + r) * ld + k]; }
};
// A(r, k) = m[k][r0 + r], the transpose
struct MatT {
  static constexpr bool kKFast = false;
  const float* m; int64_t ld; int r0;
  __device__ float operator()(int r, int k) const { return m[k * ld + r0 + r]; }
};
// B(k, c) = m[k][c0 + c], zero at columns >= cols
struct MatKCol {
  static constexpr bool kKFast = false;
  const float* m; int64_t ld; int c0, cols;
  __device__ float operator()(int k, int c) const {
    return c0 + c < cols ? m[k * ld + c0 + c] : 0.f;
  }
};
// B(k, c) = m[c0 + c][k], the transpose, zero at rows >= rows
struct MatTK {
  static constexpr bool kKFast = true;
  const float* m; int64_t ld; int c0, rows;
  __device__ float operator()(int k, int c) const {
    return c0 + c < rows ? m[(c0 + c) * ld + k] : 0.f;
  }
};

// acc += A[:, k0:k1] B[k0:k1, :]
template <class LA, class LB>
__device__ __forceinline__ void mma(float (&acc)[4][4], const LA& A, const LB& B, int k0, int k1,
                                    Smem& sm) {
  const int tid = static_cast<int>(threadIdx.x);
  for (int kb = k0; kb < k1; kb += kK) {
    for (int idx = tid; idx < kK * kT; idx += kThreads) {
      int kk = LA::kKFast ? idx % kK : idx / kT;
      int rr = LA::kKFast ? idx / kK : idx % kT;
      sm.a[kk][rr] = kb + kk < k1 ? A(rr, kb + kk) : 0.f;
      kk = LB::kKFast ? idx % kK : idx / kT;
      rr = LB::kKFast ? idx / kK : idx % kT;
      sm.b[kk][rr] = kb + kk < k1 ? B(kb + kk, rr) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&sm.a[kk][4 * ty()]);
      const float4 b = *reinterpret_cast<const float4*>(&sm.b[kk][4 * tx()]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
}

// Store the tile to out[r * ld + c] (float32, every element).
__device__ __forceinline__ void store_tile(float* out, int64_t ld, const float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(out + (4 * ty() + i) * ld + 4 * tx()) = v;
  }
}

// Sum over the tile's columns, per row: part[i] is this thread's sum over
// its 4 columns of row 4 ty + i; returns the row's total to threads 0..63
// (thread r holds row r), the 16 partials added in column order.
__device__ __forceinline__ float reduce_rows(const float (&part)[4], Smem& sm) {
#pragma unroll
  for (int i = 0; i < 4; ++i) sm.red[4 * ty() + i][tx()] = part[i];
  __syncthreads();
  float s = 0.f;
  const int tid = static_cast<int>(threadIdx.x);
  if (tid < kT)
    for (int j = 0; j < 16; ++j) s += sm.red[tid][j];
  __syncthreads();
  return s;
}

// Sum over the tile's rows, per column: part[j] is this thread's sum over
// its 4 rows of column 4 tx + j; returns the column's total to threads
// 0..63 (thread c holds column c), the 16 partials added in row order.
__device__ __forceinline__ float reduce_cols(const float (&part)[4], Smem& sm) {
#pragma unroll
  for (int j = 0; j < 4; ++j) sm.red[4 * tx() + j][ty()] = part[j];
  __syncthreads();
  float s = 0.f;
  const int tid = static_cast<int>(threadIdx.x);
  if (tid < kT)
    for (int i = 0; i < 16; ++i) s += sm.red[tid][i];
  __syncthreads();
  return s;
}

// Sum of one value a thread over the block, in a fixed tree order; the
// total is returned to every thread.
__device__ __forceinline__ float reduce_block(float x, Smem& sm) {
  const int tid = static_cast<int>(threadIdx.x);
  sm.blk[tid] = x;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half /= 2) {
    if (tid < half) sm.blk[tid] += sm.blk[tid + half];
    __syncthreads();
  }
  const float s = sm.blk[0];
  __syncthreads();
  return s;
}

}  // namespace tile
}  // namespace ham
