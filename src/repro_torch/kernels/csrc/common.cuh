// Helpers shared by the kernels.  Plain CUDA C++ with a C
// interface (no PyTorch headers): each kernel source builds into its own
// shared library, loaded from Python with ctypes.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ham {

// The reference's masked score, -0.7 * FLT_MAX: finite, so exp(masked - max)
// is exactly 0 and never NaN.
constexpr float kNegInf = -0.7f * 3.402823466e+38f;

// Returned for a shape or dtype the kernel was not built for.
constexpr int kUnsupported = -1;

enum DType : int { kF32 = 0, kBF16 = 1 };

// 16 bytes of T (one vector load) as floats.
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void to_float(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  // bf16 is the high half of a float; element 2i is the low half of word i
  __device__ __forceinline__ static void to_float(const uint4& r, float* f) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
// round to nearest even, as torch's float -> bfloat16 conversion
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// -- asynchronous copies and tensor-core tiles (mma.sync m16n8k16, bf16) --
// Fragment layouts, thread t = lane, g = t / 4, q = t % 4: A (16 x 16)
// a0 (row g, cols 2q, 2q+1), a1 (row g+8), a2 (row g, cols 2q+8, 2q+9),
// a3 (row g+8, cols 2q+8, 2q+9); B (16 x 8) b0 (rows 2q, 2q+1 of col g),
// b1 (rows 2q+8, 2q+9); C (16 x 8) c0, c1 (row g, cols 2q, 2q+1), c2, c3
// (row g+8).

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, of which the first `bytes` are read and the rest
// zero-filled (0 reads nothing, and src may then be any valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// c (16 x 8, float32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as one bf16x2 register, lo in the low half (an A-fragment pair)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Raise the dynamic shared-memory cap of `kernel` to `bytes` (above 48 KB a
// launch is refused without it).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace ham

extern "C" const char* ham_error_string(int err) {
  if (err == ham::kUnsupported) return "unsupported shape (head_dim, q_per_kv, experts) or dtype";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
