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
