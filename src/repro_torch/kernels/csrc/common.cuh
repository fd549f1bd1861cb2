// Helpers shared by the kernels.  Plain CUDA C++ with a C
// interface (no PyTorch headers): each kernel source builds into its own
// shared library, loaded from Python with ctypes.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ham {

// The reference's masked score, -0.7 * FLT_MAX: finite, so exp(masked - max)
// is exactly 0 and never NaN.
constexpr float kNegInf = -0.7f * 3.402823466e+38f;

// Returned for a shape or dtype the kernel was not built for.
constexpr int kUnsupported = -1;
// Returned when cuTensorMapEncodeTiled refuses a TMA tensor map.
constexpr int kTensorMap = -2;

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
// 4 bytes global -> shared (cp.async.ca: the only sizes below 16 are 4 and
// 8), of which `bytes` (4 or 0) are read and the rest zero-filled
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
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

// ---- Hopper (sm_90a): mbarriers, TMA tile loads, wgmma ---------------------
// Used by the kernels that stage tiles with the Tensor Memory Accelerator and
// multiply them with warpgroup MMA.  The tensor maps are encoded on the host
// (encode_tensor_map below) and passed by value as __grid_constant__ kernel
// parameters, so a captured CUDA graph replays them unchanged.

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// make the initialised barriers visible to the async proxy (TMA) and the block
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}
// arrive and announce `bytes` of TMA traffic that completes the phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// block until the phase of parity `parity` has completed (a fresh barrier
// counts the phase before its first, parity 1, as completed)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_u32(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// TMA: the box at coordinates (c0 innermost, c1, c2) of `map` into shared
// memory at dst, completing `bytes` on bar (out-of-bounds elements read 0)
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile (the layout a
// TMA box with CU_TENSOR_MAP_SWIZZLE_128B writes, 1024-byte aligned): start
// address, leading and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, unsigned lbo, unsigned sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across a
// wgmma fence or wait
template <int N>
__device__ __forceinline__ void wgmma_fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 64, float32, the warpgroup's fragments) (+)= a (64 x 16, bf16) *
// b (16 x 64, bf16); scale_d 0 overwrites d.  kTransA 0: a K-major (its
// rows run along K), 1: M-major; kTransB 0: b K-major, 1: N-major (its
// rows run along N).  Fragment of thread t (warp w = t / 32, lane l):
// d[4 j + i] is row 16 w + l / 4 + 8 (i / 2), column 8 j + 2 (l % 4) + i % 2.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// A 3-D tensor map of a bf16 tensor with dims (d0 innermost, d1, d2), byte
// strides s1, s2 of the outer dims and a (b0, b1, 1) box, for TMA loads.
// cuTensorMapEncodeTiled is not in the runtime library; it is reached
// through cudaGetDriverEntryPoint, so the libraries link no -lcuda.
// Returns false if the map is refused (a base or stride that is no
// multiple of 16 bytes, a box too large for the swizzle).
inline bool encode_tensor_map(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1,
                              uint64_t d2, uint64_t s1, uint64_t s2, unsigned b0, unsigned b1,
                              CUtensorMapSwizzle swizzle) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess || found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<Encode>(fn);
  }();
  if (!encode) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {s1, s2};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor map of encode_tensor_map, encoded once per distinct argument
// set and then served from a small table: a layer's weights keep their
// address for the whole run, so a decode step encodes no map.  The key is
// every argument the map encodes, so a hit is always the map the call
// needs, even for a tensor freed and reallocated at the same address.  Not
// thread-safe: one host thread launches the kernels.  nullptr if the map is
// refused.
inline const CUtensorMap* cached_tensor_map(const void* base, uint64_t d0, uint64_t d1,
                                            uint64_t d2, uint64_t s1, uint64_t s2, unsigned b0,
                                            unsigned b1, CUtensorMapSwizzle swizzle) {
  struct Entry {
    const void* base;
    uint64_t d0, d1, d2, s1, s2;
    unsigned b0, b1;
    CUtensorMapSwizzle swizzle;
    CUtensorMap map;
  };
  constexpr int kSlots = 256;
  static Entry table[kSlots];
  static int used = 0, next = 0;
  for (int i = 0; i < used; ++i) {
    const Entry& e = table[i];
    if (e.base == base && e.d0 == d0 && e.d1 == d1 && e.d2 == d2 && e.s1 == s1 && e.s2 == s2 &&
        e.b0 == b0 && e.b1 == b1 && e.swizzle == swizzle)
      return &e.map;
  }
  Entry& e = table[next];  // a full table replaces its oldest entry
  if (!encode_tensor_map(&e.map, base, d0, d1, d2, s1, s2, b0, b1, swizzle)) return nullptr;
  e.base = base;
  e.d0 = d0, e.d1 = d1, e.d2 = d2, e.s1 = s1, e.s2 = s2;
  e.b0 = b0, e.b1 = b1, e.swizzle = swizzle;
  used = used < kSlots ? used + 1 : kSlots;
  next = (next + 1) % kSlots;
  return &e.map;
}

// Raise the dynamic shared-memory cap of `kernel` to `bytes` (above 48 KB a
// launch is refused without it).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// allow_smem for each device the first time a kernel launches there (a
// host-side call that a host-bound decode step would pay on every launch
// otherwise).  One set of flags per kernel.
template <auto kernel>
inline cudaError_t allow_smem_once(size_t bytes) {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && done[device]) return cudaSuccess;
  err = allow_smem(kernel, bytes);
  if (err == cudaSuccess && device < kMaxDevices) done[device] = true;
  return err;
}

}  // namespace ham

extern "C" const char* ham_error_string(int err) {
  if (err == ham::kUnsupported) return "unsupported shape (head_dim, q_per_kv, experts) or dtype";
  if (err == ham::kTensorMap) return "cuTensorMapEncodeTiled refused a TMA tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
