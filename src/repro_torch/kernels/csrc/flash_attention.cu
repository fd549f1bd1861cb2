// Flash attention (tiled online softmax, GQA, causal or not, forward only)
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (_flash_kernel): query head h of sequence b attends over kv head
// h / (H / Hkv) (the Pallas kernel's bh // q_per_kv), with keys j <= i
// when causal.
//
// Bound on an H100: operations (a causal prefill of S=1024 over 48 heads of
// d=128 does ~12.9 GFLOP on ~29 MB).  Design of this first version:
//  * one block of 16x16 threads per (64-query tile, b*H + h); the q tile,
//    one 64-key K and V tile and the 64x64 probability tile sit in shared
//    memory as float32, the running max/sum and the 64 x d output
//    accumulator in registers (each thread owns 4 rows x d/16 columns);
//  * the key-tile loop stops at the causal diagonal (the Pallas kernel
//    skipped those tiles with pl.when), and query tiles with the most key
//    tiles are launched first;
//  * q/k/v/o go through (b, h, s) strides, so the model's (B, S, H, d)
//    activations are read and written in place.
// The products run on the CUDA cores in float32 (as the Pallas kernel's
// upcast did); tensor-core tiles, TMA and warp specialisation come later.
#include "common.cuh"

namespace ham {
namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBQ = 64;        // queries per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kPad = 4;        // row padding (floats): conflict-free float4 rows
constexpr int kChunk = 4;      // 16-byte loads in flight per thread and tensor

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + kPad) + kBK * (D + kPad) + kBK * D + kBQ * (kBK + kPad));
}

template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int stride, const T* src, int64_t s_stride,
                                          int row0, int rows_valid, float scale, int tid) {
  // rows [row0, row0 + 64) of src -> dst[64][stride] as float * scale;
  // rows at or past rows_valid are zero
  constexpr int VN = Vec<T>::N, VPR = D / VN, kVecs = 64 * VPR;
  for (int base = 0; base < kVecs; base += kThreads * kChunk) {
    uint4 raw[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int idx = base + u * kThreads + tid;
      const int row = idx / VPR, c = (idx % VPR) * VN;
      const bool ok = idx < kVecs && row0 + row < rows_valid;
      raw[u] = ok ? load16(src + (row0 + row) * s_stride + c) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int idx = base + u * kThreads + tid;
      if (idx < kVecs) {
        const int row = idx / VPR, c = (idx % VPR) * VN;
        float f[VN];
        Vec<T>::to_float(raw[u], f);
#pragma unroll
        for (int e = 0; e < VN; ++e) dst[row * stride + c + e] = f[e] * scale;
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int H, int Hkv, int S, int Skv, int causal,
             int64_t q_sb, int64_t q_sh, int64_t q_ss,
             int64_t k_sb, int64_t k_sh, int64_t k_ss,
             int64_t v_sb, int64_t v_sh, int64_t v_ss,
             int64_t o_sb, int64_t o_sh, int64_t o_ss, float scale) {
  constexpr int QS = D + kPad;    // q/k tile row stride
  constexpr int PS = kBK + kPad;  // p tile row stride
  constexpr int CD = D / 16;      // output columns per thread
  static_assert(D % 16 == 0, "head_dim");

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBQ][QS], scaled
  float* ks = qs + kBQ * QS;                    // [kBK][QS]
  float* vs = ks + kBK * QS;                    // [kBK][D]
  float* ps = vs + kBK * D;                     // [kBQ][PS]

  const int iq = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // heaviest first
  const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int q0 = iq * kBQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;

  load_tile<T, D>(qs, QS, q + b * q_sb + h * q_sh, q_ss, q0, S, scale, tid);

  float m_i[4], l_i[4], acc[4][CD];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_i[r] = kNegInf;
    l_i[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[r][c] = 0.f;
  }

  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_end = causal ? min(Skv, q_last + 1) : Skv;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed; the q tile is written
    load_tile<T, D>(ks, QS, kb, k_ss, k0, Skv, 1.f, tid);
    load_tile<T, D>(vs, D, vb, v_ss, k0, Skv, 1.f, tid);
    __syncthreads();

    // s[r][c] = q[ty + 16r] . k[tx + 16c]
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 2
    for (int i = 0; i < D; i += 4) {
      float4 qa[4], kk[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qa[r] = *reinterpret_cast<const float4*>(qs + (ty + 16 * r) * QS + i);
#pragma unroll
      for (int c = 0; c < 4; ++c) kk[c] = *reinterpret_cast<const float4*>(ks + (tx + 16 * c) * QS + i);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s[r][c] += qa[r].x * kk[c].x + qa[r].y * kk[c].y + qa[r].z * kk[c].z + qa[r].w * kk[c].w;
    }

    // mask, then the online softmax of each row across its 16 threads
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + ty + 16 * r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tx + 16 * c;
        if (kj >= Skv || (causal && kj > qi)) s[r][c] = kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[r], mx);
      const float alpha = expf(m_i[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - m_new);
        ps[(ty + 16 * r) * PS + tx + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_i[r] = alpha * l_i[r] + sum;
      m_i[r] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

    // acc[r][c] += p[ty + 16r][:] . v[:][tx + 16c]
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float pr[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(ps + (ty + 16 * r) * PS + j);
        pr[r][0] = p4.x;
        pr[r][1] = p4.y;
        pr[r][2] = p4.z;
        pr[r][3] = p4.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          const float vv = vs[(j + u) * D + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][c] += pr[r][u] * vv;
        }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty + 16 * r;
    if (qi < S) {
      const float l = fmaxf(l_i[r], 1e-30f);
      T* orow = o + b * o_sb + h * o_sh + qi * o_ss;
#pragma unroll
      for (int c = 0; c < CD; ++c) store(orow + tx + 16 * c, acc[r][c] / l);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv, int S,
           int Skv, int causal, const long long* st, cudaStream_t stream) {
  auto kernel = flash_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem_bytes<D>());
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, smem_bytes<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Hkv, S, Skv, causal, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], 1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv,
             int S, int Skv, int causal, const long long* st, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, B, H, Hkv, S, Skv, causal, st, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, Hkv, S, Skv, causal, st, stream);
    case 80: return launch<T, 80>(q, k, v, o, B, H, Hkv, S, Skv, causal, st, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, Hkv, S, Skv, causal, st, stream);
    default: return kUnsupported;
  }
}

}  // namespace
}  // namespace ham

// q/o (B, H, S, d), k/v (B, Hkv, Skv, d): element strides of the three outer
// dims (the last dim is contiguous).  Returns 0 or the launch error.
extern "C" int ham_flash_attention(
    const void* q, const void* k, const void* v, void* o,
    int B, int H, int Hkv, int S, int Skv, int d, int causal, int dtype,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int device, void* stream) {
  if (Hkv < 1 || H % Hkv) return ham::kUnsupported;
  if (B == 0 || H == 0 || S == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                            v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ham::kF32: return ham::dispatch<float>(d, q, k, v, o, B, H, Hkv, S, Skv, causal, st, s);
    case ham::kBF16:
      return ham::dispatch<__nv_bfloat16>(d, q, k, v, o, B, H, Hkv, S, Skv, causal, st, s);
    default: return ham::kUnsupported;
  }
}
