// Single-token GQA decode attention over a KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (_decode_kernel): for each sequence b and kv head h, the q_per_kv query
// heads of the group attend over keys j < lengths[b] of the cache, with an
// online softmax in float32.
//
// Bound on an H100: bytes (the valid K/V prefix is read once; 4 flops per
// cached element per query head).  Design:
//  * one block per (kv head, sequence) holds the whole query group, so each
//    K/V element leaves device memory once per group;
//  * K/V are read through (b, h, s) strides in 16-byte vectors, straight
//    from the model's (B, S, Hkv, d) cache with no transpose;
//  * 128-key tiles of K and V go to shared memory as float32; thread j
//    scores key j against every query head, one warp per head updates the
//    running max/sum, and output element e = g * d + c of the group (column
//    c of head g) is accumulated by thread e % 128: with d dividing 128 that
//    is column tid % d of heads tid / d, tid / d + 128 / d, ...; with d = 80
//    (zamba2's shared block) a thread holds columns of several heads; the
//    tile loop stops at lengths[b].
#include "common.cuh"

namespace ham {
namespace {

constexpr int kThreads = 128;  // one key per thread in the score phase
constexpr int kBlockK = 128;   // keys per tile
constexpr int kMaxQpk = 16;    // query heads per kv head
constexpr int kPad = 4;        // K-tile row padding (floats): conflict-free float4 rows
constexpr int kChunk = 8;      // 16-byte loads in flight per thread and tensor

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kMaxQpk * D + kBlockK * (D + kPad) + kBlockK * D +
                          kMaxQpk * kBlockK + 3 * kMaxQpk);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ lengths, T* __restrict__ out, int qpk, int S,
              int64_t q_sb, int64_t q_sh, int64_t q_sg,
              int64_t k_sb, int64_t k_sh, int64_t k_ss,
              int64_t v_sb, int64_t v_sh, int64_t v_ss,
              int64_t o_sb, int64_t o_sh, int64_t o_sg, float scale) {
  constexpr int VN = Vec<T>::N;        // elements per 16-byte vector
  constexpr int VPR = D / VN;          // vectors per row
  constexpr int KS = D + kPad;         // K-tile row stride
  constexpr bool kSplit = kThreads % D == 0;  // D divides the block: one column per thread
  constexpr int R = (kMaxQpk * D + kThreads - 1) / kThreads;  // output accumulators per thread
  constexpr int kVecs = kBlockK * VPR; // vectors per K (or V) tile
  static_assert(D % VN == 0 && D % 4 == 0 && kBlockK == kThreads, "tile shape");

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kMaxQpk][D], scaled
  float* ks = qs + kMaxQpk * D;                 // [kBlockK][KS]
  float* vs = ks + kBlockK * KS;                // [kBlockK][D]
  float* ps = vs + kBlockK * D;                 // [kMaxQpk][kBlockK] scores, then p
  float* m_s = ps + kMaxQpk * kBlockK;          // running max per head
  float* l_s = m_s + kMaxQpk;                   // running sum per head
  float* a_s = l_s + kMaxQpk;                   // this tile's rescale per head

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int len = min(max(lengths[b], 0), S);
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  // the group's query rows, scaled by 1/sqrt(d) as the Pallas kernel does
  for (int idx = tid; idx < qpk * VPR; idx += kThreads) {
    const int g = idx / VPR, c = (idx % VPR) * VN;
    float f[VN];
    Vec<T>::to_float(load16(q + b * q_sb + h * q_sh + g * q_sg + c), f);
#pragma unroll
    for (int e = 0; e < VN; ++e) qs[g * D + c + e] = f[e] * scale;
  }
  if (tid < qpk) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // accumulator r holds output element e = tid + r * kThreads: head e / D, column e % D
  const auto head = [tid](int r) { return (tid + r * kThreads) / D; };
  const auto column = [tid](int r) { return (tid + r * kThreads) % D; };
  const int warp = tid / 32, lane = tid % 32;
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < len; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed; q and the stats are written

    // K and V tiles -> shared memory as float; rows at or past len are zero
    for (int base = 0; base < kVecs; base += kThreads * kChunk) {
      uint4 rk[kChunk], rv[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int idx = base + u * kThreads + tid;
        const int row = idx / VPR, c = (idx % VPR) * VN;
        const bool ok = idx < kVecs && k0 + row < len;
        rk[u] = ok ? load16(kb + (k0 + row) * k_ss + c) : make_uint4(0, 0, 0, 0);
        rv[u] = ok ? load16(vb + (k0 + row) * v_ss + c) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int idx = base + u * kThreads + tid;
        if (idx < kVecs) {
          const int row = idx / VPR, c = (idx % VPR) * VN;
          float f[VN];
          Vec<T>::to_float(rk[u], f);
#pragma unroll
          for (int e = 0; e < VN; ++e) ks[row * KS + c + e] = f[e];
          Vec<T>::to_float(rv[u], f);
#pragma unroll
          for (int e = 0; e < VN; ++e) vs[row * D + c + e] = f[e];
        }
      }
    }
    __syncthreads();

    // scores: thread j takes key k0 + j against every query head
    {
      float s[kMaxQpk];
#pragma unroll
      for (int g = 0; g < kMaxQpk; ++g) s[g] = 0.f;
      const float* krow = ks + tid * KS;
#pragma unroll 4
      for (int i = 0; i < D; i += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(krow + i);
#pragma unroll
        for (int g = 0; g < kMaxQpk; ++g) {
          if (g < qpk) {
            const float4 qv = *reinterpret_cast<const float4*>(qs + g * D + i);
            s[g] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
          }
        }
      }
      const bool valid = k0 + tid < len;
#pragma unroll
      for (int g = 0; g < kMaxQpk; ++g)
        if (g < qpk) ps[g * kBlockK + tid] = valid ? s[g] : kNegInf;
    }
    __syncthreads();

    // online softmax: warp w updates heads w, w + 4, ...
    for (int g = warp; g < qpk; g += kThreads / 32) {
      float x[kBlockK / 32];
      float mx = kNegInf;
#pragma unroll
      for (int r = 0; r < kBlockK / 32; ++r) {
        x[r] = ps[g * kBlockK + lane + 32 * r];
        mx = fmaxf(mx, x[r]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < kBlockK / 32; ++r) {
        const float p = expf(x[r] - m_new);
        ps[g * kBlockK + lane + 32 * r] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g][col] = alpha_g * acc + sum_j p[g][j] * V[j][col]; keys past len
    // have p = 0 and zero V rows, so the loop may round up to 4
    const int jmax = min(kBlockK, len - k0);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int g = head(r);
      if (g < qpk) acc[r] *= a_s[g];
    }
    if constexpr (kSplit) {
      // every accumulator of a thread is the same column: read V once per key
      const int col = tid % D;
      for (int j = 0; j < jmax; j += 4) {
        const float v0 = vs[j * D + col], v1 = vs[(j + 1) * D + col];
        const float v2 = vs[(j + 2) * D + col], v3 = vs[(j + 3) * D + col];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int g = head(r);
          if (g < qpk) {
            const float4 p = *reinterpret_cast<const float4*>(ps + g * kBlockK + j);
            acc[r] += p.x * v0 + p.y * v1 + p.z * v2 + p.w * v3;
          }
        }
      }
    } else {
      for (int j = 0; j < jmax; j += 4) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int g = head(r), col = column(r);
          if (g < qpk) {
            const float4 p = *reinterpret_cast<const float4*>(ps + g * kBlockK + j);
            acc[r] += p.x * vs[j * D + col] + p.y * vs[(j + 1) * D + col] +
                      p.z * vs[(j + 2) * D + col] + p.w * vs[(j + 3) * D + col];
          }
        }
      }
    }
  }
  __syncthreads();  // l_s is final (also when len == 0 skipped the loop)

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int g = head(r);
    if (g < qpk) {
      const float l = fmaxf(l_s[g], 1e-30f);
      store(out + b * o_sb + h * o_sh + g * o_sg + column(r), acc[r] / l);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* out,
           int B, int Hkv, int qpk, int S, const long long* st, cudaStream_t stream) {
  auto kernel = decode_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem_bytes<D>());
  if (err != cudaSuccess) return err;
  const dim3 grid(Hkv, B);
  kernel<<<grid, kThreads, smem_bytes<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      static_cast<T*>(out), qpk, S, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], 1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, const int* lengths, void* out,
             int B, int Hkv, int qpk, int S, const long long* st, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, lengths, out, B, Hkv, qpk, S, st, stream);
    case 64: return launch<T, 64>(q, k, v, lengths, out, B, Hkv, qpk, S, st, stream);
    case 80: return launch<T, 80>(q, k, v, lengths, out, B, Hkv, qpk, S, st, stream);
    case 128: return launch<T, 128>(q, k, v, lengths, out, B, Hkv, qpk, S, st, stream);
    default: return kUnsupported;
  }
}

}  // namespace
}  // namespace ham

// q (B, Hkv, qpk, d), k/v (B, Hkv, S, d), out (B, Hkv, qpk, d): element
// strides of the three outer dims (the last dim is contiguous); lengths (B,)
// int32 on the device.  Returns 0 or the launch error.
extern "C" int ham_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths, void* out,
    int B, int Hkv, int qpk, int S, int d, int dtype,
    long long q_sb, long long q_sh, long long q_sg,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_sg,
    int device, void* stream) {
  if (qpk < 1 || qpk > ham::kMaxQpk) return ham::kUnsupported;
  if (B == 0 || Hkv == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long st[12] = {q_sb, q_sh, q_sg, k_sb, k_sh, k_ss,
                            v_sb, v_sh, v_ss, o_sb, o_sh, o_sg};
  const int* len = static_cast<const int*>(lengths);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ham::kF32: return ham::dispatch<float>(d, q, k, v, len, out, B, Hkv, qpk, S, st, s);
    case ham::kBF16:
      return ham::dispatch<__nv_bfloat16>(d, q, k, v, len, out, B, Hkv, qpk, S, st, s);
    default: return ham::kUnsupported;
  }
}
