// Flash attention (tiled online softmax, GQA, causal or not, forward only)
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (_flash_kernel): query head h of sequence b attends over kv head
// h / (H / Hkv) (the Pallas kernel's bh // q_per_kv), with keys j <= i
// when causal, and with a sliding window (window > 0, causal only) keys
// i - window < j <= i: the reference model's causal_mask
// (repro/models/layers.py:211-219), which the Pallas kernel lacks.
//
// Bound on an H100: operations (a causal prefill of S=1024 over 48 heads of
// d=128 does ~12.9 GFLOP on ~29 MB: 13 us at the bf16 tensor-core peak, 9 us
// of bytes).  bf16, the serving path, is FlashAttention-2 on the tensor
// cores:
//  * one block per (b*H + h, query tile), 16 query rows a warp: 8 warps and
//    128 rows at d >= 80, 4 warps and 64 rows below (8 would spill there);
//    the q tile comes to shared memory once and into registers as mma A
//    fragments (ldmatrix), where it stays for the whole key loop;
//  * 64-key K and V tiles stay bf16 and arrive by cp.async in a 3-stage
//    ring, the next two tiles loading while the current one is multiplied;
//    rows are padded by 8 bf16 (16 bytes), so ldmatrix is free of bank
//    conflicts; 139 KB at d = 128 (one block of 8 warps an SM), 90 KB at
//    d = 80 (two);
//  * S = Q K^T and O += P V run as mma.sync m16n8k16 (bf16 in, float32
//    accumulators); P goes from the S accumulators straight into A
//    fragments (two n8 tiles make one k16 fragment) and never touches shared
//    memory; V comes in through ldmatrix.trans;
//  * the online softmax runs on the accumulator fragments in the log2
//    domain (exp2f, 1/sqrt(d) * log2 e folded into the scores), row max and
//    sum reduced across each quad of lanes; masks apply only on the diagonal
//    tile and the ragged tail, with the finite kNegInf;
//  * the key loop stops at the causal diagonal, and the query tiles with the
//    most key tiles are scheduled first, across all heads; with a window it
//    starts at the key tile holding q0 - window + 1 (q0 the tile's first
//    row), so the tiles left of the window are never loaded, and a warp
//    skips a tile whose keys all lie left of its rows' windows; the
//    window's edge is masked inside its first tiles;
//  * q/k/v/o go through (b, h, s) strides, so the model's (B, S, H, d)
//    activations are read and written in place; o is staged through shared
//    memory and stored in 16-byte vectors.
// float32 runs a CUDA-core kernel (64 x 64 float32 tiles in shared memory,
// 4 x 4 outputs a thread): the tensor cores take float32 only as TF32,
// which misses the float32 tolerance.  wgmma, TMA and
// warp specialisation are the next levers for bf16.
#include <type_traits>

#include "common.cuh"

namespace ham {
namespace {

// float32 kernel
constexpr int kThreads = 256;  // 16 x 16
constexpr int kBQ = 64;        // queries per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kPad = 4;        // row padding (floats): conflict-free float4 rows
constexpr int kChunk = 4;      // 16-byte loads in flight per thread and tensor

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
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

// W: a sliding window (window > 0).  A template flag: tested at run time,
// the window cost every causal call instructions and registers (6-13% at
// the served shapes)
template <typename T, int D, bool W>
__global__ void __launch_bounds__(kThreads)
flash_kernel_f32(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int H, int Hkv, int S, int Skv, int causal, int window,
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
  const int k_begin = W ? max(0, q0 - window + 1) / kBK * kBK : 0;
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
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
        if (kj >= Skv || (causal && kj > qi) || (W && kj <= qi - window))
          s[r][c] = kNegInf;
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

// bf16 kernel: 16 query rows a warp; 8 warps a block at d >= 80 (a K/V tile
// read from L2 serves 128 rows), 4 below (where 8 would spill)
constexpr int kKeys = 64;    // keys per K/V tile
constexpr int kStages = 3;   // cp.async ring depth

template <int D>
__host__ __device__ constexpr int warps16() { return D >= 80 ? 8 : 4; }
template <int D>
__host__ __device__ constexpr size_t smem16() {
  return sizeof(__nv_bfloat16) * (D + 8) * (16 * warps16<D>() + 2 * kKeys * kStages);
}

// at d = 80 two blocks share an SM (90 KB of shared memory each) if a
// thread keeps to 128 registers, which the windowed build exceeds unasked
template <int D, bool W>
__host__ __device__ constexpr int min_blocks16() { return W && D == 80 ? 2 : 1; }

template <int D, bool W>
__global__ void __launch_bounds__(32 * warps16<D>(), min_blocks16<D, W>())
flash_kernel_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int H,
                  int Hkv, int S, int Skv, int causal, int window,
                  int64_t q_sb, int64_t q_sh, int64_t q_ss,
                  int64_t k_sb, int64_t k_sh, int64_t k_ss,
                  int64_t v_sb, int64_t v_sh, int64_t v_ss,
                  int64_t o_sb, int64_t o_sh, int64_t o_ss, float scale_log2) {
  using T = __nv_bfloat16;
  constexpr int RS = D + 8;               // tile row (bf16): 16 bytes of padding
  constexpr int NTH = 32 * warps16<D>();  // threads a block
  constexpr int RQ = 16 * warps16<D>();   // query rows a block
  constexpr int CH = D / 8;               // 16-byte vectors a row
  constexpr int KD = D / 16;              // k16 steps over d
  constexpr int NT = kKeys / 8;           // n8 score tiles a warp
  static_assert(D % 16 == 0, "head_dim");

  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);  // [RQ][RS]; each warp's rows hold its o at the end
  T* ks = qs + RQ * RS;                 // [kStages][kKeys][RS]
  T* vs = ks + kStages * kKeys * RS;    // [kStages][kKeys][RS]

  const int iq = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // heaviest first
  const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int q0 = iq * RQ;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;

  // rows [row0, row0 + rows) of src -> dst[rows][RS] by cp.async; rows at
  // or past `valid` are zero-filled and read nothing
  const auto load_rows = [tid](T* dst, const T* src, int64_t s_stride, int row0, int rows,
                               int valid) {
    for (int idx = tid; idx < rows * CH; idx += NTH) {
      const int r = idx / CH, c = (idx % CH) * 8;
      const bool ok = row0 + r < valid;
      cp_async16(dst + r * RS + c, ok ? src + (row0 + r) * s_stride + c : src, ok ? 16 : 0);
    }
  };

  const int q_last = min(q0 + RQ, S) - 1;
  const int k_end = causal ? min(Skv, q_last + 1) : Skv;
  // with a window, the first key tile holds the first row's oldest key
  const int k_begin = W ? max(0, q0 - window + 1) / kKeys * kKeys : 0;
  const int nk = (k_end - k_begin + kKeys - 1) / kKeys;

  load_rows(qs, qb, q_ss, q0, RQ, S);  // in the first group, with key tile 0
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) {
      load_rows(ks + st * kKeys * RS, kb, k_ss, k_begin + st * kKeys, kKeys, Skv);
      load_rows(vs + st * kKeys * RS, vb, v_ss, k_begin + st * kKeys, kKeys, Skv);
    }
    cp_async_commit();
  }

  const int wq = q0 + 16 * warp;  // this warp's first query row
  const int r0 = wq + lane / 4;   // row of accumulator elements 0, 1 (2, 3: r0 + 8)
  T* qw = qs + 16 * warp * RS;    // this warp's rows of qs
  unsigned qf[KD][4];
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};

  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kStages - 2>();  // tile t (and q) have landed ...
    __syncthreads();               // ... for every thread, and tile t - 1 is consumed
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldmatrix_x4(qf[kk], qw + (lane & 15) * RS + kk * 16 + (lane >> 4) * 8);
    }
    const int pf = t + kStages - 1;
    if (pf < nk) {
      load_rows(ks + (pf % kStages) * kKeys * RS, kb, k_ss, k_begin + pf * kKeys, kKeys, Skv);
      load_rows(vs + (pf % kStages) * kKeys * RS, vb, v_ss, k_begin + pf * kKeys, kKeys, Skv);
    }
    cp_async_commit();
    const T* kt = ks + (t % kStages) * kKeys * RS;
    const T* vt = vs + (t % kStages) * kKeys * RS;
    const int k0 = k_begin + t * kKeys;
    if (causal && k0 > wq + 15) continue;  // warp-uniform: every key is past its rows
    if (W && k0 + kKeys - 1 <= wq - window) continue;  // ... or left of their windows

    // S = Q K^T: 16 rows x 64 keys a warp; kf = {b0, b1} of key tiles 2 np, 2 np + 1
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned kf[4];
        ldmatrix_x4(kf, kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * RS + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }

    // element (j, e): key k0 + 8 j + 2 (lane % 4) + e % 2, row r0 + 8 (e / 2)
    const bool masked = k0 + kKeys > Skv || (causal && k0 + kKeys - 1 > wq) ||
                        (W && k0 <= wq + 15 - window);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= scale_log2;
        if (masked) {
          const int key = k0 + 8 * j + 2 * (lane % 4) + (e & 1), row = r0 + 8 * (e >> 1);
          if (key >= Skv || (causal && key > row) || (W && key <= row - window))
            s[j][e] = kNegInf;
        }
      }

    // online softmax of rows r0 (hh = 0) and r0 + 8 (hh = 1) across the quad
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[hh], mx);
      const float m_use = m_new == kNegInf ? 0.f : m_new;  // a row masked so far: p = 0
      const float alpha = exp2f(m_i[hh] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
          s[j][e] = exp2f(s[j][e] - m_use);
          sum += s[j][e];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_i[hh] = alpha * l_i[hh] + sum;
      m_i[hh] = m_new;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][2 * hh] *= alpha;
        acc[j][2 * hh + 1] *= alpha;
      }
    }

    // O += P V: score tiles 2 kk, 2 kk + 1 are the A fragment of keys 16 kk ..
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const unsigned a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        unsigned vf[4];
        ldmatrix_x4_trans(vf, vt + (kk * 16 + (lane & 15)) * RS + dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], a, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], a, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();

  // o = acc / l into this warp's own rows of qs (only it read them), then
  // 16-byte stores of the rows inside S
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float l = fmaxf(l_i[hh], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<unsigned*>(qw + (lane / 4 + 8 * hh) * RS + 8 * j + 2 * (lane % 4)) =
          pack_bf16(acc[j][2 * hh] / l, acc[j][2 * hh + 1] / l);
  }
  __syncwarp();
  T* ob = o + b * o_sb + h * o_sh;
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = idx / CH, c = (idx % CH) * 8;
    if (wq + r < S)
      *reinterpret_cast<uint4*>(ob + (wq + r) * o_ss + c) =
          *reinterpret_cast<const uint4*>(qw + r * RS + c);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv, int S,
           int Skv, int causal, int window, const long long* st, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  if constexpr (std::is_same_v<T, float>) {
    auto kernel = window > 0 ? flash_kernel_f32<T, D, true> : flash_kernel_f32<T, D, false>;
    cudaError_t err = allow_smem(kernel, smem_bytes<D>());
    if (err != cudaSuccess) return err;
    const dim3 grid((S + kBQ - 1) / kBQ, B * H);
    kernel<<<grid, kThreads, smem_bytes<D>(), stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), H, Hkv, S, Skv, causal, window, st[0], st[1], st[2], st[3], st[4],
        st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale);
  } else {
    auto kernel = window > 0 ? flash_kernel_bf16<D, true> : flash_kernel_bf16<D, false>;
    cudaError_t err = allow_smem(kernel, smem16<D>());
    if (err != cudaSuccess) return err;
    const int rows = 16 * warps16<D>();
    const dim3 grid(B * H, (S + rows - 1) / rows);  // every head's heaviest tile first
    kernel<<<grid, 32 * warps16<D>(), smem16<D>(), stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), H, Hkv, S, Skv, causal, window, st[0], st[1], st[2], st[3], st[4],
        st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale * 1.4426950408889634f);
  }
  return cudaGetLastError();
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv,
             int S, int Skv, int causal, int window, const long long* st, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, B, H, Hkv, S, Skv, causal, window, st, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, Hkv, S, Skv, causal, window, st, stream);
    case 80: return launch<T, 80>(q, k, v, o, B, H, Hkv, S, Skv, causal, window, st, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, Hkv, S, Skv, causal, window, st, stream);
    default: return kUnsupported;
  }
}

}  // namespace
}  // namespace ham

// q/o (B, H, S, d), k/v (B, Hkv, Skv, d): element strides of the three outer
// dims (the last dim is contiguous); window 0 means none and applies only
// when causal.  Returns 0 or the launch error.
extern "C" int ham_flash_attention(
    const void* q, const void* k, const void* v, void* o,
    int B, int H, int Hkv, int S, int Skv, int d, int causal, int window, int dtype,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int device, void* stream) {
  if (Hkv < 1 || H % Hkv || window < 0) return ham::kUnsupported;
  if (!causal) window = 0;
  if (B == 0 || H == 0 || S == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                            v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ham::kF32:
      return ham::dispatch<float>(d, q, k, v, o, B, H, Hkv, S, Skv, causal, window, st, s);
    case ham::kBF16:
      return ham::dispatch<__nv_bfloat16>(d, q, k, v, o, B, H, Hkv, S, Skv, causal, window,
                                          st, s);
    default: return ham::kUnsupported;
  }
}
