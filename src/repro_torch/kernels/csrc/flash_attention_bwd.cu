// Flash attention backward (GQA, causal or not, causal sliding window) for
// Hopper (sm_90a): the gradient of csrc/flash_attention.cu's forward.
//
// The Pallas TPU kernel repro/kernels/flash_attention.py (_flash_kernel) has
// no backward: the reference trains through XLA's autodiff of its plain
// attention.  In the port the forward kernel is the model's attention on the
// card, so training there needs this kernel.  It computes, for every query
// head h over kv head hk = h / (H / Hkv), with s = scale q k^T masked as the
// forward masks it, p = exp(s - lse) and D_i = sum_c dO_ic O_ic:
//   dV = sum_h p^T dO,   dS = p (dO V^T - D),   dK = scale sum_h dS^T Q,
//   dQ = scale dS K.
//
// FlashAttention-2's backward, on the CUDA cores in float32 (both dtypes
// convert tiles to float32 in shared memory and round each gradient once),
// in two launches and no atomics:
//  * dq kernel, one block per (b*H + h, 64-query tile): recomputes the row
//    log-sum-exp in its own pass over the key tiles (online max and sum, as
//    the forward), so the forward kernel and its serving times stay as they
//    are; D = rowsum(dO o O); stores both for the second kernel; then a
//    second pass over the same key tiles recomputes p and dS and
//    accumulates dQ in registers (4 rows x d/16 columns a thread);
//  * dk/dv kernel, one block per (b*Hkv + hk, 64-key tile): K and V stay in
//    shared memory while the block walks the q heads of its kv group and
//    their 32-query tiles (from the causal diagonal on, up to the window's
//    far edge), recomputing p and dS per tile; dK and dV accumulate in
//    registers (4 keys x d/16 columns a thread each) and are written once.
// dQ comes from its own pass per query tile, not from float32 atomics
// across the key-tile blocks: that costs two more d-deep products per
// (query, key) pair, but the order of every sum is fixed, so a step's
// gradients repeat bit for bit from run to run (a restarted trainer
// reproduces the uninterrupted run's losses; atomics would reorder the dQ
// sums on every call).
// Bound on an H100: operations.  The function needs five d-deep products
// per (query, key) pair, 2.5x the forward's two, plus the LSE pass (one
// more); this kernel does eight (the dQ pass recomputes q k^T and dO V^T).
// mma.sync or wgmma tiles and the LSE saved by the forward are the levers
// of later work.
#include "common.cuh"

namespace ham {
namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kPad = 4;        // row padding (floats): conflict-free float4 rows
constexpr int kKeys = 64;      // keys a tile
constexpr int kQ = 64;         // queries a dq-kernel tile
constexpr int kMQ = 32;        // queries a dk/dv-kernel tile

// rows [row0, row0 + ROWS) of src -> dst[ROWS][stride] as float; rows at
// or past `valid` are zero
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, int stride, const T* src, int64_t s_stride,
                                          int row0, int valid, int tid) {
  constexpr int VN = Vec<T>::N, VPR = D / VN;
  for (int idx = tid; idx < ROWS * VPR; idx += kThreads) {
    const int row = idx / VPR, c = (idx % VPR) * VN;
    float f[VN];
    if (row0 + row < valid) {
      Vec<T>::to_float(load16(src + (row0 + row) * s_stride + c), f);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) dst[row * stride + c + e] = f[e];
  }
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ bool masked(int key, int row, int Skv, int causal, int window) {
  return key >= Skv || (causal && key > row) || (window > 0 && key <= row - window);
}

struct Strides {
  int64_t q[3], k[3], v[3], o[3], dout[3], dq[3], dk[3], dv[3];
};

template <int D>
__host__ __device__ constexpr size_t dq_smem() {
  return sizeof(float) * (2 * (kQ + kKeys) * (D + kPad) + kQ * (kKeys + kPad) + 2 * kQ);
}

// lse[bh, i] (natural log of the scaled scores' row sum), delta[bh, i] and
// dq, for one (b, h) and 64 query rows
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
       const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ lse,
       float* __restrict__ delta, T* __restrict__ dq, int H, int Hkv, int S, int Skv,
       int causal, int window, Strides st, float scale) {
  constexpr int QS = D + kPad;      // row stride of the d-wide tiles
  constexpr int PS = kKeys + kPad;  // row stride of dS
  constexpr int CD = D / 16;        // columns a thread owns
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kQ][QS]
  float* dos = qs + kQ * QS;                    // [kQ][QS] dO
  float* ks = dos + kQ * QS;                    // [kKeys][QS]
  float* vs = ks + kKeys * QS;                  // [kKeys][QS]
  float* dss = vs + kKeys * QS;                 // [kQ][PS] dS
  float* lse_s = dss + kQ * PS;                 // [kQ]
  float* del_s = lse_s + kQ;                    // [kQ]

  const int iq = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // heaviest first
  const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int q0 = iq * kQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* kb = k + b * st.k[0] + hk * st.k[1];
  const T* vb = v + b * st.v[0] + hk * st.v[1];
  load_rows<T, D, kQ>(qs, QS, q + b * st.q[0] + h * st.q[1], st.q[2], q0, S, tid);
  load_rows<T, D, kQ>(dos, QS, dout + b * st.dout[0] + h * st.dout[1], st.dout[2], q0, S, tid);

  const int q_last = min(q0 + kQ, S) - 1;
  const int k_end = causal ? min(Skv, q_last + 1) : Skv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kKeys * kKeys : 0;

  // s[r][c] = scale q[ty + 16 r] . k[tx + 16 c] over the tile in ks
  const auto scores = [&](float (&s)[4][4]) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 2
    for (int i = 0; i < D; i += 4) {
      float4 qa[4], kk[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qa[r] = *reinterpret_cast<const float4*>(qs + (ty + 16 * r) * QS + i);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kk[c] = *reinterpret_cast<const float4*>(ks + (tx + 16 * c) * QS + i);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s[r][c] += qa[r].x * kk[c].x + qa[r].y * kk[c].y + qa[r].z * kk[c].z + qa[r].w * kk[c].w;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] *= scale;
  };

  // pass 1: the row log-sum-exp (online max and sum over the key tiles; a
  // row masked so far sums exp(0) of masked scores, which the first valid
  // key's rescale, exp(kNegInf - max) = 0, erases)
  float m_i[4], l_i[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_i[r] = kNegInf;
    l_i[r] = 0.f;
  }
  for (int k0 = k_begin; k0 < k_end; k0 += kKeys) {
    __syncthreads();  // the previous tile is consumed; q is written
    load_rows<T, D, kKeys>(ks, QS, kb, st.k[2], k0, Skv, tid);
    __syncthreads();
    float s[4][4];
    scores(s);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + ty + 16 * r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (masked(k0 + tx + 16 * c, qi, Skv, causal, window)) s[r][c] = kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) sum += expf(s[r][c] - m_new);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_i[r] = expf(m_i[r] - m_new) * l_i[r] + sum;
      m_i[r] = m_new;
    }
  }

  // lse and D = rowsum(dO o O), each row over its 16 threads
  __syncthreads();  // dO is in shared memory even where pass 1 had no key tile
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty + 16 * r, qi = q0 + row;
    const T* orow = o + b * st.o[0] + h * st.o[1] + (qi < S ? qi : 0) * st.o[2];
    float dsum = 0.f;
    if (qi < S) {
#pragma unroll
      for (int c = 0; c < CD; ++c) dsum += to_f(orow[tx + 16 * c]) * dos[row * QS + tx + 16 * c];
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
    if (tx == 0) {
      const float l = m_i[r] + logf(fmaxf(l_i[r], 1e-30f));
      lse_s[row] = l;
      del_s[row] = dsum;
      if (qi < S) {
        lse[bh * S + qi] = l;
        delta[bh * S + qi] = dsum;
      }
    }
  }

  // pass 2: dS over the same key tiles, dQ += dS k (scaled at the end)
  float acc[4][CD];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[r][c] = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += kKeys) {
    __syncthreads();  // the previous tile is consumed; lse and D are written
    load_rows<T, D, kKeys>(ks, QS, kb, st.k[2], k0, Skv, tid);
    load_rows<T, D, kKeys>(vs, QS, vb, st.v[2], k0, Skv, tid);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores(s);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) dp[r][c] = 0.f;
#pragma unroll 2
    for (int i = 0; i < D; i += 4) {
      float4 da[4], vv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        da[r] = *reinterpret_cast<const float4*>(dos + (ty + 16 * r) * QS + i);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        vv[c] = *reinterpret_cast<const float4*>(vs + (tx + 16 * c) * QS + i);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          dp[r][c] += da[r].x * vv[c].x + da[r].y * vv[c].y + da[r].z * vv[c].z + da[r].w * vv[c].w;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty + 16 * r, qi = q0 + row;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = tx + 16 * c;
        const bool off = qi >= S || masked(k0 + key, qi, Skv, causal, window);
        const float p = off ? 0.f : expf(s[r][c] - lse_s[row]);
        dss[row * PS + key] = p * (dp[r][c] - del_s[row]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      float d4[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) d4[r] = dss[(ty + 16 * r) * PS + j];
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const float kv = ks[j * QS + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] += d4[r] * kv;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty + 16 * r;
    if (qi < S) {
      T* dqr = dq + b * st.dq[0] + h * st.dq[1] + qi * st.dq[2];
#pragma unroll
      for (int c = 0; c < CD; ++c) store(dqr + tx + 16 * c, acc[r][c] * scale);
    }
  }
}

template <int D>
__host__ __device__ constexpr size_t dkdv_smem() {
  return sizeof(float) * (2 * kKeys * (D + kPad) + 2 * kMQ * (D + kPad) +
                          2 * kMQ * (kKeys + kPad) + 2 * kMQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const T* __restrict__ dout, const float* __restrict__ lse,
         const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int H,
         int Hkv, int S, int Skv, int causal, int window, Strides st, float scale) {
  constexpr int QS = D + kPad;     // row stride of the d-wide tiles
  constexpr int PS = kKeys + kPad; // row stride of p and dS
  constexpr int CD = D / 16;       // columns a thread owns
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kKeys][QS]
  float* vs = ks + kKeys * QS;                  // [kKeys][QS]
  float* qs = vs + kKeys * QS;                  // [kMQ][QS]
  float* ds_o = qs + kMQ * QS;                  // [kMQ][QS] dO
  float* ps = ds_o + kMQ * QS;                  // [kMQ][PS] p
  float* dss = ps + kMQ * PS;                   // [kMQ][PS] dS
  float* lse_s = dss + kMQ * PS;                // [kMQ]
  float* del_s = lse_s + kMQ;                   // [kMQ]

  const int kt = blockIdx.y;  // key tile 0 holds the most causal work: it runs first
  const int bkv = blockIdx.x, b = bkv / Hkv, hk = bkv % Hkv, qpk = H / Hkv;
  const int k0 = kt * kKeys;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  load_rows<T, D, kKeys>(ks, QS, k + b * st.k[0] + hk * st.k[1], st.k[2], k0, Skv, tid);
  load_rows<T, D, kKeys>(vs, QS, v + b * st.v[0] + hk * st.v[1], st.v[2], k0, Skv, tid);

  // queries that see a key of this tile: i >= k0 when causal, and
  // i < k0 + kKeys - 1 + window with a window
  const int q_begin = causal ? k0 / kMQ * kMQ : 0;
  const int q_end = window > 0 ? min(S, k0 + kKeys - 1 + window) : S;

  float dka[4][CD], dva[4][CD];  // keys ty + 16 r, columns tx + 16 c
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CD; ++c) dka[r][c] = dva[r][c] = 0.f;

  for (int g = 0; g < qpk; ++g) {
    const int h = hk * qpk + g, bh = b * H + h;
    const T* qb = q + b * st.q[0] + h * st.q[1];
    const T* db = dout + b * st.dout[0] + h * st.dout[1];
    for (int q0 = q_begin; q0 < q_end; q0 += kMQ) {
      __syncthreads();  // the previous tile is consumed (and K, V are written)
      load_rows<T, D, kMQ>(qs, QS, qb, st.q[2], q0, S, tid);
      load_rows<T, D, kMQ>(ds_o, QS, db, st.dout[2], q0, S, tid);
      if (tid < kMQ) {
        const bool ok = q0 + tid < S;
        lse_s[tid] = ok ? lse[bh * S + q0 + tid] : 0.f;
        del_s[tid] = ok ? delta[bh * S + q0 + tid] : 0.f;
      }
      __syncthreads();

      // s = scale q k^T and dp = dO v^T: rows ty + 16 r, keys tx + 16 c
      float s[2][4], dp[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 2
      for (int i = 0; i < D; i += 4) {
        float4 qa[2], da[2], kk[4], vv[4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          qa[r] = *reinterpret_cast<const float4*>(qs + (ty + 16 * r) * QS + i);
          da[r] = *reinterpret_cast<const float4*>(ds_o + (ty + 16 * r) * QS + i);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          kk[c] = *reinterpret_cast<const float4*>(ks + (tx + 16 * c) * QS + i);
          vv[c] = *reinterpret_cast<const float4*>(vs + (tx + 16 * c) * QS + i);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[r][c] += qa[r].x * kk[c].x + qa[r].y * kk[c].y + qa[r].z * kk[c].z +
                       qa[r].w * kk[c].w;
            dp[r][c] += da[r].x * vv[c].x + da[r].y * vv[c].y + da[r].z * vv[c].z +
                        da[r].w * vv[c].w;
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = ty + 16 * r, qi = q0 + row;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = tx + 16 * c;
          const bool off = qi >= S || masked(k0 + key, qi, Skv, causal, window);
          const float p = off ? 0.f : expf(s[r][c] * scale - lse_s[row]);
          ps[row * PS + key] = p;
          dss[row * PS + key] = p * (dp[r][c] - del_s[row]);
        }
      }
      __syncthreads();

      // dV += p^T dO, dK += dS^T q (scaled at the end): keys ty + 16 r
#pragma unroll 4
      for (int i = 0; i < kMQ; ++i) {
        float pk[4], dk4[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pk[r] = ps[i * PS + ty + 16 * r];
          dk4[r] = dss[i * PS + ty + 16 * r];
        }
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          const float dov = ds_o[i * QS + tx + 16 * c], qv = qs[i * QS + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            dva[r][c] += pk[r] * dov;
            dka[r][c] += dk4[r] * qv;
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k0 + ty + 16 * r;
    if (key < Skv) {
      T* dkr = dk + b * st.dk[0] + hk * st.dk[1] + key * st.dk[2];
      T* dvr = dv + b * st.dv[0] + hk * st.dv[1] + key * st.dv[2];
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        store(dkr + tx + 16 * c, dka[r][c] * scale);
        store(dvr + tx + 16 * c, dva[r][c]);
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           void* dq, void* dk, void* dv, float* lse, float* delta, int B, int H, int Hkv, int S,
           int Skv, int causal, int window, const Strides& st, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  auto kq = bwd_dq<T, D>;
  cudaError_t err = allow_smem(kq, dq_smem<D>());
  if (err != cudaSuccess) return err;
  kq<<<dim3(B * H, (S + kQ - 1) / kQ), kThreads, dq_smem<D>(), stream>>>(
      qp, kp, vp, static_cast<const T*>(o), dop, lse, delta, static_cast<T*>(dq), H, Hkv, S,
      Skv, causal, window, st, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kkv = bwd_dkdv<T, D>;
  err = allow_smem(kkv, dkdv_smem<D>());
  if (err != cudaSuccess) return err;
  kkv<<<dim3(B * Hkv, (Skv + kKeys - 1) / kKeys), kThreads, dkdv_smem<D>(), stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, Hkv, S, Skv,
      causal, window, st, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, const void* o,
             const void* dout, void* dq, void* dk, void* dv, float* lse, float* delta, int B,
             int H, int Hkv, int S, int Skv, int causal, int window, const Strides& st,
             cudaStream_t s) {
#define HAM_BWD_CASE(D)                                                                        \
  case D:                                                                                      \
    return launch<T, D>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, H, Hkv, S, Skv, causal, \
                        window, st, s);
  switch (d) {
    HAM_BWD_CASE(32)
    HAM_BWD_CASE(64)
    HAM_BWD_CASE(80)
    HAM_BWD_CASE(128)
    HAM_BWD_CASE(192)
    default: return kUnsupported;
  }
#undef HAM_BWD_CASE
}

}  // namespace
}  // namespace ham

// q/o/dout/dq (B, H, S, d), k/v/dk/dv (B, Hkv, Skv, d): element strides of
// the three outer dims (the last dim is contiguous), in the order q, k, v,
// o, dout, dq, dk, dv.  lse and delta (B*H*S) are float32 scratch, written
// by the first kernel and read by the second.  window 0 means none and
// applies only when causal.  Returns 0 or the launch error.
extern "C" int ham_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq,
    void* dk, void* dv, void* lse, void* delta, int B, int H, int Hkv, int S, int Skv, int d,
    int causal, int window, int dtype, const long long* strides, int device, void* stream) {
  if (Hkv < 1 || H % Hkv || window < 0 || Skv < 1) return ham::kUnsupported;
  if (!causal) window = 0;
  if (B == 0 || H == 0 || S == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  ham::Strides st;
  int64_t* dst[8] = {st.q, st.k, st.v, st.o, st.dout, st.dq, st.dk, st.dv};
  for (int t = 0; t < 8; ++t)
    for (int j = 0; j < 3; ++j) dst[t][j] = strides[3 * t + j];
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  auto* dl = static_cast<float*>(delta);
  switch (dtype) {
    case ham::kF32:
      return ham::dispatch<float>(d, q, k, v, o, dout, dq, dk, dv, l, dl, B, H, Hkv, S, Skv,
                                  causal, window, st, s);
    case ham::kBF16:
      return ham::dispatch<__nv_bfloat16>(d, q, k, v, o, dout, dq, dk, dv, l, dl, B, H, Hkv, S,
                                          Skv, causal, window, st, s);
    default: return ham::kUnsupported;
  }
}
