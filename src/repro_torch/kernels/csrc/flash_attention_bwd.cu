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
// FlashAttention-2's backward in three launches, no atomics:
//  1 bwd_delta   D = rowsum(dO o O) in float32, 8 lanes a row;
//  2 dK/dV       a block per (b*Hkv + hk, 64-key tile): K and V stay in
//                shared memory while the block walks the q heads of its kv
//                group and their query tiles from the causal diagonal (or
//                0) to the window's far edge (or S), recomputing p and dS;
//                dK and dV accumulate in registers and are written once;
//  3 dQ          a block per (b*H + h, query tile): the forward's shape,
//                over the key tiles from the window's near edge (or 0) to
//                the causal diagonal (or Skv), recomputing p and dS.
// p = exp(s - lse) reads the row log-sum-exp that the forward saved
// (csrc/flash_attention.cu writes it when asked), so no launch recomputes
// it.  dQ comes from its own pass per query tile, not from float32 atomics
// across the key-tile blocks: that costs two more d-deep products per
// (query, key) pair (S and dP again, seven in all), but the order of every
// sum is fixed, so a step's gradients repeat bit for bit from run to run (a
// restarted trainer reproduces the uninterrupted run's losses).
//
// bf16, the training route: every product is mma.sync m16n8k16 with bf16
// operands and float32 accumulators.  In the dK/dV kernel the keys are the
// rows of each warp's tiles (16 keys a warp, 4 warps): S^T = K Q^T and dP^T
// = V dO^T, with K and V read by ldmatrix from shared memory each k16 step
// and Q, dO, lse and D streaming through a 3-stage cp.async ring (64, 32
// and 16 queries a stage at d <= 64, <= 128 and 192, so that the score
// tiles fit beside the dK and dV accumulators); P^T and dS^T = P^T o (dP^T -
// D) go from the accumulators straight into A fragments (the forward's
// trick) for dV += P^T dO and dK += dS^T Q, with dO and Q through
// ldmatrix.trans.  In the dQ kernel (16 query rows a warp, 8 warps at d >=
// 80, 4 below; q and dO rows in shared memory, 64-key K/V tiles in a
// 2-stage ring) S = Q K^T and dP = dO V^T, and dS goes into A fragments for
// dQ += dS K, K through ldmatrix.trans.  P and dS are rounded to bf16 as
// mma operands, as FlashAttention-2 does.  No score tile touches shared
// memory.  Masks (causal, window, ragged lengths) apply only on the tiles
// that cross them; a warp skips a tile wholly outside them.
// float32 runs the CUDA-core kernels of the first port (64-wide float32
// tiles in shared memory): the tensor cores take float32 only as TF32,
// which misses the float32 gradient tolerance.
// Bound on an H100: operations.  Given the LSE, the function needs five
// 2d-deep products per (query, key) pair (10 d flops); these kernels do
// seven.  wgmma, TMA and warp specialisation are later work.
#include <type_traits>

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

// dq for one (b, h) and 64 query rows, from the forward's lse and D
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
       const T* __restrict__ dout, const float* __restrict__ lse,
       const float* __restrict__ delta, T* __restrict__ dq, int H, int Hkv, int S, int Skv,
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
  if (tid < kQ) {
    const bool ok = q0 + tid < S;
    lse_s[tid] = ok ? lse[static_cast<int64_t>(bh) * S + q0 + tid] : 0.f;
    del_s[tid] = ok ? delta[static_cast<int64_t>(bh) * S + q0 + tid] : 0.f;
  }

  const int q_last = min(q0 + kQ, S) - 1;
  const int k_end = causal ? min(Skv, q_last + 1) : Skv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kKeys * kKeys : 0;

  // dS over the key tiles, dQ += dS k (scaled at the end)
  float acc[4][CD];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[r][c] = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += kKeys) {
    __syncthreads();  // the previous tile is consumed; q, dO, lse and D are written
    load_rows<T, D, kKeys>(ks, QS, kb, st.k[2], k0, Skv, tid);
    load_rows<T, D, kKeys>(vs, QS, vb, st.v[2], k0, Skv, tid);
    __syncthreads();
    // s = scale q k^T and dp = dO v^T: rows ty + 16 r, keys tx + 16 c
    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 2
    for (int i = 0; i < D; i += 4) {
      float4 qa[4], da[4], kk[4], vv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qa[r] = *reinterpret_cast<const float4*>(qs + (ty + 16 * r) * QS + i);
        da[r] = *reinterpret_cast<const float4*>(dos + (ty + 16 * r) * QS + i);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kk[c] = *reinterpret_cast<const float4*>(ks + (tx + 16 * c) * QS + i);
        vv[c] = *reinterpret_cast<const float4*>(vs + (tx + 16 * c) * QS + i);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] += qa[r].x * kk[c].x + qa[r].y * kk[c].y + qa[r].z * kk[c].z + qa[r].w * kk[c].w;
          dp[r][c] += da[r].x * vv[c].x + da[r].y * vv[c].y + da[r].z * vv[c].z +
                      da[r].w * vv[c].w;
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty + 16 * r, qi = q0 + row;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = tx + 16 * c;
        const bool off = qi >= S || masked(k0 + key, qi, Skv, causal, window);
        const float p = off ? 0.f : expf(s[r][c] * scale - lse_s[row]);
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

// -- D = rowsum(dO o O), both dtypes ------------------------------------------

// 8 lanes a row, 16-byte loads along d, summed across the 8 lanes in a fixed
// order; delta[bh * S + i]
template <typename T, int D>
__global__ void __launch_bounds__(256)
bwd_delta(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta, int H,
          int S, int64_t rows, Strides st) {
  constexpr int VN = Vec<T>::N;
  const int l8 = threadIdx.x % 8;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 32 + threadIdx.x / 8;
  const bool ok = row < rows;
  const int bh = ok ? static_cast<int>(row / S) : 0, i = ok ? static_cast<int>(row % S) : 0;
  const int b = bh / H, h = bh % H;
  const T* orow = o + b * st.o[0] + h * st.o[1] + i * st.o[2];
  const T* drow = dout + b * st.dout[0] + h * st.dout[1] + i * st.dout[2];
  float sum = 0.f;
  for (int c = l8 * VN; ok && c < D; c += 8 * VN) {
    float fo[VN], fd[VN];
    Vec<T>::to_float(load16(orow + c), fo);
    Vec<T>::to_float(load16(drow + c), fd);
#pragma unroll
    for (int e = 0; e < VN; ++e) sum += fo[e] * fd[e];
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 4);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  if (ok && l8 == 0) delta[row] = sum;
}

// -- bf16: mma.sync m16n8k16, bf16 operands, float32 accumulators --------------
// Fragment element (j, e) of an m16n8 accumulator tile j of a warp: row
// lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2 (common.cuh).

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTcWarps = 4;   // dK/dV kernel: 16 keys a warp, 64 a block
constexpr int kTcStages = 3;  // dK/dV kernel: cp.async ring depth

// queries a ring stage of the dK/dV kernel: the warp's S^T and dP^T tiles
// (16 keys x q_step) sit beside its dK and dV accumulators (d / 2 floats a
// thread each), so the step narrows as d grows
template <int D>
__host__ __device__ constexpr int q_step() { return D <= 64 ? 64 : D <= 128 ? 32 : 16; }

template <int D>
__host__ __device__ constexpr size_t dkdv_smem16() {
  return sizeof(__nv_bfloat16) * (D + 8) * (2 * 16 * kTcWarps + 2 * q_step<D>() * kTcStages) +
         sizeof(float) * 2 * q_step<D>() * kTcStages;
}

// dq kernel: 16 query rows a warp, as the forward (8 warps at d >= 80, 4
// below), 64-key K/V tiles in a 2-stage ring
constexpr int kDqKeys = 64;
constexpr int kDqStages = 2;
template <int D>
__host__ __device__ constexpr int dq_warps() { return D >= 80 ? 8 : 4; }
template <int D>
__host__ __device__ constexpr size_t dq_smem16() {
  return sizeof(__nv_bfloat16) * (D + 8) * (2 * 16 * dq_warps<D>() + 2 * kDqKeys * kDqStages);
}

// element (key, row) left out of the softmax: past the keys or the rows,
// above the causal diagonal, or left of the window
__device__ __forceinline__ bool off16(int key, int row, int S, int Skv, int causal, int window) {
  return key >= Skv || row >= S || (causal && key > row) || (window > 0 && key <= row - window);
}

// The dK, dV share of one q head h of sequence b for 64 keys of its kv
// head hk = h / qpk: warp w owns keys k0 + 16 w .. + 15 as the rows of its
// tiles and walks the query steps from the causal diagonal (or 0) to the
// window's far edge (or S):
//   S^T = K Q^T, P^T = exp(S^T scale - lse), dP^T = V dO^T,
//   dS^T = P^T o (dP^T - D), dV += P^T dO, dK += dS^T Q (scaled at the end);
// K and V fragments come from shared memory by ldmatrix each k16 step; Q,
// dO, lse and D stream through a cp.async ring; P^T and dS^T go from the
// accumulators straight into A fragments, rounded to bf16.  A block per q
// head, not per kv group: the causal first key tile sees every query, and a
// block walking all qpk heads of its group on it would set the kernel's
// time.  With qpk 1 the block writes dK and dV; else float32 shares to
// `part` ((b*H + h) rows of Skv x d, dK's then dV's), which bwd_group_sum
// adds over the group in order.
template <int D>
__global__ void __launch_bounds__(32 * kTcWarps)
bwd_dkdv16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
           float* __restrict__ part, int H, int Hkv, int S, int Skv, int causal, int window,
           Strides st, float scale) {
  using T = __nv_bfloat16;
  constexpr int RS = D + 8;          // tile row (bf16): 16 bytes of padding
  constexpr int NTH = 32 * kTcWarps;
  constexpr int QB = q_step<D>();    // queries a ring stage
  constexpr int CH = D / 8;          // 16-byte vectors a row
  constexpr int KD = D / 16;         // k16 steps over d
  constexpr int NQ = QB / 8;         // n8 score tiles a warp
  constexpr int KB = 16 * kTcWarps;  // keys a block
  static_assert(D % 16 == 0, "head_dim");

  extern __shared__ float4 smem4[];
  T* ks = reinterpret_cast<T*>(smem4);  // [KB][RS]
  T* vs = ks + KB * RS;                 // [KB][RS]
  T* qr = vs + KB * RS;                 // [kTcStages][QB][RS]
  T* dr = qr + kTcStages * QB * RS;     // [kTcStages][QB][RS] dO
  float* lr = reinterpret_cast<float*>(dr + kTcStages * QB * RS);  // [kTcStages][QB] lse
  float* del = lr + kTcStages * QB;                                 // [kTcStages][QB] D

  const int bh = blockIdx.x, b = bh / H, h = bh % H, qpk = H / Hkv, hk = h / qpk;
  const int k0 = blockIdx.y * KB;  // key tile 0 holds the most causal work: it runs first
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int kw0 = k0 + 16 * warp;  // this warp's first key

  const auto load_rows = [tid](T* dst, const T* src, int64_t s_stride, int row0, int rows,
                               int valid) {
    for (int idx = tid; idx < rows * CH; idx += NTH) {
      const int r = idx / CH, c = (idx % CH) * 8;
      const bool ok = row0 + r < valid;
      cp_async16(dst + r * RS + c, ok ? src + (row0 + r) * s_stride + c : src, ok ? 16 : 0);
    }
  };
  load_rows(ks, k + b * st.k[0] + hk * st.k[1], st.k[2], k0, KB, Skv);
  load_rows(vs, v + b * st.v[0] + hk * st.v[1], st.v[2], k0, KB, Skv);

  // queries that see a key of this tile: i >= k0 when causal, i < k0 + KB -
  // 1 + window with a window
  const int q_begin = causal ? min(k0, S) / QB * QB : 0;
  const int q_end = window > 0 ? min(S, k0 + KB - 1 + window) : S;
  const int nsteps = q_end > q_begin ? (q_end - q_begin + QB - 1) / QB : 0;

  // ring stage `it`: query rows q_begin + it QB ..
  const auto load_step = [&](int it) {
    const int q0 = q_begin + it * QB;
    const int slot = it % kTcStages;
    load_rows(qr + slot * QB * RS, q + b * st.q[0] + h * st.q[1], st.q[2], q0, QB, S);
    load_rows(dr + slot * QB * RS, dout + b * st.dout[0] + h * st.dout[1], st.dout[2], q0, QB,
              S);
    for (int r = tid; r < QB; r += NTH) {
      const bool ok = q0 + r < S;
      const int64_t at = static_cast<int64_t>(bh) * S + (ok ? q0 + r : 0);
      cp_async4(lr + slot * QB + r, lse + at, ok ? 4 : 0);
      cp_async4(del + slot * QB + r, delta + at, ok ? 4 : 0);
    }
  };
#pragma unroll
  for (int sg = 0; sg < kTcStages - 1; ++sg) {
    if (sg < nsteps) load_step(sg);
    cp_async_commit();  // group 0 also holds K and V
  }

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  const float scale_log2 = scale * kLog2e;
  const T* kw = ks + 16 * warp * RS;
  const T* vw = vs + 16 * warp * RS;

  for (int it = 0; it < nsteps; ++it) {
    cp_async_wait<kTcStages - 2>();  // step it (and K, V) have landed ...
    __syncthreads();                 // ... for every thread, and step it - 1 is consumed
    if (it + kTcStages - 1 < nsteps) load_step(it + kTcStages - 1);
    cp_async_commit();
    const int slot = it % kTcStages;
    const T* qt = qr + slot * QB * RS;
    const T* dt = dr + slot * QB * RS;
    const float* ls = lr + slot * QB;
    const float* ds_ = del + slot * QB;
    const int q0 = q_begin + it * QB;
    // warp-uniform: every query before its keys, or past their windows
    if (causal && q0 + QB - 1 < kw0) continue;
    if (window > 0 && q0 >= kw0 + 15 + window) continue;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x QB queries a warp
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      unsigned ka[4], va[4];
      ldmatrix_x4(ka, kw + (lane & 15) * RS + kk * 16 + (lane >> 4) * 8);
      ldmatrix_x4(va, vw + (lane & 15) * RS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        const int off = (np * 16 + (lane & 7) + (lane >> 4) * 8) * RS + kk * 16 +
                        ((lane >> 3) & 1) * 8;
        unsigned qf[4], df[4];
        ldmatrix_x4(qf, qt + off);
        ldmatrix_x4(df, dt + off);
        mma_bf16(s[2 * np], ka, qf[0], qf[1]);
        mma_bf16(s[2 * np + 1], ka, qf[2], qf[3]);
        mma_bf16(dp[2 * np], va, df[0], df[1]);
        mma_bf16(dp[2 * np + 1], va, df[2], df[3]);
      }
    }

    // P^T into s, dS^T into dp; element (j, e): key kw0 + lane / 4 + 8 (e /
    // 2), query q0 + 8 j + 2 (lane % 4) + e % 2
    const bool masked = (causal && kw0 + 15 > q0) || (window > 0 && q0 + QB - 1 >= kw0 + window) ||
                        q0 + QB > S || kw0 + 16 > Skv;
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * (lane % 4) + (e & 1);
        float p = exp2f(s[j][e] * scale_log2 - ls[c] * kLog2e);
        if (masked && off16(kw0 + lane / 4 + 8 * (e >> 1), q0 + c, S, Skv, causal, window))
          p = 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - ds_[c]);
      }

    // dV += P^T dO, dK += dS^T Q: query tiles 2 kk, 2 kk + 1 are the A
    // fragment of queries 16 kk ..; dO and Q through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < QB / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const unsigned da[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int c16 = 0; c16 < D / 16; ++c16) {
        const int off = (kk * 16 + (lane & 15)) * RS + c16 * 16 + (lane >> 4) * 8;
        unsigned of[4], qf[4];
        ldmatrix_x4_trans(of, dt + off);
        ldmatrix_x4_trans(qf, qt + off);
        mma_bf16(dva[2 * c16], pa, of[0], of[1]);
        mma_bf16(dva[2 * c16 + 1], pa, of[2], of[3]);
        mma_bf16(dka[2 * c16], da, qf[0], qf[1]);
        mma_bf16(dka[2 * c16 + 1], da, qf[2], qf[3]);
      }
    }
  }
  cp_async_wait<0>();

  // rows of keys inside Skv, two columns a store
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = kw0 + lane / 4 + 8 * hh;
    if (key >= Skv) continue;
    if (qpk == 1) {
      T* dkr = dk + b * st.dk[0] + hk * st.dk[1] + key * st.dk[2];
      T* dvr = dv + b * st.dv[0] + hk * st.dv[1] + key * st.dv[2];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int c = 8 * j + 2 * (lane % 4);
        *reinterpret_cast<unsigned*>(dkr + c) =
            pack_bf16(dka[j][2 * hh] * scale, dka[j][2 * hh + 1] * scale);
        *reinterpret_cast<unsigned*>(dvr + c) = pack_bf16(dva[j][2 * hh], dva[j][2 * hh + 1]);
      }
    } else {
      const int64_t rows = static_cast<int64_t>(gridDim.x) * Skv;
      float* pk = part + (static_cast<int64_t>(bh) * Skv + key) * D;
      float* pv = pk + rows * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int c = 8 * j + 2 * (lane % 4);
        *reinterpret_cast<float2*>(pk + c) = make_float2(dka[j][2 * hh], dka[j][2 * hh + 1]);
        *reinterpret_cast<float2*>(pv + c) = make_float2(dva[j][2 * hh], dva[j][2 * hh + 1]);
      }
    }
  }
}

// dK, dV of each kv head: the float32 shares of its qpk q heads added in
// head order (dK scaled), 8 lanes a key row as bwd_delta
template <int D>
__global__ void __launch_bounds__(256)
bwd_group_sum(const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
              __nv_bfloat16* __restrict__ dv, int H, int Hkv, int Skv, int64_t rows, Strides st,
              float scale) {
  const int l8 = threadIdx.x % 8, qpk = H / Hkv;
  // row (b * Hkv + hk) * Skv + key
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 32 + threadIdx.x / 8;
  if (row >= rows) return;
  const int bkv = static_cast<int>(row / Skv), key = static_cast<int>(row % Skv);
  const int b = bkv / Hkv, hk = bkv % Hkv;
  const int64_t all = static_cast<int64_t>(rows) * qpk * D;  // the dK shares' floats
  __nv_bfloat16* dkr = dk + b * st.dk[0] + hk * st.dk[1] + key * st.dk[2];
  __nv_bfloat16* dvr = dv + b * st.dv[0] + hk * st.dv[1] + key * st.dv[2];
  for (int c = l8 * 4; c < D; c += 32) {
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int g = 0; g < qpk; ++g) {
      const int64_t at = ((static_cast<int64_t>(b) * H + hk * qpk + g) * Skv + key) * D + c;
      const float4 xk = *reinterpret_cast<const float4*>(part + at);
      const float4 xv = *reinterpret_cast<const float4*>(part + all + at);
      sk.x += xk.x, sk.y += xk.y, sk.z += xk.z, sk.w += xk.w;
      sv.x += xv.x, sv.y += xv.y, sv.z += xv.z, sv.w += xv.w;
    }
    *reinterpret_cast<uint2*>(dkr + c) = make_uint2(pack_bf16(sk.x * scale, sk.y * scale),
                                                    pack_bf16(sk.z * scale, sk.w * scale));
    *reinterpret_cast<uint2*>(dvr + c) = make_uint2(pack_bf16(sv.x, sv.y), pack_bf16(sv.z, sv.w));
  }
}

// dQ for one (b, h) and 16 query rows a warp, the forward's shape: q and
// dO rows in shared memory (ldmatrix each k16 step), 64-key K/V tiles in a
// cp.async ring from the window's near edge (or 0) to the causal diagonal
// (or Skv):
//   S = Q K^T, P = exp(S scale - lse), dP = dO V^T, dS = P o (dP - D),
//   dQ += dS K (scaled at the end), dS into A fragments, K by ldmatrix.trans.
template <int D>
__global__ void __launch_bounds__(32 * dq_warps<D>())
bwd_dq16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
         const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta,
         __nv_bfloat16* __restrict__ dq, int H, int Hkv, int S, int Skv, int causal, int window,
         Strides st, float scale) {
  using T = __nv_bfloat16;
  constexpr int RS = D + 8;
  constexpr int NTH = 32 * dq_warps<D>();
  constexpr int RQ = 16 * dq_warps<D>();  // query rows a block
  constexpr int CH = D / 8;
  constexpr int KD = D / 16;
  constexpr int NT = kDqKeys / 8;         // n8 score tiles a warp
  static_assert(D % 16 == 0, "head_dim");

  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);  // [RQ][RS]
  T* dos = qs + RQ * RS;                // [RQ][RS] dO
  T* kr = dos + RQ * RS;                // [kDqStages][kDqKeys][RS]
  T* vr = kr + kDqStages * kDqKeys * RS;

  const int iq = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // heaviest first
  const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int q0 = iq * RQ;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const T* kb = k + b * st.k[0] + hk * st.k[1];
  const T* vb = v + b * st.v[0] + hk * st.v[1];

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
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kDqKeys * kDqKeys : 0;
  const int nk = k_end > k_begin ? (k_end - k_begin + kDqKeys - 1) / kDqKeys : 0;

  load_rows(qs, q + b * st.q[0] + h * st.q[1], st.q[2], q0, RQ, S);
  load_rows(dos, dout + b * st.dout[0] + h * st.dout[1], st.dout[2], q0, RQ, S);
#pragma unroll
  for (int sg = 0; sg < kDqStages - 1; ++sg) {
    if (sg < nk) {
      load_rows(kr + sg * kDqKeys * RS, kb, st.k[2], k_begin + sg * kDqKeys, kDqKeys, Skv);
      load_rows(vr + sg * kDqKeys * RS, vb, st.v[2], k_begin + sg * kDqKeys, kDqKeys, Skv);
    }
    cp_async_commit();
  }

  const int wq = q0 + 16 * warp;  // this warp's first query row
  const int r0 = wq + lane / 4;   // row of accumulator elements 0, 1 (2, 3: r0 + 8)
  const T* qw = qs + 16 * warp * RS;
  const T* dw = dos + 16 * warp * RS;
  float lse2[2], drow[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + 8 * hh;
    const int64_t at = static_cast<int64_t>(bh) * S + (row < S ? row : 0);
    lse2[hh] = row < S ? lse[at] * kLog2e : 0.f;
    drow[hh] = row < S ? delta[at] : 0.f;
  }
  const float scale_log2 = scale * kLog2e;
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kDqStages - 2>();  // tile t (and q, dO) have landed ...
    __syncthreads();                 // ... for every thread, and tile t - 1 is consumed
    const int pf = t + kDqStages - 1;
    if (pf < nk) {
      load_rows(kr + (pf % kDqStages) * kDqKeys * RS, kb, st.k[2], k_begin + pf * kDqKeys,
                kDqKeys, Skv);
      load_rows(vr + (pf % kDqStages) * kDqKeys * RS, vb, st.v[2], k_begin + pf * kDqKeys,
                kDqKeys, Skv);
    }
    cp_async_commit();
    const T* kt = kr + (t % kDqStages) * kDqKeys * RS;
    const T* vt = vr + (t % kDqStages) * kDqKeys * RS;
    const int k0 = k_begin + t * kDqKeys;
    // warp-uniform: every key past its rows, or left of their windows
    if (causal && k0 > wq + 15) continue;
    if (window > 0 && k0 + kDqKeys - 1 <= wq - window) continue;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      unsigned qa[4], da[4];
      ldmatrix_x4(qa, qw + (lane & 15) * RS + kk * 16 + (lane >> 4) * 8);
      ldmatrix_x4(da, dw + (lane & 15) * RS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int off = (np * 16 + (lane & 7) + (lane >> 4) * 8) * RS + kk * 16 +
                        ((lane >> 3) & 1) * 8;
        unsigned kf[4], vf[4];
        ldmatrix_x4(kf, kt + off);
        ldmatrix_x4(vf, vt + off);
        mma_bf16(s[2 * np], qa, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
        mma_bf16(dp[2 * np], da, vf[0], vf[1]);
        mma_bf16(dp[2 * np + 1], da, vf[2], vf[3]);
      }
    }

    // dS into dp; element (j, e): key k0 + 8 j + 2 (lane % 4) + e % 2, row
    // r0 + 8 (e / 2)
    const bool masked = k0 + kDqKeys > Skv || wq + 16 > S ||
                        (causal && k0 + kDqKeys - 1 > wq) || (window > 0 && k0 <= wq + 15 - window);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[j][e] * scale_log2 - lse2[e >> 1]);
        if (masked && off16(k0 + 8 * j + 2 * (lane % 4) + (e & 1), r0 + 8 * (e >> 1), S, Skv,
                            causal, window))
          p = 0.f;
        dp[j][e] = p * (dp[j][e] - drow[e >> 1]);
      }

    // dQ += dS K: key tiles 2 kk, 2 kk + 1 are the A fragment of keys 16 kk ..
#pragma unroll
    for (int kk = 0; kk < kDqKeys / 16; ++kk) {
      const unsigned a[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                             pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                             pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                             pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int c16 = 0; c16 < D / 16; ++c16) {
        unsigned kf[4];
        ldmatrix_x4_trans(kf, kt + (kk * 16 + (lane & 15)) * RS + c16 * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * c16], a, kf[0], kf[1]);
        mma_bf16(acc[2 * c16 + 1], a, kf[2], kf[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + 8 * hh;
    if (row >= S) continue;
    T* dqr = dq + b * st.dq[0] + h * st.dq[1] + row * st.dq[2];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<unsigned*>(dqr + 8 * j + 2 * (lane % 4)) =
          pack_bf16(acc[j][2 * hh] * scale, acc[j][2 * hh + 1] * scale);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           void* dq, void* dk, void* dv, const float* lse, float* delta, float* part, int B,
           int H, int Hkv, int S, int Skv, int causal, int window, const Strides& st,
           cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const int64_t rows = static_cast<int64_t>(B) * H * S;
  bwd_delta<T, D><<<static_cast<unsigned>((rows + 31) / 32), 256, 0, stream>>>(
      static_cast<const T*>(o), dop, delta, H, S, rows, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (std::is_same_v<T, float>) {
    auto kkv = bwd_dkdv<T, D>;
    err = allow_smem(kkv, dkdv_smem<D>());
    if (err != cudaSuccess) return err;
    kkv<<<dim3(B * Hkv, (Skv + kKeys - 1) / kKeys), kThreads, dkdv_smem<D>(), stream>>>(
        qp, kp, vp, dop, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, Hkv, S, Skv,
        causal, window, st, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    auto kq = bwd_dq<T, D>;
    err = allow_smem(kq, dq_smem<D>());
    if (err != cudaSuccess) return err;
    kq<<<dim3(B * H, (S + kQ - 1) / kQ), kThreads, dq_smem<D>(), stream>>>(
        qp, kp, vp, dop, lse, delta, static_cast<T*>(dq), H, Hkv, S, Skv, causal, window, st,
        scale);
  } else {
    auto kkv = bwd_dkdv16<D>;
    err = allow_smem(kkv, dkdv_smem16<D>());
    if (err != cudaSuccess) return err;
    const int kb = 16 * kTcWarps;
    kkv<<<dim3(B * H, (Skv + kb - 1) / kb), 32 * kTcWarps, dkdv_smem16<D>(), stream>>>(
        qp, kp, vp, dop, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), part, H, Hkv, S,
        Skv, causal, window, st, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (H > Hkv) {
      const int64_t kv_rows = static_cast<int64_t>(B) * Hkv * Skv;
      bwd_group_sum<D><<<static_cast<unsigned>((kv_rows + 31) / 32), 256, 0, stream>>>(
          part, static_cast<T*>(dk), static_cast<T*>(dv), H, Hkv, Skv, kv_rows, st, scale);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    auto kq = bwd_dq16<D>;
    err = allow_smem(kq, dq_smem16<D>());
    if (err != cudaSuccess) return err;
    const int rq = 16 * dq_warps<D>();
    kq<<<dim3(B * H, (S + rq - 1) / rq), 32 * dq_warps<D>(), dq_smem16<D>(), stream>>>(
        qp, kp, vp, dop, lse, delta, static_cast<T*>(dq), H, Hkv, S, Skv, causal, window, st,
        scale);
  }
  return cudaGetLastError();
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, const void* o,
             const void* dout, void* dq, void* dk, void* dv, const float* lse, float* delta,
             float* part, int B, int H, int Hkv, int S, int Skv, int causal, int window,
             const Strides& st, cudaStream_t s) {
#define HAM_BWD_CASE(D)                                                                       \
  case D:                                                                                     \
    return launch<T, D>(q, k, v, o, dout, dq, dk, dv, lse, delta, part, B, H, Hkv, S, Skv, \
                        causal, window, st, s);
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
// o, dout, dq, dk, dv.  lse (B*H*S, float32): each row's log-sum-exp, as
// the forward writes it; delta (B*H*S) float32 scratch for D; part: bf16
// with H > Hkv, float32 scratch for 2*B*H*Skv*d (the q heads' dK and dV
// shares), else unused.  window 0 means none and applies only when causal.
// Returns 0 or the launch error.
extern "C" int ham_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq,
    void* dk, void* dv, const void* lse, void* delta, void* part, int B, int H, int Hkv, int S,
    int Skv, int d, int causal, int window, int dtype, const long long* strides, int device,
    void* stream) {
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
  auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(delta);
  auto* pt = static_cast<float*>(part);
  switch (dtype) {
    case ham::kF32:
      return ham::dispatch<float>(d, q, k, v, o, dout, dq, dk, dv, l, dl, pt, B, H, Hkv, S,
                                  Skv, causal, window, st, s);
    case ham::kBF16:
      return ham::dispatch<__nv_bfloat16>(d, q, k, v, o, dout, dq, dk, dv, l, dl, pt, B, H,
                                          Hkv, S, Skv, causal, window, st, s);
    default: return ham::kUnsupported;
  }
}
