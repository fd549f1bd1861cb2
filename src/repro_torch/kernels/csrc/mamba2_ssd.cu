// Mamba2 SSD (state-space dual) chunked scan for Hopper (sm_90a), forward
// only.
//
// Replaces the Pallas TPU kernel repro/kernels/mamba2_ssd.py (_ssd_kernel):
// per (sequence, head), chunks of L positions run in order carrying the
// state h (N x P, float32); inside a chunk, with Lc the inclusive cumsum of
// log lambda = A dt,
//   y_t = sum_{s<=t} (C_t.B_s) e^{Lc_t-Lc_s} dt_s x_s + e^{Lc_t} C_t h_prev + D x_t
//   h   = e^{Lc_L} h_prev + sum_s e^{Lc_L-Lc_s} dt_s B_s x_s^T.
// The D x skip is fused into the epilogue and y is rounded once, as the
// reference model's plain ssd_chunked does (repro/models/mamba2.py:82-83;
// the reference's kernel wrapper rounds y and then adds D x).
//
// Bound on an H100: a zamba2-2.7b admission of 1024 tokens (80 heads,
// P = N = 64, one B/C group, L = 256) does 6.7 GFLOP, counted as the TPU
// kernel's work, on 22.9 MB: ~6.8 us either way.  Design of this first,
// simple version:
//  * one block per (head, sequence) walks the chunks in order with h in
//    shared memory (N x P float32 is 16 KB, where mLSTM's C was 2 MB);
//  * a block scan gives Lc; positions from S up to the chunk's end read
//    x = B = C = 0 and dt = 0 (log decay 0, weight 0), so a ragged last
//    chunk is exact and the caller takes chunk = min(256, S) for any S;
//  * the L x L product runs in 64 x 64 tiles on and below the diagonal
//    only: the decay exponent Lc_t - Lc_s is never evaluated above it,
//    where it is positive and could overflow into inf * 0;
//  * x, B and C are read through (b, s, h|g) strides straight from the
//    model's conv output, the group of head h being h / (H / G), so B and
//    C are never repeated per head; y is written in the model's (B, S, H, P)
//    layout.
// The products run on the CUDA cores in float32; at B = 1 the 80 blocks
// fill 80 of 132 SMs.  The chunk-parallel split (chunk states, a state
// scan, then outputs), tensor-core tiles and TMA are later work.
#include "common.cuh"

namespace ham {
namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kT = 64;         // tile edge: positions, state rows n, head columns p
constexpr int kMaxL = kThreads;  // longest chunk: one position per thread in the scan
constexpr int kS = kT + 4;     // row stride of the C, B and score tiles: conflict-free float4 rows
constexpr int kChunk = 4;      // 16-byte loads in flight per thread

constexpr size_t smem_bytes() {
  // h [n][p], C [t][n], B [s][n], x [s][p], scores [t][s], Lc, dt, scan scratch
  return sizeof(float) * (kT * kT + 3 * kT * kS + kT * kT + 2 * kMaxL + 8);
}

struct Dims {
  int B, S, H, G, L;
};

struct Strides {  // element strides of the outer dims (every last dim is contiguous)
  int64_t x_sb, x_ss, x_sh, d_sb, d_ss, d_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg, y_sb, y_ss,
      y_sh;
};

// Inclusive sum over the block's 256 threads in thread order.
__device__ float block_scan(float x, float* tot /* [8] */) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) tot[w] = x;
  __syncthreads();
  if (w == 0) {
    float t = lane < 8 ? tot[lane] : 0.f;
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    if (lane < 8) tot[lane] = t;
  }
  __syncthreads();
  if (w > 0) x += tot[w - 1];
  return x;
}

// Rows [row0, row0 + 64) of a (rows, 64) matrix with row stride rs ->
// dst[64][stride] as float; rows at or past rows_valid are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int stride, const T* src, int64_t rs,
                                          int row0, int rows_valid, int tid) {
  constexpr int VN = Vec<T>::N, VPR = kT / VN, kVecs = kT * VPR;
  for (int base = 0; base < kVecs; base += kThreads * kChunk) {
    uint4 raw[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int idx = base + u * kThreads + tid;
      const int row = idx / VPR, c = (idx % VPR) * VN;
      const bool ok = idx < kVecs && row0 + row < rows_valid;
      raw[u] = ok ? load16(src + (row0 + row) * rs + c) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int idx = base + u * kThreads + tid;
      if (idx < kVecs) {
        const int row = idx / VPR, c = (idx % VPR) * VN;
        float f[VN];
        Vec<T>::to_float(raw[u], f);
#pragma unroll
        for (int e = 0; e < VN; ++e) dst[row * stride + c + e] = f[e];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
           const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ Dskip,
           const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ hN, Dims D,
           Strides st) {
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // [n][p]
  float* cs = hs + kT * kT;                     // [t][kS]: C rows of the output tile
  float* bs = cs + kT * kS;                     // [s][kS]: B rows of the source tile
  float* ps = bs + kT * kS;                     // [t][kS]: weighted scores; state-pass weights
  float* xs = ps + kT * kS;                     // [s][p]: x rows of the source tile
  float* lc = xs + kT * kT;                     // [kMaxL] Lc of the chunk
  float* dts = lc + kMaxL;                      // [kMaxL] dt of the chunk
  float* tot = dts + kMaxL;                     // [8] scan scratch

  const int h = blockIdx.x, b = blockIdx.y, g = h / (D.H / D.G);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float a = A[h], dskip = Dskip[h];
  const int64_t hoff = (static_cast<int64_t>(b) * D.H + h) * kT * kT;
  for (int i = tid; i < kT * kT; i += kThreads) hs[i] = h0 ? h0[hoff + i] : 0.f;

  const T* xb = x + b * st.x_sb + h * st.x_sh;
  const T* bb = Bm + b * st.b_sb + g * st.b_sg;
  const T* cb = Cm + b * st.c_sb + g * st.c_sg;
  const float* db = dt + b * st.d_sb + h * st.d_sh;
  T* yb = y + b * st.y_sb + h * st.y_sh;

  for (int c0 = 0; c0 < D.S; c0 += D.L) {
    const int nvalid = min(D.L, D.S - c0);  // positions of this chunk inside S
    const int nt = (nvalid + kT - 1) / kT;
    const T* xc = xb + c0 * st.x_ss;
    const T* bc = bb + c0 * st.b_ss;
    const T* cc = cb + c0 * st.c_ss;

    __syncthreads();  // the previous chunk's state pass is done with lc, dts and hs
    const float dtv = tid < nvalid ? db[static_cast<int64_t>(c0 + tid) * st.d_ss] : 0.f;
    const float l = block_scan(a * dtv, tot);
    lc[tid] = l;
    dts[tid] = dtv;

    // ---- outputs, one 64-position tile at a time ----
    for (int ti = 0; ti < nt; ++ti) {
      const int t0 = ti * kT;
      __syncthreads();  // cs and xs of the previous tile are consumed; lc is written
      load_tile(cs, kS, cc, st.c_ss, t0, nvalid, tid);
      float acc[4][4] = {};  // rows t0 + ty + 16r, columns tx + 16c
      for (int si = 0; si <= ti; ++si) {  // the diagonal tile last: xs then holds x_t
        const int s0 = si * kT;
        __syncthreads();  // bs, xs and ps of the previous source tile are consumed
        load_tile(bs, kS, bc, st.b_ss, s0, nvalid, tid);
        load_tile(xs, kT, xc, st.x_ss, s0, nvalid, tid);
        __syncthreads();
        float sc[4][4] = {};
#pragma unroll 2
        for (int i = 0; i < kT; i += 4) {
          float4 ca[4], ba[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) ca[r] = *reinterpret_cast<const float4*>(cs + (ty + 16 * r) * kS + i);
#pragma unroll
          for (int c = 0; c < 4; ++c) ba[c] = *reinterpret_cast<const float4*>(bs + (tx + 16 * c) * kS + i);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              sc[r][c] += ca[r].x * ba[c].x + ca[r].y * ba[c].y + ca[r].z * ba[c].z + ca[r].w * ba[c].w;
        }
        // decay-weight on and below the diagonal only (there Lc_t - Lc_s <= 0)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int t = t0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int s = s0 + tx + 16 * c;
            ps[(ty + 16 * r) * kS + tx + 16 * c] =
                s <= t ? sc[r][c] * expf(lc[t] - lc[s]) * dts[s] : 0.f;
          }
        }
        __syncthreads();
#pragma unroll 2
        for (int j = 0; j < kT; j += 4) {
          float pr[4][4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float4 p4 = *reinterpret_cast<const float4*>(ps + (ty + 16 * r) * kS + j);
            pr[r][0] = p4.x;
            pr[r][1] = p4.y;
            pr[r][2] = p4.z;
            pr[r][3] = p4.w;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float xv = xs[(j + u) * kT + tx + 16 * c];
#pragma unroll
              for (int r = 0; r < 4; ++r) acc[r][c] += pr[r][u] * xv;
            }
        }
      }
      // inter-chunk term: C_t . h_prev
      float inter[4][4] = {};
#pragma unroll 2
      for (int j = 0; j < kT; j += 4) {
        float cr[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 c4 = *reinterpret_cast<const float4*>(cs + (ty + 16 * r) * kS + j);
          cr[r][0] = c4.x;
          cr[r][1] = c4.y;
          cr[r][2] = c4.z;
          cr[r][3] = c4.w;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float hv = hs[(j + u) * kT + tx + 16 * c];
#pragma unroll
            for (int r = 0; r < 4; ++r) inter[r][c] += cr[r][u] * hv;
          }
      }
      // y = intra + e^{Lc_t} inter + D x, rounded once
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = t0 + ty + 16 * r;
        if (t < nvalid) {
          const float e = expf(lc[t]);
          T* yrow = yb + static_cast<int64_t>(c0 + t) * st.y_ss;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int p = tx + 16 * c;
            store(yrow + p, acc[r][c] + e * inter[r][c] + dskip * xs[(ty + 16 * r) * kT + p]);
          }
        }
      }
    }

    // ---- state: h = e^{Lc_L} h + sum_s e^{Lc_L - Lc_s} dt_s B_s x_s^T ----
    const float lL = lc[nvalid - 1];  // positions past nvalid leave Lc unchanged
    float hacc[4][4] = {};            // n = ty*4 + r, p = tx*4 + c
    for (int si = 0; si < nt; ++si) {
      const int s0 = si * kT;
      __syncthreads();  // every output tile is done with bs, xs, ps and hs
      load_tile(bs, kS, bc, st.b_ss, s0, nvalid, tid);
      load_tile(xs, kT, xc, st.x_ss, s0, nvalid, tid);
      if (tid < kT) ps[tid] = s0 + tid < nvalid ? expf(lL - lc[s0 + tid]) * dts[s0 + tid] : 0.f;
      __syncthreads();
#pragma unroll 4
      for (int s = 0; s < kT; ++s) {
        const float w = ps[s];
        const float4 b4 = *reinterpret_cast<const float4*>(bs + s * kS + ty * 4);
        const float4 x4 = *reinterpret_cast<const float4*>(xs + s * kT + tx * 4);
        const float bv[4] = {w * b4.x, w * b4.y, w * b4.z, w * b4.w};
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) hacc[r][c] += bv[r] * xv[c];
      }
    }
    const float decay = expf(lL);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float* hp = hs + (ty * 4 + r) * kT + tx * 4 + c;  // this thread's own entries
        *hp = decay * *hp + hacc[r][c];
      }
  }
  __syncthreads();
  for (int i = tid; i < kT * kT; i += kThreads) hN[hoff + i] = hs[i];
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
           const float* Dskip, const float* h0, void* y, float* hN, const Dims& D,
           const Strides& st, cudaStream_t stream) {
  auto kernel = ssd_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem_bytes());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(D.H, D.B), kThreads, smem_bytes(), stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      Dskip, h0, static_cast<T*>(y), hN, D, st);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ham

// x/y (B, S, H, P), Bm/Cm (B, S, G, N) in one dtype, dt (B, S, H) float32:
// element strides of the three outer dims (x, Bm, Cm, y: unit last dim).
// A, Dskip (H,) float32; h0 and hN (B, H, N, P) float32 and contiguous, h0
// read when has_state.  Takes N = P = 64, H % G == 0 and 1 <= L <= 256;
// chunks of L positions from 0, the last one masked at S.  Returns 0 or the
// launch error.
extern "C" int ham_ssd_chunked(
    const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
    const float* Dskip, const float* h0, void* y, float* hN,
    int B, int S, int H, int G, int N, int P, int L, int has_state, int dtype,
    long long x_sb, long long x_ss, long long x_sh, long long d_sb, long long d_ss,
    long long d_sh, long long b_sb, long long b_ss, long long b_sg, long long c_sb,
    long long c_ss, long long c_sg, long long y_sb, long long y_ss, long long y_sh,
    int device, void* stream) {
  if (N != ham::kT || P != ham::kT || L < 1 || L > ham::kMaxL || G < 1 || H % G)
    return ham::kUnsupported;
  if (B == 0 || H == 0 || S == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const ham::Dims D{B, S, H, G, L};
  const ham::Strides st{x_sb, x_ss, x_sh, d_sb, d_ss, d_sh, b_sb, b_ss, b_sg,
                        c_sb, c_ss, c_sg, y_sb, y_ss, y_sh};
  const float* h = has_state ? h0 : nullptr;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ham::kF32: return ham::launch<float>(x, dt, A, Bm, Cm, Dskip, h, y, hN, D, st, s);
    case ham::kBF16:
      return ham::launch<__nv_bfloat16>(x, dt, A, Bm, Cm, Dskip, h, y, hN, D, st, s);
    default: return ham::kUnsupported;
  }
}
