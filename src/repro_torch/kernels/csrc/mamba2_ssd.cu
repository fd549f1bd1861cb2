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
// P = N = 64, one B/C group, L = 256) moves 22.9 MB, ~6.8 us; its 4.0 GFLOP
// on and below the diagonal take ~4.1 us at the bf16 peak.  The TPU kernel walks the
// chunks of one (sequence, head) in order on one core; here that walk
// would give one block per (sequence, head), 80 blocks on 132 SMs at B = 1.
// Both routes share these rules:
//  * positions from S up to the chunk's end read x = B = C = 0 and dt = 0
//    (log decay 0, weight 0), so a ragged last chunk is exact and the caller
//    takes chunk = min(256, S) for any S;
//  * the L x L product runs in 64 x 64 tiles on and below the diagonal
//    only: the decay exponent Lc_t - Lc_s is never evaluated above it,
//    where it is positive and could overflow into inf * 0;
//  * x, B and C are read through (b, s, h|g) strides straight from the
//    model's conv output, the group of head h being h / (H / G), so B and
//    C are never repeated per head; y is written in the model's (B, S, H, P)
//    layout.
// Tensor-core route (bf16), three launches on the stream, the chunks split
// across blocks (a state of 16 KB a chunk is cheap to store and combine):
//  1. chunk_state_tc: one block per (chunk, head, sequence) scans Lc over
//     the chunk (stored per position for pass 3, with dt and the tile-local
//     weight wt_s = e^{Lc_e-Lc_s} dt_s, e the last position of s's
//     64-position tile) and forms the chunk's state update dh = (B w)^T x,
//     w_s = e^{Lc_L-Lc_s} dt_s, on the tensor cores (mma.sync m16n8k16,
//     float32 accumulators), the weighted B rounded once to bf16 (the decay
//     keeps the sum short: one rounding stays within a fifth of the state
//     tolerance, where the mLSTM's state pass needed a hi + lo pair); dh
//     goes to a float32 scratch;
//  2. combine_states: one block per (quarter of h, head, sequence) runs
//     h = e^{Lc_L} h + dh over the chunks in order in float32, storing h at
//     every chunk start as bf16 (the operand of pass 3) and the final h;
//  3. output_tc: one block of 4 warps per (64-position tile, chunk, head,
//     sequence), the tiles with the most source tiles first: C_t h_prev on
//     the tensor cores scaled by e^{Lc_t}, then per source tile S = C_t B_s^T,
//     P = S e^{Lc_t-Lc_s} dt_s on the accumulator fragments (below the
//     diagonal tile as e^{Lc_t-Lc_e} wt_s, two factors of at most 1), P packed
//     to bf16 A fragments (flash-style: no score tile in shared or device
//     memory) and acc += P x_s; B, x, Lc, dt and wt of the source tiles come
//     through a double-buffered cp.async ring; y = acc + D x_t, rounded once.
//     Four blocks share an SM (57 KB of shared memory and at most 128
//     registers each): the pass waits on its loads and on each step's
//     chain of products more than on the tensor cores' rate.
// CUDA-core route (float32; bf16 only when forced, for timing it): the
// first port's kernel, one block per (head, sequence) walking the chunks in
// order with h in shared memory and every product in float32.
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
  int B, S, H, G, L, nc, Lp;  // nc chunks; Lp: L rounded up to the tile edge
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

// ---- CUDA-core route: one block per (head, sequence) walks the chunks ------

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

// ---- tensor-core route (bf16) ----------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kRS = kT + 8;            // bf16 row stride of a 64-row tile: conflict-free ldmatrix
constexpr int kTile = kT * kRS;        // one padded 64 x 64 bf16 tile
constexpr int kSteps = kMaxL / kT;     // 64-position steps of the longest chunk
constexpr int kOutThreads = 128;       // pass 3: 4 warps of 16 rows
constexpr int kStages = 2;             // pass 3's cp.async ring of source tiles (double buffer)
constexpr int kCombineThreads = 256;   // pass 2: one float4 of h a thread
constexpr size_t kStateSmem = 2 * kSteps * kTile * sizeof(bf16) + (2 * kMaxL + 8) * sizeof(float);
constexpr size_t kOutSmem =
    (2 + 2 * kStages) * kTile * sizeof(bf16) + kStages * 3 * kT * sizeof(float);

// Scratch of the tensor-core route, allocated by the wrapper.
struct Work {
  float* lc;  // (B*H, nc, Lp) Lc per position; positions past S repeat the chunk's last
  float* dt;  // (B*H, nc, Lp) dt per position, 0 past S
  float* wt;  // (B*H, nc, Lp) e^{Lc_e-Lc_s} dt_s, e the last position of s's 64-position tile
  float* dh;  // (B*H, nc, N, P) each chunk's state update
  bf16* hs;   // (B*H, nc, N, P) the state at each chunk start, rounded to bf16
};

// wait until at most n (0..3) of this thread's cp.async groups are pending
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n <= 0) cp_async_wait<0>();
  else if (n == 1) cp_async_wait<1>();
  else if (n == 2) cp_async_wait<2>();
  else cp_async_wait<3>();
}

// Pass 1: one block of 8 warps per (chunk, head, sequence).  Every step's
// B and x rows start loading (one cp.async group a 64-position step) before
// the scan; per step each thread turns the B vectors it loaded into the
// weighted B, rounded to bf16 in place, and the warps form dh += (B w)^T x
// with the weighted B through ldmatrix.trans as the A operand: warp w takes
// state rows 16 (w / 2) .. + 15 and columns 32 (w % 2) .. + 31.
__global__ void __launch_bounds__(kThreads)
chunk_state_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const bf16* __restrict__ Bm, Work ws, Dims D,
               Strides st) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* bs = reinterpret_cast<bf16*>(smem_raw);  // [kSteps][64][kRS] B rows, then B w
  bf16* xs = bs + kSteps * kTile;                // [kSteps][64][kRS] x rows
  float* wts = reinterpret_cast<float*>(xs + kSteps * kTile);  // [kMaxL] e^{Lc_L-Lc_s} dt_s
  float* lsh = wts + kMaxL;                      // [kMaxL] Lc
  float* tot = lsh + kMaxL;                      // [8] scan scratch
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, g = h / (D.H / D.G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = c * D.L, nvalid = min(D.L, D.S - c0), nsteps = (nvalid + kT - 1) / kT;
  const bf16* xc = x + b * st.x_sb + h * st.x_sh + static_cast<int64_t>(c0) * st.x_ss;
  const bf16* bc = Bm + b * st.b_sb + g * st.b_sg + static_cast<int64_t>(c0) * st.b_ss;
  for (int s = 0; s < kSteps; ++s) {
    if (s < nsteps)
      for (int idx = tid; idx < kT * (kT / 8); idx += kThreads) {
        const int r = idx / (kT / 8), col = (idx % (kT / 8)) * 8, p = s * kT + r;
        const bool ok = p < nvalid;
        cp_async16(bs + s * kTile + r * kRS + col, ok ? bc + p * st.b_ss + col : bc, ok ? 16 : 0);
        cp_async16(xs + s * kTile + r * kRS + col, ok ? xc + p * st.x_ss + col : xc, ok ? 16 : 0);
      }
    cp_async_commit();
  }

  const int64_t row = (static_cast<int64_t>(b * D.H + h) * D.nc + c) * D.Lp;
  const float dtv =
      tid < nvalid ? dt[b * st.d_sb + h * st.d_sh + static_cast<int64_t>(c0 + tid) * st.d_ss] : 0.f;
  const float l = block_scan(A[h] * dtv, tot);
  lsh[tid] = l;
  __syncthreads();
  // positions past nvalid keep Lc_L, so the tile ends below are never past it
  wts[tid] = expf(lsh[nvalid - 1] - l) * dtv;
  if (tid < D.Lp) {
    ws.lc[row + tid] = l;
    ws.dt[row + tid] = dtv;
    ws.wt[row + tid] = expf(lsh[tid | (kT - 1)] - l) * dtv;
  }

  float acc[4][4] = {};  // (nt, i): state row 16 (warp / 2) + lane / 4 + 8 (i / 2), column
                         // 32 (warp % 2) + 8 nt + 2 (lane % 4) + i % 2
  const int wm = warp / 2, wn = warp % 2;
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait_upto(kSteps - 1 - s);  // step s has landed (this thread's copies)
    __syncthreads();                     // ... for every thread, and wts is written
    bf16* bt = bs + s * kTile;
    const bf16* xt = xs + s * kTile;
    for (int idx = tid; idx < kT * (kT / 8); idx += kThreads) {
      const int r = idx / (kT / 8), col = (idx % (kT / 8)) * 8;
      const float w = wts[s * kT + r];
      uint4* pb = reinterpret_cast<uint4*>(bt + r * kRS + col);
      float f[8];
      Vec<bf16>::to_float(*pb, f);
      *pb = make_uint4(pack_bf16(f[0] * w, f[1] * w), pack_bf16(f[2] * w, f[3] * w),
                       pack_bf16(f[4] * w, f[5] * w), pack_bf16(f[6] * w, f[7] * w));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kT; kk += 16) {
      unsigned a[4], bx[2][4];
      ldmatrix_x4_trans(a, bt + (kk + (lane & 7) + ((lane >> 4) << 3)) * kRS + wm * 16 +
                               ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        ldmatrix_x4_trans(bx[jj],
                          xt + (kk + (lane & 15)) * kRS + wn * 32 + jj * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_bf16(acc[nt], a, bx[nt / 2][2 * (nt % 2)], bx[nt / 2][2 * (nt % 2) + 1]);
    }
  }
  float* dh = ws.dh + (static_cast<int64_t>(b * D.H + h) * D.nc + c) * kT * kT;
  const int fr = wm * 16 + lane / 4, fc = wn * 32 + 2 * (lane % 4);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<float2*>(dh + (fr + 8 * hr) * kT + fc + 8 * nt) =
          make_float2(acc[nt][2 * hr], acc[nt][2 * hr + 1]);
}

// Pass 2: one block per (quarter of h, head, sequence), one float4 of h a
// thread, walks the chunks in order: store h (bf16) as the chunk's h_prev,
// then h = e^{Lc_L} h + dh.  The final h is written in float32.
__global__ void __launch_bounds__(kCombineThreads)
combine_states(const float* __restrict__ h0, float* __restrict__ hN, Work ws, Dims D) {
  const int bh = blockIdx.y, e = (blockIdx.x * kCombineThreads + threadIdx.x) * 4;
  const int64_t base = static_cast<int64_t>(bh) * kT * kT + e;
  float4 h = h0 ? *reinterpret_cast<const float4*>(h0 + base) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int c = 0; c < D.nc; ++c) {
    const int64_t off = (static_cast<int64_t>(bh) * D.nc + c) * kT * kT + e;
    const float dec = expf(ws.lc[(static_cast<int64_t>(bh) * D.nc + c) * D.Lp + D.Lp - 1]);
    const float4 d = *reinterpret_cast<const float4*>(ws.dh + off);
    *reinterpret_cast<uint2*>(ws.hs + off) = make_uint2(pack_bf16(h.x, h.y), pack_bf16(h.z, h.w));
    h = make_float4(dec * h.x + d.x, dec * h.y + d.y, dec * h.z + d.z, dec * h.w + d.w);
  }
  *reinterpret_cast<float4*>(hN + base) = h;
}

// Pass 3: one block of 4 warps per (64-position tile ti of chunk ch, head,
// sequence); warp w owns rows 16 w .. + 15 of the tile.  blockIdx.z orders
// the tiles heaviest first: ti from the last, and among one ti the chunks
// that carry an h_prev term first.
__global__ void __launch_bounds__(kOutThreads, 4)
output_tc(const bf16* __restrict__ x, const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
          const float* __restrict__ Dskip, bool has_state, bf16* __restrict__ y, Work ws, Dims D,
          Strides st) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* cs = reinterpret_cast<bf16*>(smem_raw);  // [64][kRS] C rows of the output tile
  bf16* hp = cs + kTile;                         // [64][kRS] h_prev [n][p]
  bf16* ring = hp + kTile;                       // [kStages][B rows, x rows][64][kRS]
  // [kStages][Lc, dt, wt][64]
  float* ring_f = reinterpret_cast<float*>(ring + kStages * 2 * kTile);
  const int nt = D.Lp / kT, z = blockIdx.z;
  const int ti = nt - 1 - z / D.nc, ch = (z % D.nc + 1) % D.nc;
  const int h = blockIdx.x, b = blockIdx.y, g = h / (D.H / D.G), bh = b * D.H + h;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = ch * D.L, nvalid = min(D.L, D.S - c0), t0 = ti * kT;
  if (t0 >= nvalid) return;  // a tile of masked positions only
  const bool has_prev = has_state || ch > 0;
  const int64_t lrow = (static_cast<int64_t>(bh) * D.nc + ch) * D.Lp;
  const bf16* cb = Cm + b * st.c_sb + g * st.c_sg + static_cast<int64_t>(c0) * st.c_ss;
  const bf16* bb = Bm + b * st.b_sb + g * st.b_sg + static_cast<int64_t>(c0) * st.b_ss;
  const bf16* xb = x + b * st.x_sb + h * st.x_sh + static_cast<int64_t>(c0) * st.x_ss;

  // rows [row0, row0 + 64) of a chunk-relative (rows, 64) matrix -> dst by
  // cp.async; rows at or past nvalid are zero-filled and read nothing
  const auto load_rows = [&](bf16* dst, const bf16* src, int64_t rs, int row0) {
    for (int idx = tid; idx < kT * (kT / 8); idx += kOutThreads) {
      const int r = idx / (kT / 8), col = (idx % (kT / 8)) * 8;
      const bool ok = row0 + r < nvalid;
      cp_async16(dst + r * kRS + col, ok ? src + (row0 + r) * rs + col : src, ok ? 16 : 0);
    }
  };
  const auto load_step = [&](int i) {  // source tile i: B and x rows, then Lc, dt and wt
    bf16* d = ring + (i % kStages) * 2 * kTile;
    load_rows(d, bb, st.b_ss, i * kT);
    load_rows(d + kTile, xb, st.x_ss, i * kT);
    if (tid < 3 * kT / 4) {
      const int part = tid / (kT / 4), v = 4 * (tid % (kT / 4));
      const float* src = part == 0 ? ws.lc : part == 1 ? ws.dt : ws.wt;
      cp_async16(ring_f + ((i % kStages) * 3 + part) * kT + v, src + lrow + i * kT + v, 16);
    }
  };
  // group 0: the C rows, h_prev and source tile 0
  load_rows(cs, cb, st.c_ss, t0);
  if (has_prev) {
    const bf16* hsrc = ws.hs + (static_cast<int64_t>(bh) * D.nc + ch) * kT * kT;
    for (int idx = tid; idx < kT * (kT / 8); idx += kOutThreads) {
      const int r = idx / (kT / 8), col = (idx % (kT / 8)) * 8;
      cp_async16(hp + r * kRS + col, hsrc + r * kT + col, 16);
    }
  }
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i <= ti) load_step(i);
    cp_async_commit();
  }

  const int tl0 = 16 * warp + lane / 4;  // tile row of accumulator elements 0, 1 (2, 3: + 8)
  const float lt[2] = {ws.lc[lrow + t0 + tl0], ws.lc[lrow + t0 + tl0 + 8]};
  // this warp's C rows as the A fragment of k16 step kk (over N)
  const bf16* ca = cs + (16 * warp + (lane & 15)) * kRS + (lane >> 4) * 8;
  float acc[8][4];                       // (j, e): column 8 j + 2 (lane % 4) + e % 2
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int i = 0; i <= ti; ++i) {
    cp_async_wait<kStages - 2>();  // source tile i (and the C rows, h_prev) have landed ...
    __syncthreads();               // ... for every thread, and tile i - 1 is consumed
    if (i == 0 && has_prev) {  // acc = e^{Lc_t} C_t h_prev
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        unsigned cf[4];
        ldmatrix_x4(cf, ca + kk * 16);
#pragma unroll
        for (int dp = 0; dp < 4; ++dp) {
          unsigned hf[4];
          ldmatrix_x4_trans(hf, hp + (kk * 16 + (lane & 15)) * kRS + dp * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * dp], cf, hf[0], hf[1]);
          mma_bf16(acc[2 * dp + 1], cf, hf[2], hf[3]);
        }
      }
      const float e0 = expf(lt[0]), e1 = expf(lt[1]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] *= e0;
        acc[j][1] *= e0;
        acc[j][2] *= e1;
        acc[j][3] *= e1;
      }
    }
    if (i + kStages - 1 <= ti) load_step(i + kStages - 1);
    cp_async_commit();
    const bf16* bt = ring + (i % kStages) * 2 * kTile;
    const bf16* xt = bt + kTile;
    const float* lcs = ring_f + (i % kStages) * 3 * kT;
    const float* dts = lcs + kT;
    const float* wts = dts + kT;
    const bool diag = i == ti;
    // on the diagonal tile, warp w's rows see sources 0 .. 16 w + 15 only
    const int jmax = diag ? 2 * warp + 1 : 7;

    // S = C_t B_s^T: 16 rows x 64 sources a warp; kf = {b0, b1} of source tiles 2 np, 2 np + 1
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned cf[4];
      ldmatrix_x4(cf, ca + kk * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (2 * np > jmax) continue;  // warp-uniform
        unsigned kf[4];
        ldmatrix_x4(kf, bt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kRS + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], cf, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], cf, kf[2], kf[3]);
      }
    }
    // P = S e^{Lc_t-Lc_s} dt_s, on and below the diagonal only.  Below it
    // every t is past the tile's last source e, so the decay factors into
    // e^{Lc_t-Lc_e} (a row's) times wt_s = e^{Lc_e-Lc_s} dt_s (from pass 1),
    // both at most 1; on it, an exponent per score, none above the diagonal
    if (diag) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j > jmax) continue;  // warp-uniform: never read
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int sl = 8 * j + 2 * (lane % 4) + (e & 1), tl = tl0 + 8 * (e >> 1);
          s[j][e] = sl > tl ? 0.f : s[j][e] * __expf(lt[e >> 1] - lcs[sl]) * dts[sl];
        }
      }
    } else {
      const float rf[2] = {__expf(lt[0] - lcs[kT - 1]), __expf(lt[1] - lcs[kT - 1])};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= rf[e >> 1] * wts[8 * j + 2 * (lane % 4) + (e & 1)];
    }
    // acc += P x_s: score tiles 2 kk, 2 kk + 1 are the A fragment of sources 16 kk ..
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (2 * kk > jmax) continue;  // warp-uniform: every P of these sources is 0
      const unsigned a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        unsigned vf[4];
        ldmatrix_x4_trans(vf, xt + (kk * 16 + (lane & 15)) * kRS + dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], a, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], a, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();

  // y = acc + D x_t, rounded once; x_t is the diagonal tile's x, still in its ring stage
  const bf16* xt = ring + (ti % kStages) * 2 * kTile + kTile;
  const float dsk = Dskip[h];
  bf16* yb = y + b * st.y_sb + h * st.y_sh + static_cast<int64_t>(c0 + t0) * st.y_ss;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int tl = tl0 + 8 * hr;
    if (t0 + tl >= nvalid) continue;
    bf16* yr = yb + static_cast<int64_t>(tl) * st.y_ss;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = 8 * j + 2 * (lane % 4);
      const float2 xv =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xt + tl * kRS + p));
      *reinterpret_cast<unsigned*>(yr + p) =
          pack_bf16(acc[j][2 * hr] + dsk * xv.x, acc[j][2 * hr + 1] + dsk * xv.y);
    }
  }
}

int launch_tc(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
              const float* Dskip, const float* h0, void* y, float* hN, const Work& ws,
              const Dims& D, const Strides& st, cudaStream_t stream) {
  const bf16* xt = static_cast<const bf16*>(x);
  const bf16* bt = static_cast<const bf16*>(Bm);
  cudaError_t err = allow_smem_once<chunk_state_tc>(kStateSmem);
  if (err != cudaSuccess) return err;
  chunk_state_tc<<<dim3(D.nc, D.H, D.B), kThreads, kStateSmem, stream>>>(xt, dt, A, bt, ws, D, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_states<<<dim3(kT * kT / (4 * kCombineThreads), D.B * D.H), kCombineThreads, 0,
                   stream>>>(h0, hN, ws, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = allow_smem_once<output_tc>(kOutSmem);
  if (err != cudaSuccess) return err;
  output_tc<<<dim3(D.H, D.B, D.nc * (D.Lp / kT)), kOutThreads, kOutSmem, stream>>>(
      xt, bt, static_cast<const bf16*>(Cm), Dskip, h0 != nullptr, static_cast<bf16*>(y), ws, D,
      st);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ham

// x/y (B, S, H, P), Bm/Cm (B, S, G, N) in one dtype, dt (B, S, H) float32:
// element strides of the three outer dims (x, Bm, Cm, y: unit last dim).
// A, Dskip (H,) float32; h0 and hN (B, H, N, P) float32 and contiguous, h0
// read when has_state.  Takes N = P = 64, H % G == 0 and 1 <= L <= 256;
// chunks of L positions from 0, the last one masked at S.  tc selects the
// tensor-core route (bf16); its scratch, allocated by the caller (float32
// unless said; not read on the other route): lc, dt and wt B*H*nc*Lp each,
// dh B*H*nc*N*P, hs B*H*nc*N*P bf16, where nc = ceil(S/L) and Lp = L rounded
// up to 64.  Returns 0 or the launch error.
extern "C" int ham_ssd_chunked(
    const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
    const float* Dskip, const float* h0, void* y, float* hN, float* ws_lc, float* ws_dt,
    float* ws_wt, float* ws_dh, void* ws_hs,
    int B, int S, int H, int G, int N, int P, int L, int has_state, int dtype, int tc,
    long long x_sb, long long x_ss, long long x_sh, long long d_sb, long long d_ss,
    long long d_sh, long long b_sb, long long b_ss, long long b_sg, long long c_sb,
    long long c_ss, long long c_sg, long long y_sb, long long y_ss, long long y_sh,
    int device, void* stream) {
  if (N != ham::kT || P != ham::kT || L < 1 || L > ham::kMaxL || G < 1 || H % G)
    return ham::kUnsupported;
  if (B == 0 || H == 0 || S == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const ham::Dims D{B, S, H, G, L, (S + L - 1) / L, (L + ham::kT - 1) / ham::kT * ham::kT};
  const ham::Strides st{x_sb, x_ss, x_sh, d_sb, d_ss, d_sh, b_sb, b_ss, b_sg,
                        c_sb, c_ss, c_sg, y_sb, y_ss, y_sh};
  const float* h = has_state ? h0 : nullptr;
  auto s = static_cast<cudaStream_t>(stream);
  if (tc) {
    if (dtype != ham::kBF16) return ham::kUnsupported;
    const ham::Work ws{ws_lc, ws_dt, ws_wt, ws_dh, static_cast<ham::bf16*>(ws_hs)};
    return ham::launch_tc(x, dt, A, Bm, Cm, Dskip, h, y, hN, ws, D, st, s);
  }
  switch (dtype) {
    case ham::kF32: return ham::launch<float>(x, dt, A, Bm, Cm, Dskip, h, y, hN, D, st, s);
    case ham::kBF16:
      return ham::launch<__nv_bfloat16>(x, dt, A, Bm, Cm, Dskip, h, y, hN, D, st, s);
    default: return ham::kUnsupported;
  }
}
