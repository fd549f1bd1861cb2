// Chunkwise-parallel mLSTM (exponential gating, max-stabilised) for Hopper
// (sm_90a), forward only.
//
// Replaces the Pallas TPU kernel repro/kernels/mlstm.py (_mlstm_kernel):
// per (sequence, head), chunks of L positions run in order carrying the
// matrix memory C (dk x dv), the normaliser n (dk) and the stabiliser m in
// float32; inside a chunk, with F = cumsum log sigmoid(f), a = i - F and
// g_t = max(m_prev, cummax_{s<=t} a_s),
//   h_t = (sum_{s<=t} (q_t.k_s) e^{a_s-g_t} v_s + e^{m_prev-g_t} q_t C_prev)
//         / max(|sum_{s<=t} (q_t.k_s) e^{a_s-g_t} + e^{m_prev-g_t} q_t.n_prev|, e^{-(F_t+g_t)})
//   C_next = e^{m_prev-g_L} C_prev + sum_s e^{a_s-g_L} k_s v_s^T  (n likewise),
//   m_next = F_L + g_L.
//
// Bound on an H100: operations (xlstm-1.3b's prefill of 1024 tokens over 4
// heads of dk 512, dv 1024 needs 10.2 GFLOP, the score products on and
// below the diagonal only, on ~34 MB).  The TPU kernel keeps C (2 MB at these widths) in VMEM
// for the whole chunk loop, one grid row per (sequence, head): on this card
// C does not fit in a block's 227 KB, and B*H = 4 blocks would leave 128 of
// 132 SMs idle.  Two routes share the gate prologue:
//  1. gates: one block per (sequence, head) runs the O(S) scalar prologue
//     (block-wide scans for the cumsum and the cummax, the m chain across
//     chunks) and stores a, g, e^{m_prev-g}, e^{-m_t} per position and
//     m_prev, g_L per chunk.
// Tensor-core route (bf16, dk 256 or 512, dv a multiple of 256), two more
// launches, mma.sync m16n8k16 with float32 accumulators:
//  2. state_tc: one block per (bh, 128-row dk tile, 128-column dv tile)
//     forms each chunk's dC = k^T (e^{a-g_L} v) on the tensor cores and
//     combines the chunks in order, C = e^{m_prev-g_L} C + dC, in float32
//     registers; it stores C and n at every chunk start (C as bf16: the
//     operand the next pass multiplies by);
//  3. output_tc: one block per (bh, 64-position tile of a chunk, 256-column
//     dv tile), heaviest first, forms q C_prev, the decay-weighted causal
//     scores and P V flash-style: no score tile goes to device memory.
// CUDA-core route (float32, and bf16 at other widths), the first port's:
//  2. state: one block per (bh, 64-row dk tile, 64-column dv tile) walks the
//     chunks in order with its tile of C in registers, storing the state at
//     the start of every chunk to a float32 scratch (bh, chunk, dk, dv);
//     the dv-tile-0 blocks carry n;
//  3. scores: one block per (bh, chunk, lower-triangular 64x64 tile) stores
//     the decay-weighted, causally masked score tile P^T = (k.q) e^{a_s-g_t};
//  4. output: one block per (bh, chunk, 64-position tile, 64-column dv tile)
//     forms h from P^T V, q C_prev and the two denominator terms.
// Any S is taken: positions from S up to the chunk grid's end are masked
// (q/k/v read as 0, log-forget 0, input gate -inf, no h written), so a
// ragged last chunk is exact and the chunk never shrinks to divide S.
// q is scaled by 1/sqrt(dk) and rounded to the input type before the
// products, as the model's chunked form does.  The CUDA-core route runs its
// products in float32 (the Pallas kernel also upcast).
#include <type_traits>

#include "common.cuh"

namespace ham {
namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kT = 64;         // tile edge (positions, dk rows, dv columns)
constexpr int kK = 32;         // depth of one shared-memory step
constexpr int kNT = kK + 4;    // row stride of a [64][kK] tile: conflict-free float4 rows
constexpr float kInf = __builtin_huge_valf();

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// x rounded to T (a no-op for float), as a product computed in T would be
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

struct Sum {
  __device__ float operator()(float a, float b) const { return a + b; }
};
struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// Inclusive scan of x across the block's 256 threads in thread order.
template <typename Op>
__device__ float block_scan(float x, float ident, Op op, float* tot /* [8] */) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = op(y, x);
  }
  if (lane == 31) tot[w] = x;
  __syncthreads();
  if (w == 0) {
    float t = lane < 8 ? tot[lane] : ident;
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t = op(y, t);
    }
    if (lane < 8) tot[lane] = t;
  }
  __syncthreads();
  if (w > 0) x = op(tot[w - 1], x);
  __syncthreads();  // tot is reused by the next scan
  return x;
}

struct Dims {
  int B, H, S, dk, dv, L, nc, Lp;  // Lp: L rounded up to the tile edge
};

// Per-position gate values, (bh, chunk, Lp) each, and per-chunk scalars.
struct GateBufs {
  float *a, *g, *sc, *em;  // a_s; g_t; e^{m_prev-g_t}; e^{-(F_t+g_t)}
  float *mp, *gl;          // (bh, nc+1) m at each chunk start (last: final m); (bh, nc) g_L
};

// ---- pass 1: gates ---------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
gates_kernel(const T* __restrict__ ig, const T* __restrict__ fg, const float* __restrict__ m0,
             float* __restrict__ m_out, GateBufs gb, Dims D, int64_t i_sb, int64_t i_sh,
             int64_t i_ss, int64_t f_sb, int64_t f_sh, int64_t f_ss) {
  __shared__ float tot[8];
  __shared__ float carry[2];
  const int bh = blockIdx.x, b = bh / D.H, h = bh % D.H, tid = threadIdx.x;
  const T* ib = ig + b * i_sb + h * i_sh;
  const T* fb = fg + b * f_sb + h * f_sh;
  float m = m0 ? m0[bh] : -kInf;
  for (int c = 0; c < D.nc; ++c) {
    const int64_t row = (static_cast<int64_t>(bh) * D.nc + c) * D.Lp;
    float carry_f = 0.f, carry_m = -kInf;
    for (int s0 = 0; s0 < D.Lp; s0 += kThreads) {
      const int tl = s0 + tid, p = c * D.L + tl;
      const bool valid = tl < D.L && p < D.S;
      const float flog = valid ? log_sigmoid(ldf(fb + p * f_ss)) : 0.f;
      const float iv = valid ? ldf(ib + p * i_ss) : -kInf;
      const float F = carry_f + block_scan(flog, 0.f, Sum(), tot);
      const float a = iv - F;
      const float cm = fmaxf(carry_m, block_scan(a, -kInf, Max(), tot));
      const float g = fmaxf(m, cm);
      if (tl < D.Lp) {
        gb.a[row + tl] = a;
        gb.g[row + tl] = g;
        gb.sc[row + tl] = expf(m - g);
        gb.em[row + tl] = expf(-(F + g));
      }
      if (tid == kThreads - 1) {
        carry[0] = F;
        carry[1] = cm;
      }
      __syncthreads();
      carry_f = carry[0];
      carry_m = carry[1];
      __syncthreads();
    }
    // masked positions leave F and the cummax unchanged, so the carries are
    // F_L and cummax a at the chunk's last position
    const float gl = fmaxf(m, carry_m);
    if (tid == 0) {
      gb.mp[bh * (D.nc + 1) + c] = m;
      gb.gl[bh * D.nc + c] = gl;
    }
    m = carry_f + gl;
  }
  if (tid == 0) {
    gb.mp[bh * (D.nc + 1) + D.nc] = m;
    m_out[bh] = m;
  }
}

// ---- pass 2: state at the start of every chunk -----------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
state_kernel(const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ C0,
             const float* __restrict__ n0, float* __restrict__ C_out, float* __restrict__ n_out,
             float* __restrict__ Cs, float* __restrict__ Ns, GateBufs gb, Dims D,
             int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
             int64_t v_ss) {
  __shared__ __align__(16) float ks[kK][kT];  // decay-weighted k: [s][dk row]
  __shared__ __align__(16) float vs[kK][kT];  // v: [s][dv column]
  __shared__ float dec[kK];
  const int bh = blockIdx.z, b = bh / D.H, h = bh % D.H;
  const int r0 = blockIdx.y * kT, c0 = blockIdx.x * kT;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const bool carry_n = blockIdx.x == 0;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const int64_t cbase = static_cast<int64_t>(bh) * D.dk * D.dv;

  float C[4][4], nv = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = r0 + ty * 4 + r, j = c0 + tx * 4 + c;
      C[r][c] = (C0 && i < D.dk && j < D.dv) ? C0[cbase + static_cast<int64_t>(i) * D.dv + j] : 0.f;
    }
  if (carry_n && tid < kT && n0 && r0 + tid < D.dk) nv = n0[bh * D.dk + r0 + tid];

  for (int ch = 0; ch < D.nc; ++ch) {
    float* cs = Cs + (static_cast<int64_t>(bh) * D.nc + ch) * D.dk * D.dv;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = r0 + ty * 4 + r, j = c0 + tx * 4 + c;
        if (i < D.dk && j < D.dv) cs[static_cast<int64_t>(i) * D.dv + j] = C[r][c];
      }
    if (carry_n && tid < kT && r0 + tid < D.dk)
      Ns[(static_cast<int64_t>(bh) * D.nc + ch) * D.dk + r0 + tid] = nv;

    const float gl = gb.gl[bh * D.nc + ch];
    const float fdec = expf(gb.mp[bh * (D.nc + 1) + ch] - gl);
    const float* arow = gb.a + (static_cast<int64_t>(bh) * D.nc + ch) * D.Lp;
    float U[4][4] = {}, nu = 0.f;
    const int s_end = min(D.L, D.S - ch * D.L);  // valid positions of this chunk
    for (int s0 = 0; s0 < s_end; s0 += kK) {
      __syncthreads();  // the previous step's tiles are consumed
      if (tid < kK) dec[tid] = s0 + tid < s_end ? expf(arow[s0 + tid] - gl) : 0.f;
      __syncthreads();
      for (int idx = tid; idx < kK * kT; idx += kThreads) {
        const int s = idx / kT, col = idx % kT, p = ch * D.L + s0 + s;
        const bool ok = s0 + s < s_end;
        ks[s][col] = (ok && r0 + col < D.dk) ? ldf(kb + p * k_ss + r0 + col) * dec[s] : 0.f;
        vs[s][col] = (ok && c0 + col < D.dv) ? ldf(vb + p * v_ss + c0 + col) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int s = 0; s < kK; ++s) {
        const float4 a = *reinterpret_cast<const float4*>(&ks[s][ty * 4]);
        const float4 w = *reinterpret_cast<const float4*>(&vs[s][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w}, wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) U[r][c] += av[r] * wv[c];
      }
      if (carry_n && tid < kT)
        for (int s = 0; s < kK; ++s) nu += ks[s][tid];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) C[r][c] = fdec * C[r][c] + U[r][c];
    nv = fdec * nv + nu;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = r0 + ty * 4 + r, j = c0 + tx * 4 + c;
      if (i < D.dk && j < D.dv) C_out[cbase + static_cast<int64_t>(i) * D.dv + j] = C[r][c];
    }
  if (carry_n && tid < kT && r0 + tid < D.dk) n_out[bh * D.dk + r0 + tid] = nv;
}

// ---- pass 3: decay-weighted causal scores ----------------------------------

// Load rows [row0, row0 + 64) x depth [d0, d0 + kK) of a (rows, depth) matrix
// into dst[64][kNT] as float * scale rounded to T; rows at or past
// rows_valid and depth at or past depth are 0.
template <typename T>
__device__ __forceinline__ void load_rows(float (*dst)[kNT], const T* src, int64_t row_stride,
                                          int row0, int rows_valid, int d0, int depth,
                                          float scale, bool rescale, int tid) {
  for (int idx = tid; idx < kT * kK; idx += kThreads) {
    const int r = idx / kK, d = idx % kK;
    float x = 0.f;
    if (row0 + r < rows_valid && d0 + d < depth) {
      x = ldf(src + static_cast<int64_t>(row0 + r) * row_stride + d0 + d);
      if (rescale) x = round_to(x / scale, src);
    }
    dst[r][d] = x;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scores_kernel(const T* __restrict__ q, const T* __restrict__ k, float* __restrict__ P,
              GateBufs gb, Dims D, int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
              int64_t k_sh, int64_t k_ss) {
  __shared__ __align__(16) float kt[kT][kNT];  // rows: s
  __shared__ __align__(16) float qt[kT][kNT];  // rows: t
  const int bh = blockIdx.z, b = bh / D.H, h = bh % D.H, ch = blockIdx.y;
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= static_cast<int>(blockIdx.x)) ++ti;
  const int si = blockIdx.x - ti * (ti + 1) / 2;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int base = ch * D.L;  // position of the chunk's first row
  // valid rows of this chunk: local index < min(L, S - base)
  const int nvalid = min(D.L, D.S - base);
  const T* qb = q + b * q_sb + h * q_sh + static_cast<int64_t>(base) * q_ss;
  const T* kb = k + b * k_sb + h * k_sh + static_cast<int64_t>(base) * k_ss;
  const float sq = sqrtf(static_cast<float>(D.dk));

  float acc[4][4] = {};  // acc[r][c]: s = si*64 + ty + 16r, t = ti*64 + tx + 16c
  for (int d0 = 0; d0 < D.dk; d0 += kK) {
    __syncthreads();
    load_rows(kt, kb, k_ss, si * kT, nvalid, d0, D.dk, 1.f, false, tid);
    load_rows(qt, qb, q_ss, ti * kT, nvalid, d0, D.dk, sq, true, tid);
    __syncthreads();
#pragma unroll
    for (int d = 0; d < kK; d += 4) {
      float4 ka[4], qa[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) ka[r] = *reinterpret_cast<const float4*>(&kt[ty + 16 * r][d]);
#pragma unroll
      for (int c = 0; c < 4; ++c) qa[c] = *reinterpret_cast<const float4*>(&qt[tx + 16 * c][d]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] += ka[r].x * qa[c].x + ka[r].y * qa[c].y + ka[r].z * qa[c].z + ka[r].w * qa[c].w;
    }
  }
  const int64_t row = (static_cast<int64_t>(bh) * D.nc + ch) * D.Lp;
  float* pt = P + row * D.Lp;  // P^T of this chunk: [s][t]
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int s = si * kT + ty + 16 * r;
    const float as = gb.a[row + s];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int t = ti * kT + tx + 16 * c;
      const bool ok = s <= t && s < nvalid && t < nvalid;
      pt[static_cast<int64_t>(s) * D.Lp + t] = ok ? acc[r][c] * expf(as - gb.g[row + t]) : 0.f;
    }
  }
}

// ---- pass 4: output --------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
output_kernel(const T* __restrict__ q, const T* __restrict__ v, const float* __restrict__ P,
              const float* __restrict__ Cs, const float* __restrict__ Ns, T* __restrict__ hout,
              GateBufs gb, Dims D, int has_state, int64_t q_sb, int64_t q_sh, int64_t q_ss,
              int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t h_sb, int64_t h_sh,
              int64_t h_ss) {
  __shared__ __align__(16) float at[kK][kT + 4];  // P^T rows, then q^T rows: [depth][t]
  __shared__ __align__(16) float bt[kK][kT];      // v rows, then C_prev rows: [depth][dv col]
  __shared__ float ns[kK];
  const int bh = blockIdx.z, b = bh / D.H, h = bh % D.H;
  const int nt = D.Lp / kT, ch = blockIdx.y / nt, ti = blockIdx.y % nt;
  const int c0 = blockIdx.x * kT;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int base = ch * D.L, nvalid = min(D.L, D.S - base);
  if (ti * kT >= nvalid) return;  // a tile of masked positions only
  const int64_t row = (static_cast<int64_t>(bh) * D.nc + ch) * D.Lp;
  const float* pt = P + row * D.Lp;
  const T* vb = v + b * v_sb + h * v_sh + static_cast<int64_t>(base) * v_ss;
  const T* qb = q + b * q_sb + h * q_sh + static_cast<int64_t>(base) * q_ss;

  // num_intra[r][c] = sum_s P[t][s] v[s][j], t = ti*64 + ty*4 + r, j = c0 + tx*4 + c
  float num[4][4] = {}, inter[4][4] = {}, den[4] = {}, qn[4] = {};
  for (int s0 = 0; s0 < (ti + 1) * kT; s0 += kK) {
    __syncthreads();
    for (int idx = tid; idx < kK * kT; idx += kThreads) {
      const int s = idx / kT, col = idx % kT;
      at[s][col] = pt[static_cast<int64_t>(s0 + s) * D.Lp + ti * kT + col];
      bt[s][col] = (s0 + s < nvalid && c0 + col < D.dv)
                       ? ldf(vb + static_cast<int64_t>(s0 + s) * v_ss + c0 + col) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int s = 0; s < kK; ++s) {
      const float4 a = *reinterpret_cast<const float4*>(&at[s][ty * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&bt[s][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) num[r][c] += av[r] * wv[c];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) den[r] += at[2 * tx][ty * 4 + r] + at[2 * tx + 1][ty * 4 + r];
  }

  // inter[r][c] = sum_d q[t][d] C_prev[d][j];  qn[r] = sum_d q[t][d] n_prev[d]
  if (has_state || ch > 0) {
    const float* cs = Cs + (static_cast<int64_t>(bh) * D.nc + ch) * D.dk * D.dv;
    const float* nsrc = Ns + (static_cast<int64_t>(bh) * D.nc + ch) * D.dk;
    const float sq = sqrtf(static_cast<float>(D.dk));
    for (int d0 = 0; d0 < D.dk; d0 += kK) {
      __syncthreads();
      for (int idx = tid; idx < kK * kT; idx += kThreads) {
        const int t = idx / kK, d = idx % kK;  // q read along d, stored transposed
        float x = 0.f;
        if (ti * kT + t < nvalid && d0 + d < D.dk)
          x = round_to(ldf(qb + static_cast<int64_t>(ti * kT + t) * q_ss + d0 + d) / sq, qb);
        at[d][t] = x;
        const int dd = idx / kT, col = idx % kT;
        bt[dd][col] = (d0 + dd < D.dk && c0 + col < D.dv)
                          ? cs[static_cast<int64_t>(d0 + dd) * D.dv + c0 + col] : 0.f;
      }
      if (tid < kK) ns[tid] = d0 + tid < D.dk ? nsrc[d0 + tid] : 0.f;
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < kK; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(&at[d][ty * 4]);
        const float4 w = *reinterpret_cast<const float4*>(&bt[d][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w}, wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) inter[r][c] += av[r] * wv[c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qn[r] += at[2 * tx][ty * 4 + r] * ns[2 * tx] + at[2 * tx + 1][ty * 4 + r] * ns[2 * tx + 1];
    }
  }

  // the 16 threads of a row (one half-warp) hold partial sums over depth
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      den[r] += __shfl_xor_sync(0xffffffffu, den[r], o);
      qn[r] += __shfl_xor_sync(0xffffffffu, qn[r], o);
    }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = ti * kT + ty * 4 + r;
    if (t >= nvalid) continue;
    const float sc = gb.sc[row + t];
    const float dn = fmaxf(fabsf(den[r] + sc * qn[r]), gb.em[row + t]);
    T* hrow = hout + b * h_sb + h * h_sh + static_cast<int64_t>(base + t) * h_ss;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = c0 + tx * 4 + c;
      if (j < D.dv) store(hrow + j, (num[r][c] + sc * inter[r][c]) / dn);
    }
  }
}

// ---- tensor-core route (bf16, dk 256 or 512, dv % 256 == 0) ---------------
// mma.sync m16n8k16 with float32 accumulators (common.cuh), every warp
// owning 16 rows of a tile: the fused pass packs P from the score
// accumulators straight into A fragments, as flash_attention.cu does, which
// wgmma's warpgroup-wide 64-row fragments would not allow without a trip
// through shared memory.

constexpr int kSt = 128;                 // the state pass: 128 x 128 tiles of C
constexpr int kStThreads = 256;          // 8 warps of 16 dk rows
constexpr int kStStages = 3;             // cp.async ring of k and v
constexpr int kSS = kSt + 8;             // bf16 row stride of a [64][kSt] tile
constexpr int kStTile = 64 * kSS;
constexpr size_t kStSmem = (2 * kStStages + 2) * kStTile * 2 + 2 * 64 * 4;
constexpr int kTcOutThreads = 256;       // the fused pass: 8 warps
constexpr int kTcStages = 3;             // cp.async ring of the fused pass
constexpr int kDvT = 256;                // dv columns of a fused-pass block
constexpr int kOS = kDvT + 8;            // bf16 row stride of a [64][kDvT] ring tile
constexpr int kOTile = 64 * kOS;         // one ring stage: 64 rows of k, C_prev or V
constexpr int kScoreK = kDvT;            // dk columns of k per score step (one ring stage)
constexpr int kPS = 64 + 8;              // bf16 row stride of the shared P tile
constexpr int kTcMaxDk = 512;            // the q rows of a block stay in shared memory

__device__ __forceinline__ float bf16_value(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// State pass: one block of 8 warps per (128-column dv tile, 128-row dk
// tile, bh) walks the chunks in order with its tile of C (float32) in the
// mma accumulator layout; warp w holds the 64 x 32 sub-tile at dk row
// 64 (w / 4), dv column 32 (w % 4), so a k16 step loads 4 A and 4 B
// fragments for 32 products.  Per chunk:
// store C_prev, rounded to bf16, for the fused pass (the operand it
// multiplies q by); form dC = k^T (e^{a-g_L} v) on the tensor cores over
// 64-position steps, k through ldmatrix.trans as the A operand, the
// decay-weighted v split into bf16 hi + lo parts (two products: one bf16
// rounding of it misses the state tolerance, see PERF.md); then C =
// e^{m_prev-g_L} C + dC.  k and v stream through a 3-stage cp.async ring;
// each thread forms hi and lo from the v vectors it loaded.  The dv-tile-0
// blocks carry n on the CUDA cores in float32.  The walk keeps the chunks'
// updates in registers: at an xLSTM admission (B*H = 4, dk 512, dv 1024)
// its 128 blocks already give every SM one, and a chunk-parallel grid (a
// block per tile and chunk, the updates stored in float32 for an in-order
// combine pass) measured slower before that pass (PERF.md).
__global__ void __launch_bounds__(kStThreads, 1)
state_tc(const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
         const float* __restrict__ C0, const float* __restrict__ n0, float* __restrict__ C_out,
         float* __restrict__ n_out, __nv_bfloat16* __restrict__ Cs, float* __restrict__ Ns,
         GateBufs gb, Dims D, int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb,
         int64_t v_sh, int64_t v_ss) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kr = reinterpret_cast<T*>(smem_raw);   // [stage][position][dk row]
  T* vr = kr + kStStages * kStTile;          // [stage][position][dv column], as loaded
  T* vh = vr + kStStages * kStTile;          // decay-weighted v, bf16 hi
  T* vl = vh + kStTile;                      // ... and the bf16 rest
  float* dec = reinterpret_cast<float*>(vl + kStTile);  // [2][position]
  const int bh = blockIdx.z, b = bh / D.H, h = bh % D.H;
  const int r0 = blockIdx.y * kSt, c0 = blockIdx.x * kSt;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool carry_n = blockIdx.x == 0;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const int64_t cbase = static_cast<int64_t>(bh) * D.dk * D.dv;
  // fragment (mt, nt, i): dk row fr + 16 mt + 8 (i / 2), dv column
  // fc + 8 nt + i % 2
  const int wm = warp / 4, wn = warp % 4;
  const int fr = r0 + wm * 64 + lane / 4, fc = c0 + wn * 32 + 2 * (lane % 4);
  // 64-position steps: every chunk but the last has Ls of them
  const int Ls = (D.L + 63) / 64;
  const int nsteps = (D.nc - 1) * Ls + (D.S - (D.nc - 1) * D.L + 63) / 64;

  auto load = [&](int i) {
    const int ch = i / Ls, s0 = (i % Ls) * 64, s_end = min(D.L, D.S - ch * D.L);
    T* kd = kr + (i % kStStages) * kStTile;
    T* vd = vr + (i % kStStages) * kStTile;
    for (int idx = tid; idx < 64 * (kSt / 8); idx += kStThreads) {
      const int s = idx / (kSt / 8), col = (idx % (kSt / 8)) * 8;
      const bool ok = s0 + s < s_end;
      const int64_t p = ch * D.L + s0 + s;
      cp_async16(kd + s * kSS + col, ok ? kb + p * k_ss + r0 + col : kb, ok ? 16 : 0);
      cp_async16(vd + s * kSS + col, ok ? vb + p * v_ss + c0 + col : vb, ok ? 16 : 0);
    }
  };

  float C[4][4][4], U[4][4][4], nv = 0.f, nu = 0.f;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        C[mt][nt][i] = C0 ? C0[cbase + static_cast<int64_t>(fr + 16 * mt + 8 * (i / 2)) * D.dv +
                               fc + 8 * nt + i % 2]
                          : 0.f;
        U[mt][nt][i] = 0.f;
      }
  if (carry_n && tid < kSt && n0) nv = n0[bh * D.dk + r0 + tid];

#pragma unroll
  for (int i = 0; i < kStStages - 1; ++i) {
    if (i < nsteps) load(i);
    cp_async_commit();
  }
  if (tid < 64) {  // step 0's decay weights
    const int end = min(D.L, D.S);
    dec[tid] = tid < end ? expf(gb.a[static_cast<int64_t>(bh) * D.nc * D.Lp + tid] - gb.gl[bh * D.nc])
                         : 0.f;
  }
  for (int i = 0; i < nsteps; ++i) {
    const int ch = i / Ls, s0 = (i % Ls) * 64, s_end = min(D.L, D.S - ch * D.L);
    const float gl = gb.gl[bh * D.nc + ch];
    __syncthreads();                 // step i - 1 is consumed
    float a_next = 0.f, gl_next = 0.f;  // the next step's decay inputs, loaded early
    bool next_ok = false;
    if (tid < 64 && i + 1 < nsteps) {
      const int nch = (i + 1) / Ls, ns0 = ((i + 1) % Ls) * 64;
      next_ok = ns0 + tid < min(D.L, D.S - nch * D.L);
      if (next_ok) {
        a_next = gb.a[(static_cast<int64_t>(bh) * D.nc + nch) * D.Lp + ns0 + tid];
        gl_next = gb.gl[bh * D.nc + nch];
      }
    }
    if (i + kStStages - 1 < nsteps) load(i + kStStages - 1);
    cp_async_commit();
    cp_async_wait<kStStages - 1>();  // step i has landed (this thread's copies)
    const T* kd = kr + (i % kStStages) * kStTile;
    const T* vd = vr + (i % kStStages) * kStTile;
    const float* dw = dec + (i % 2) * 64;  // e^{a_s-g_L} of this step, formed a step ahead
    for (int idx = tid; idx < 64 * (kSt / 8); idx += kStThreads) {
      const int s = idx / (kSt / 8), col = (idx % (kSt / 8)) * 8;
      const float w = dw[s];
      float f[8];
      Vec<T>::to_float(*reinterpret_cast<const uint4*>(vd + s * kSS + col), f);
      unsigned hi[4], lo[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float x0 = f[2 * u] * w, x1 = f[2 * u + 1] * w;
        const float h0 = bf16_value(x0), h1 = bf16_value(x1);
        hi[u] = pack_bf16(h0, h1);
        lo[u] = pack_bf16(x0 - h0, x1 - h1);
      }
      *reinterpret_cast<uint4*>(vh + s * kSS + col) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(vl + s * kSS + col) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    if (tid < 64 && i + 1 < nsteps)  // the next step's decay weights
      dec[((i + 1) % 2) * 64 + tid] = next_ok ? expf(a_next - gl_next) : 0.f;
    if (s0 == 0) {                   // the chunk's first step: C_prev and n_prev for the fused pass
      T* cs = Cs + (static_cast<int64_t>(bh) * D.nc + ch) * D.dk * D.dv;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
            *reinterpret_cast<unsigned*>(cs + static_cast<int64_t>(fr + 16 * mt + 8 * hr) * D.dv +
                                         fc + 8 * nt) =
                pack_bf16(C[mt][nt][2 * hr], C[mt][nt][2 * hr + 1]);
      if (carry_n && tid < kSt) Ns[(static_cast<int64_t>(bh) * D.nc + ch) * D.dk + r0 + tid] = nv;
    }
    __syncthreads();                 // hi, lo, dec and every thread's copies are visible
#pragma unroll
    for (int kk = 0; kk < 64; kk += 16) {
      unsigned a[4][4], bhi[2][4], blo[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4_trans(a[mt], kd + (kk + (lane & 7) + ((lane >> 4) << 3)) * kSS + wm * 64 +
                                     mt * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        ldmatrix_x4_trans(bhi[jj], vh + (kk + (lane & 15)) * kSS + wn * 32 + jj * 16 + (lane >> 4) * 8);
        ldmatrix_x4_trans(blo[jj], vl + (kk + (lane & 15)) * kSS + wn * 32 + jj * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_bf16(U[mt][nt], a[mt], bhi[nt / 2][2 * (nt % 2)], bhi[nt / 2][2 * (nt % 2) + 1]);
          mma_bf16(U[mt][nt], a[mt], blo[nt / 2][2 * (nt % 2)], blo[nt / 2][2 * (nt % 2) + 1]);
        }
    }
    if (carry_n && tid < kSt)
      for (int s = 0; s < 64; ++s) nu += __bfloat162float(kd[s * kSS + tid]) * dw[s];
    if (s0 + 64 >= s_end) {          // the chunk's last step: C = e^{m_prev-g_L} C + dC
      const float fdec = expf(gb.mp[bh * (D.nc + 1) + ch] - gl);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            C[mt][nt][e] = fdec * C[mt][nt][e] + U[mt][nt][e];
            U[mt][nt][e] = 0.f;
          }
      nv = fdec * nv + nu;
      nu = 0.f;
    }
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        C_out[cbase + static_cast<int64_t>(fr + 16 * mt + 8 * (i / 2)) * D.dv + fc + 8 * nt + i % 2] =
            C[mt][nt][i];
  if (carry_n && tid < kSt) n_out[bh * D.dk + r0 + tid] = nv;
}

// Fused scores + output pass, flash-style: one block of 8 warps per
// (256-column dv tile, bh, 64-position tile of a chunk), the tiles with the
// most key tiles launched first (a tile of chunk c > 0 also carries the q
// C_prev term, so those lead among tiles of one row); warp w takes rows
// 32 (w / 4) .. + 31 and dv columns 64 (w % 4) .. + 63 of the tile, so a
// k16 step loads 2 A and 4 B fragments for 16 products.  The
// block's q rows (64 x dk) stay in shared memory for the whole pass,
// divided by sqrt(dk) (as a product with its reciprocal) and rounded to
// bf16 once; a 3-stage cp.async ring streams the other operands.  acc =
// q C_prev (C_prev from the state pass, bf16) scaled by e^{m_prev-g_t};
// then for each key tile on or below the diagonal, S = q k^T on the tensor
// cores, each of the 4 warps of a row half forming 16 of the 64 keys from
// the shared k chunks, P = S e^{a_s-g_t} (causal, ragged tail masked) on
// the accumulator fragments, the quarters meeting as bf16 in a 64 x 64
// shared-memory tile that the warps read back as A fragments, and acc +=
// P V.  No score tile goes to device memory.
__global__ void __launch_bounds__(kTcOutThreads, 1)
output_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ Cs,
          const float* __restrict__ Ns, __nv_bfloat16* __restrict__ hout, GateBufs gb, Dims D,
          int has_state, int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
          int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t h_sb, int64_t h_sh,
          int64_t h_ss) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int QS = D.dk + 8;                                 // bf16 row stride of the q rows
  T* qs = reinterpret_cast<T*>(smem_raw);                  // [64][QS]
  T* ring = qs + 64 * QS;                                  // [stage][64][kOS]
  float* qn_s = reinterpret_cast<float*>(ring + kTcStages * kOTile);  // q . n_prev per row
  float* ns = qn_s + 64;                                   // n_prev [dk]
  float* den_s = ns + D.dk;                                // [4][64] denominator quarters
  T* ps = reinterpret_cast<T*>(den_s + 4 * 64);            // P of the key tile, [64][kPS]
  const int bh = blockIdx.y, b = bh / D.H, h = bh % D.H;
  const int nt = D.Lp / 64, ti = nt - 1 - static_cast<int>(blockIdx.z) / D.nc;
  const int ch = (static_cast<int>(blockIdx.z) % D.nc + 1) % D.nc;
  const int t0 = ti * 64;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int dv0 = blockIdx.x * kDvT + wn * 64;             // this warp's dv columns
  const int base = ch * D.L, nvalid = min(D.L, D.S - base);
  if (t0 >= nvalid) return;  // a tile of masked positions only
  const int64_t row = (static_cast<int64_t>(bh) * D.nc + ch) * D.Lp;
  const T* qb = q + b * q_sb + h * q_sh + static_cast<int64_t>(base + t0) * q_ss;
  const T* kb = k + b * k_sb + h * k_sh + static_cast<int64_t>(base) * k_ss;
  const T* vb = v + b * v_sb + h * v_sh + static_cast<int64_t>(base) * v_ss;
  const T* cs = Cs + (static_cast<int64_t>(bh) * D.nc + ch) * D.dk * D.dv + blockIdx.x * kDvT;
  const bool has_prev = has_state || ch > 0;
  const int nk = D.dk / 64, qv = 64 * (D.dk / 8);          // q vectors of the block
  const int nks = D.dk / kScoreK;                          // score steps per key tile
  const int n_inter = has_prev ? nk : 0;
  const int nsteps = n_inter + (ti + 1) * (nks + 1);

  // step i: inter steps (C_prev rows 64 c ..), then per key tile j: nks
  // score steps (k columns kScoreK c ..) and one V step
  auto decode = [&](int i, int& kind, int& j, int& c) {
    if (i < n_inter) { kind = 0; j = 0; c = i; return; }
    i -= n_inter;
    j = i / (nks + 1);
    c = i % (nks + 1);
    kind = c == nks ? 2 : 1;
  };
  auto load_step = [&](int i) {
    int kind, j, c;
    decode(i, kind, j, c);
    T* bd = ring + (i % kTcStages) * kOTile;
    if (kind == 1) {         // keys 64 j .. 64 j + 63, dk kScoreK c .. + kScoreK - 1
      for (int idx = tid; idx < 64 * (kScoreK / 8); idx += kTcOutThreads) {
        const int r = idx / (kScoreK / 8), col = (idx % (kScoreK / 8)) * 8;
        const bool ok = j * 64 + r < nvalid;
        cp_async16(bd + r * kOS + col,
                   ok ? kb + static_cast<int64_t>(j * 64 + r) * k_ss + c * kScoreK + col : kb,
                   ok ? 16 : 0);
      }
    } else {                 // C_prev rows 64 c .., or the V rows of key tile j: 64 x 256
      for (int idx = tid; idx < 64 * (kDvT / 8); idx += kTcOutThreads) {
        const int r = idx / (kDvT / 8), col = (idx % (kDvT / 8)) * 8;
        if (kind == 0) {
          cp_async16(bd + r * kOS + col, cs + static_cast<int64_t>(c * 64 + r) * D.dv + col, 16);
        } else {
          const bool ok = j * 64 + r < nvalid;
          cp_async16(bd + r * kOS + col,
                     ok ? vb + static_cast<int64_t>(j * 64 + r) * v_ss + blockIdx.x * kDvT + col : vb,
                     ok ? 16 : 0);
        }
      }
    }
  };

  // this thread's rows: t0 + 32 wm + 16 mt + lane / 4 + 8 hr
  const int tr0 = t0 + wm * 32 + lane / 4;
  float gt[2][2], sct[2][2], emt[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = tr0 + 16 * mt + 8 * hr;
      gt[mt][hr] = gb.g[row + t];
      sct[mt][hr] = gb.sc[row + t];
      emt[mt][hr] = gb.em[row + t];
    }
  float acc[2][8][4], s[2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;
  float den[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float ak[2][2];  // a_s of this thread's keys of the current key tile, loaded early

  // group 0: the q rows and step 0; group 1: step 1
  for (int idx = tid; idx < qv; idx += kTcOutThreads) {
    const int r = idx / (D.dk / 8), col = (idx % (D.dk / 8)) * 8;
    const bool ok = t0 + r < nvalid;
    cp_async16(qs + r * QS + col, ok ? qb + static_cast<int64_t>(r) * q_ss + col : qb, ok ? 16 : 0);
  }
  if (has_prev)
    for (int idx = tid; idx < D.dk / 4; idx += kTcOutThreads)
      cp_async16(ns + 4 * idx, Ns + (static_cast<int64_t>(bh) * D.nc + ch) * D.dk + 4 * idx, 16);
#pragma unroll
  for (int i = 0; i < kTcStages - 1; ++i) {
    if (i < nsteps) load_step(i);
    cp_async_commit();
  }
  for (int i = 0; i < nsteps; ++i) {
    int kind, j, c;
    decode(i, kind, j, c);
    cp_async_wait<kTcStages - 2>();  // step i (and, at i = 0, q) has landed
    if (i == 0) {                    // q / sqrt(dk), rounded to bf16, in place
      const float rsq = 1.f / sqrtf(static_cast<float>(D.dk));
      for (int idx = tid; idx < qv; idx += kTcOutThreads) {
        uint4* p = reinterpret_cast<uint4*>(qs + (idx / (D.dk / 8)) * QS + (idx % (D.dk / 8)) * 8);
        float f[8];
        Vec<T>::to_float(*p, f);
        *p = make_uint4(pack_bf16(f[0] * rsq, f[1] * rsq), pack_bf16(f[2] * rsq, f[3] * rsq),
                        pack_bf16(f[4] * rsq, f[5] * rsq), pack_bf16(f[6] * rsq, f[7] * rsq));
      }
    }
    __syncthreads();                 // ... for every thread, and step i - 1 is consumed
    if (i == 0) {                    // q . n_prev (float32 n): 4 lanes a row
      float sum = 0.f;
      if (has_prev) {
        const int part = D.dk / 4;
        const float* nr = ns + (tid % 4) * part;
        const T* qr = qs + (tid / 4) * QS + (tid % 4) * part;
        for (int d = 0; d < part; d += 8) {
          float f[8];
          Vec<T>::to_float(*reinterpret_cast<const uint4*>(qr + d), f);
          const float4 n0 = *reinterpret_cast<const float4*>(nr + d);
          const float4 n1 = *reinterpret_cast<const float4*>(nr + d + 4);
          sum += f[0] * n0.x + f[1] * n0.y + f[2] * n0.z + f[3] * n0.w + f[4] * n1.x +
                 f[5] * n1.y + f[6] * n1.z + f[7] * n1.w;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (tid % 4 == 0) qn_s[tid / 4] = sum;
    }
    if (i + kTcStages - 1 < nsteps) load_step(i + kTcStages - 1);
    cp_async_commit();
    const T* bd = ring + (i % kTcStages) * kOTile;
    const T* qa = qs + (wm * 32 + (lane & 15)) * QS + (lane >> 4) * 8;  // + 16 mt rows, dk

    if (kind == 0) {         // acc += q[:, 64 c ..] C_prev[64 c .., this warp's columns]
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        unsigned a[2][4], bf[4][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) ldmatrix_x4(a[mt], qa + mt * 16 * QS + c * 64 + kk * 16);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          ldmatrix_x4_trans(bf[jj], bd + (kk * 16 + (lane & 15)) * kOS + wn * 64 + jj * 16 +
                                        (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            mma_bf16(acc[mt][nt], a[mt], bf[nt / 2][2 * (nt % 2)], bf[nt / 2][2 * (nt % 2) + 1]);
      }
      if (c == nk - 1)       // the inter term is complete: scale its rows
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            acc[mt][nt][0] *= sct[mt][0];
            acc[mt][nt][1] *= sct[mt][0];
            acc[mt][nt][2] *= sct[mt][1];
            acc[mt][nt][3] *= sct[mt][1];
          }
    } else if (kind == 1) {  // s += q[:, kScoreK c ..] k_c^T, keys 16 wn .. 16 wn + 15
      if (c == 0) {
        const float* arow = gb.a + row + j * 64 + wn * 16 + 2 * (lane % 4);
#pragma unroll
        for (int jn = 0; jn < 2; ++jn) {
          ak[jn][0] = arow[jn * 8];
          ak[jn][1] = arow[jn * 8 + 1];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[mt][jn][e] = 0.f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < kScoreK / 16; ++kk) {
        unsigned a[2][4], kf[4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4(a[mt], qa + mt * 16 * QS + c * kScoreK + kk * 16);
        ldmatrix_x4(kf, bd + (wn * 16 + (lane & 7) + (lane >> 4) * 8) * kOS + kk * 16 +
                            ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(s[mt][0], a[mt], kf[0], kf[1]);
          mma_bf16(s[mt][1], a[mt], kf[2], kf[3]);
        }
      }
      if (c == nks - 1)      // P = s e^{a_s-g_t} masked, into the shared P tile as bf16
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int jn = 0; jn < 2; ++jn) {
            const int sl = j * 64 + wn * 16 + jn * 8 + 2 * (lane % 4);  // key (local index)
            const float a0 = ak[jn][0], a1 = ak[jn][1];
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int t = tr0 + 16 * mt + 8 * hr;
              const bool rowok = t < nvalid;
              const float p0 = rowok && sl <= t && sl < nvalid
                                   ? s[mt][jn][2 * hr] * __expf(a0 - gt[mt][hr]) : 0.f;
              const float p1 = rowok && sl + 1 <= t && sl + 1 < nvalid
                                   ? s[mt][jn][2 * hr + 1] * __expf(a1 - gt[mt][hr]) : 0.f;
              den[mt][hr] += p0 + p1;
              *reinterpret_cast<unsigned*>(ps + (t - t0) * kPS + wn * 16 + jn * 8 +
                                           2 * (lane % 4)) = pack_bf16(p0, p1);
            }
          }
    } else {                 // acc += P V
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        unsigned a[2][4], vf[4][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4(a[mt], ps + (wm * 32 + mt * 16 + (lane & 15)) * kPS + kk * 16 +
                                 (lane >> 4) * 8);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          ldmatrix_x4_trans(vf[jj], bd + (kk * 16 + (lane & 15)) * kOS + wn * 64 + jj * 16 +
                                        (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            mma_bf16(acc[mt][nt], a[mt], vf[nt / 2][2 * (nt % 2)], vf[nt / 2][2 * (nt % 2) + 1]);
      }
    }
  }

  // denominators: the quad of a row holds its partial sums over this
  // warp's quarter of the keys; the row half's other warps hold the rest
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      den[mt][hr] += __shfl_xor_sync(0xffffffffu, den[mt][hr], 1);
      den[mt][hr] += __shfl_xor_sync(0xffffffffu, den[mt][hr], 2);
      if (lane % 4 == 0) den_s[wn * 64 + tr0 - t0 + 16 * mt + 8 * hr] = den[mt][hr];
    }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = tr0 - t0 + 16 * mt + 8 * hr;
      den[mt][hr] = den_s[r] + den_s[64 + r] + den_s[128 + r] + den_s[192 + r];
    }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = tr0 + 16 * mt + 8 * hr;
      if (t >= nvalid) continue;
      const float dn = fmaxf(fabsf(den[mt][hr] + sct[mt][hr] * qn_s[t - t0]), emt[mt][hr]);
      T* hrow = hout + b * h_sb + h * h_sh + static_cast<int64_t>(base + t) * h_ss + dv0 +
                2 * (lane % 4);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        *reinterpret_cast<unsigned*>(hrow + nt * 8) =
            pack_bf16(acc[mt][nt][2 * hr] / dn, acc[mt][nt][2 * hr + 1] / dn);
    }
}

// shared memory of the fused pass: the q rows, the ring, q . n_prev,
// n_prev, the denominator quarters, the P tile
inline size_t output_tc_smem(int dk) {
  return (64 * static_cast<size_t>(dk + 8) + kTcStages * kOTile) * 2 + (64 + dk + 256) * 4 +
         64 * kPS * 2;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* ig, const void* fg,
           const float* C0, const float* n0, const float* m0, void* h, float* C, float* n,
           float* m, float* ws_gates, float* ws_chunk, float* ws_p, void* ws_c, float* ws_n,
           const Dims& D, int has_state, int tc, const long long* st, cudaStream_t stream) {
  const int BH = D.B * D.H;
  const int64_t per = static_cast<int64_t>(BH) * D.nc * D.Lp;
  GateBufs gb{ws_gates, ws_gates + per, ws_gates + 2 * per, ws_gates + 3 * per, ws_chunk,
              ws_chunk + BH * (D.nc + 1)};
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  gates_kernel<T><<<BH, kThreads, 0, stream>>>(static_cast<const T*>(ig), static_cast<const T*>(fg),
                                               has_state ? m0 : nullptr, m, gb, D, st[12], st[13],
                                               st[14], st[15], st[16], st[17]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int tiles_k = (D.dk + kT - 1) / kT, tiles_v = (D.dv + kT - 1) / kT, nt = D.Lp / kT;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (tc) {  // tensor-core route: state pass, then the fused scores + output pass
      if (D.dk % kScoreK || D.dk > kTcMaxDk || D.dv % kDvT) return kUnsupported;
      auto* cs = static_cast<__nv_bfloat16*>(ws_c);
      err = allow_smem(state_tc, kStSmem);
      if (err != cudaSuccess) return err;
      state_tc<<<dim3(D.dv / kSt, D.dk / kSt, BH), kStThreads, kStSmem, stream>>>(
          kt, vt, has_state ? C0 : nullptr, has_state ? n0 : nullptr, C, n, cs, ws_n, gb, D,
          st[3], st[4], st[5], st[6], st[7], st[8]);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      const size_t smem = output_tc_smem(D.dk);
      err = allow_smem(output_tc, smem);
      if (err != cudaSuccess) return err;
      output_tc<<<dim3(D.dv / kDvT, BH, D.nc * nt), kTcOutThreads, smem, stream>>>(
          qt, kt, vt, cs, ws_n, static_cast<T*>(h), gb, D, has_state, st[0], st[1], st[2], st[3],
          st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
      return cudaGetLastError();
    }
  }
  if (tc) return kUnsupported;
  float* ws_cf = static_cast<float*>(ws_c);
  state_kernel<T><<<dim3(tiles_v, tiles_k, BH), kThreads, 0, stream>>>(
      kt, vt, has_state ? C0 : nullptr, has_state ? n0 : nullptr, C, n, ws_cf, ws_n, gb, D, st[3],
      st[4], st[5], st[6], st[7], st[8]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scores_kernel<T><<<dim3(nt * (nt + 1) / 2, D.nc, BH), kThreads, 0, stream>>>(
      qt, kt, ws_p, gb, D, st[0], st[1], st[2], st[3], st[4], st[5]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  output_kernel<T><<<dim3(tiles_v, D.nc * nt, BH), kThreads, 0, stream>>>(
      qt, vt, ws_p, ws_cf, ws_n, static_cast<T*>(h), gb, D, has_state, st[0], st[1], st[2], st[6],
      st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ham

// q/k (B, H, S, dk), v/h (B, H, S, dv), gates (B, H, S): element strides of
// the three outer dims (q, k, v, h: unit last dim).  C0/n0/m0 (B*H, dk, dv),
// (B*H, dk), (B*H) float32 and contiguous, read when has_state; C/n/m the
// final state in the same layout.  tc selects the tensor-core route (bf16,
// dk % 64 == 0, dv % 128 == 0).  Workspaces (allocated by the caller,
// float32 unless said): gates 4 x B*H*nc*Lp, chunk B*H*(2*nc+1), p
// B*H*nc*Lp*Lp (not read by the tensor-core route), c B*H*nc*dk*dv (bf16 on
// the tensor-core route), n B*H*nc*dk, where nc = ceil(S/L) and Lp = L
// rounded up to 64.  Returns 0 or the launch error.
extern "C" int ham_mlstm_chunked(
    const void* q, const void* k, const void* v, const void* ig, const void* fg,
    const float* C0, const float* n0, const float* m0, void* h, float* C, float* n, float* m,
    float* ws_gates, float* ws_chunk, float* ws_p, void* ws_c, float* ws_n,
    int B, int H, int S, int dk, int dv, int L, int has_state, int dtype, int tc,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss, long long h_sb,
    long long h_sh, long long h_ss, long long i_sb, long long i_sh, long long i_ss,
    long long f_sb, long long f_sh, long long f_ss, int device, void* stream) {
  if (L < 1 || dk < 1 || dv < 1) return ham::kUnsupported;
  if (B == 0 || H == 0 || S == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int nc = (S + L - 1) / L, Lp = (L + ham::kT - 1) / ham::kT * ham::kT;
  const ham::Dims D{B, H, S, dk, dv, L, nc, Lp};
  const long long st[18] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                            h_sb, h_sh, h_ss, i_sb, i_sh, i_ss, f_sb, f_sh, f_ss};
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ham::kF32:
      return ham::launch<float>(q, k, v, ig, fg, C0, n0, m0, h, C, n, m, ws_gates, ws_chunk,
                                ws_p, ws_c, ws_n, D, has_state, tc, st, s);
    case ham::kBF16:
      return ham::launch<__nv_bfloat16>(q, k, v, ig, fg, C0, n0, m0, h, C, n, m, ws_gates,
                                        ws_chunk, ws_p, ws_c, ws_n, D, has_state, tc, st, s);
    default: return ham::kUnsupported;
  }
}
