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
// heads of dk 512, dv 1024 does 11.8 GFLOP, counted as the TPU kernel's
// work, on ~34 MB).  The TPU kernel keeps C (2 MB at these widths) in VMEM
// for the whole chunk loop, one grid row per (sequence, head): on this card
// C does not fit in a block's 227 KB, and B*H = 4 blocks would leave 128 of
// 132 SMs idle.  Design of this first version, four launches:
//  1. gates: one block per (sequence, head) runs the O(S) scalar prologue
//     (block-wide scans for the cumsum and the cummax, the m chain across
//     chunks) and stores a, g, e^{m_prev-g}, e^{-m_t} per position and
//     m_prev, g_L per chunk;
//  2. state: one block per (bh, 64-row dk tile, 64-column dv tile) walks the
//     chunks in order with its tile of C in registers, storing the state at
//     the start of every chunk to a float32 scratch (bh, chunk, dk, dv);
//     the dv-tile-0 blocks carry n;
//  3. scores: one block per (bh, chunk, lower-triangular 64x64 tile) stores
//     the decay-weighted, causally masked score tile P^T = (k.q) e^{a_s-g_t};
//  4. output: one block per (bh, chunk, 64-position tile, 64-column dv tile)
//     forms h from P^T V, q C_prev and the two denominator terms.
// Passes 2-4 fill the card (512, 160 and 1024 blocks at the shape above).
// Any S is taken: positions from S up to the chunk grid's end are masked
// (q/k/v read as 0, log-forget 0, input gate -inf, no h written), so a
// ragged last chunk is exact and the chunk never shrinks to divide S.
// q is scaled by 1/sqrt(dk) and rounded to the input type before the
// float32 products, as the model's chunked form does.  The products run on
// the CUDA cores in float32 (the Pallas kernel also upcast); tensor-core
// tiles, TMA and fusing the passes are later work.
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

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* ig, const void* fg,
           const float* C0, const float* n0, const float* m0, void* h, float* C, float* n,
           float* m, float* ws_gates, float* ws_chunk, float* ws_p, float* ws_c, float* ws_n,
           const Dims& D, int has_state, const long long* st, cudaStream_t stream) {
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
  state_kernel<T><<<dim3(tiles_v, tiles_k, BH), kThreads, 0, stream>>>(
      kt, vt, has_state ? C0 : nullptr, has_state ? n0 : nullptr, C, n, ws_c, ws_n, gb, D, st[3],
      st[4], st[5], st[6], st[7], st[8]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scores_kernel<T><<<dim3(nt * (nt + 1) / 2, D.nc, BH), kThreads, 0, stream>>>(
      qt, kt, ws_p, gb, D, st[0], st[1], st[2], st[3], st[4], st[5]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  output_kernel<T><<<dim3(tiles_v, D.nc * nt, BH), kThreads, 0, stream>>>(
      qt, vt, ws_p, ws_c, ws_n, static_cast<T*>(h), gb, D, has_state, st[0], st[1], st[2], st[6],
      st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ham

// q/k (B, H, S, dk), v/h (B, H, S, dv), gates (B, H, S): element strides of
// the three outer dims (q, k, v, h: unit last dim).  C0/n0/m0 (B*H, dk, dv),
// (B*H, dk), (B*H) float32 and contiguous, read when has_state; C/n/m the
// final state in the same layout.  Workspaces (float32, allocated by the
// caller): gates 4 x B*H*nc*Lp, chunk B*H*(2*nc+1), p B*H*nc*Lp*Lp,
// c B*H*nc*dk*dv, n B*H*nc*dk, where nc = ceil(S/L) and Lp = L rounded up
// to 64.  Returns 0 or the launch error.
extern "C" int ham_mlstm_chunked(
    const void* q, const void* k, const void* v, const void* ig, const void* fg,
    const float* C0, const float* n0, const float* m0, void* h, float* C, float* n, float* m,
    float* ws_gates, float* ws_chunk, float* ws_p, float* ws_c, float* ws_n,
    int B, int H, int S, int dk, int dv, int L, int has_state, int dtype,
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
                                ws_p, ws_c, ws_n, D, has_state, st, s);
    case ham::kBF16:
      return ham::launch<__nv_bfloat16>(q, k, v, ig, fg, C0, n0, m0, h, C, n, m, ws_gates,
                                        ws_chunk, ws_p, ws_c, ws_n, D, has_state, st, s);
    default: return ham::kUnsupported;
  }
}
