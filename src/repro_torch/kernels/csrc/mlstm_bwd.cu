// Chunkwise mLSTM backward for Hopper (sm_90a): the gradient of
// csrc/mlstm.cu's forward called with no initial state, for the gradient of
// h alone (the final state's gradient is not taken).
//
// The Pallas TPU kernel repro/kernels/mlstm.py (_mlstm_kernel) has no
// backward: the reference trains through XLA's autodiff of its plain
// chunked form (repro/models/xlstm.py mlstm_chunked).  Per (sequence,
// head), with q' = q / sqrt(dk) rounded to q's dtype, chunks of L
// positions, F the in-chunk cumsum of log sigmoid(f), a = i - F, the
// stabiliser g_t = max(m_prev, cummax a) and, inside a chunk, s <= t:
//   W_ts = e^{a_s - g_t}, P_ts = (q'_t . k_s) W_ts, sigma_t = e^{m_prev - g_t},
//   [num_t | den_t] = sum_s P_ts [v_s | 1] + sigma_t q'_t [C | n]_prev,
//   h_t = num_t / M_t,  M_t = max(|den_t|, e^{-F_t - g_t}),
//   [C | n]_next = tau [C | n]_prev + sum_s u_s k_s [v_s | 1],
//   u_s = e^{a_s - g_L}, tau = e^{m_prev - g_L}, m_next = F_L + g_L.
// C and n travel together as one dk x (dv + 1) matrix, [C | n]: every
// product below is then one product of it.
//
// h is invariant to the stabilisers g (each chunk's num, den and e^{-m_t}
// scale by e^{-g_t}; the state's e^{-g_L} is undone by m_next), so the
// backward holds every g constant; F is no stabiliser, and m_next = F_L +
// g_L carries a gradient into F_L.  With dh given, G_t = [dh_t / M_t |
// dden_t] (dden_t = -sign(den_t) (dh_t . num_t) / M_t^2 where |den_t| won
// the max, else 0, and then dF_t gets dh_t . h_t instead):
//   D_ts = G_t . [v_s | 1],  dS_ts = D_ts W_ts,  da_s = sum_t D_ts P_ts + ...,
//   dq = (dS k + sigma G [C | n]_prev^T) / sqrt(dk),
//   dk = dS^T q' + u [v | 1] dCn^T,   dv = P^T (dh / M) + u k dC,
// where dCn = d[C | n]_next of the chunk, carried backward:
//   d[C | n]_prev = tau dCn + sum_t sigma_t q'_t G_t.
// Two routes share the gate passes, each a warp per (sequence, head,
// chunk):
//  1a gates_scan   the in-chunk cumsum F of log sigmoid(f), a = i - F and the
//                  in-chunk cummax of a (warp scans), and the chunk's last F
//                  and cummax;
//  1b gates_exp    m at the chunk's start carried in order over the earlier
//                  chunks' (last F, cummax); g, sigma, u, tau;
//  ...
//  12 gates_bwd    da per position from its partials, the gradient into the
//                  chunk's last F (the next chunk's dm), the reverse cumsum
//                  of dF (warp scans), log sigmoid', di and df.
// Tensor-core route (bf16, dk and dv multiples of 8, L <= 1536): every
// product runs on csrc/tile_bf16.cuh's mma.sync tile (bf16 operands, float32
// accumulators; the states stay float32 in memory and in the accumulators
// and are rounded to bf16 only as operands), and no P or dS tile goes to
// device memory; eight more launches, eleven in all:
//  2a prep_pos_tc  the scaled operands once per position, bf16: q' (q /
//                  sqrt(dk) as the plain version rounds it), sigma q', u k,
//                  u [v | 1] (a loader that scaled them per fetch cost the
//                  tile routine more than its products);
//  2b walk_fwd_tc  a block per 64 x 64 tile of [C | n]: the states at every
//                  chunk start, walked in order;
//  3a rows_num_tc  a block per (chunk, 64-row tile t): P into shared memory;
//                  [num | den] = [P | sigma q'] [[v | 1] ; [C | n]] per
//                  64-column tile, reduced at once to dh . num and den; the
//                  branch, 1/M, dden, dF's branch term;
//  3b prep_g_tc    G = [dh / M | dden] and sigma G once per position;
//  3c rows_dq_tc   a block per (chunk, row tile t): P again; D = G [v | 1]^T
//                  with the column sums of D o P (per tile, summed in order
//                  by gates_bwd) and dS over P; dq = [dS | sigma G] [k ; [C |
//                  n]^T] / sqrt(dk);
//  4 walk_bwd_tc   a block per tile of d[C | n]: dCn at every chunk end,
//                  walked in reverse, with <d[C | n]_prev, [C | n]_prev>,
//                  the gradient of the chunk's m_prev (the state enters a
//                  chunk only as e^{m_prev} [C | n]_prev, so the per-position
//                  dss of the CUDA-core route is not needed);
//  5a dv_tc        a block per (chunk, 64-column tile s): P^T into shared
//                  memory over the rows t >= s; dv = [P^T | u k] [G ; dC];
//  5b dk_tc        a block per (chunk, column tile s): dS^T likewise; dk =
//                  [dS^T | u [v | 1]] [q' ; dCn^T], with k . (its state term)
//                  per row for da.
// The dv and dk passes are apart so that each block holds one L-wide tile
// in shared memory and more blocks fit an SM.
// CUDA-core route (float32, and bf16 at other widths), the first port's
// passes between the gates, float32 products on csrc/tile_f32.cuh (each
// gradient rounded once):
//  2 walk_fwd      a block per 64 x 64 tile of [C | n]: the states at every
//                  chunk start, walked in order (the bf16 forward keeps
//                  them only as bf16, so they are recomputed here);
//  3 p_tiles       a block per (chunk, 64 x 64 tile on or below the
//                  diagonal): P, stored;
//  4 num           a block per (chunk, 64 rows, 64 columns of [num | den]):
//                  the forward's products again, reduced at once to per-row
//                  partials of dh . num and den (intra and inter apart);
//  5 rows          a thread per position: M, the branch, 1/M, dden, dF's
//                  branch term, and the gradient of sigma;
//  6 g_fill        G, stored (dk x (dv + 1) products read it three times);
//  7 ds_tiles      dS stored, and per-tile column sums of D o P;
//  8 walk_bwd      a block per tile of d[C | n]: dCn at every chunk end,
//                  walked in reverse, with <dCn, [C | n]> for d tau;
//  9 dq, 10 dk, 11 dv  a block per (chunk, 64 rows, 64 columns).
// Every sum runs in a fixed order with no atomics: two calls give the same
// bits.  Positions past S in the last chunk read zeros and write nothing.
// Bound on an H100: operations, about 2x the forward's products
// (chip_smoke.py's mlstm_bwd_flops); the tensor-core route forms P four
// times and D twice (the states' six dk x (dv + 1) products per chunk are
// most of the work), and restages each tile's operands through loader
// functors; wgmma, and keeping a row tile's [P | sigma q'] in shared memory
// across its column tiles, are later work.
#include <type_traits>

#include "tile_bf16.cuh"
#include "tile_f32.cuh"

namespace ham {
namespace {

using tile::kT;
using tile::kThreads;
using tile::ldf;
using tile::MatKCol;
using tile::MatRowK;
using tile::MatT;
using tile::MatTK;
using tile::Smem;

struct Dims {
  int B, H, S, dk, dv, L;
  int nc, Lp, Sp, W, Wp, nct, dkt, dkp, dvt, nkp;
  float sqrt_dk;
  int tc;  // the tensor-core route
};

// The tensor-core route takes bf16 with dk and dv multiples of 8 (16-byte
// operand fetches) and a chunk whose 64 x L tile of P, dS, P^T or dS^T fits
// a block's shared memory beside the tile routine's.
constexpr int kTcMaxLp = 1536;
inline bool tc_route(int dtype, int dk, int dv, int L);

// Column tiles: 64 wide on the CUDA-core route, 128 (tc::kWide) on the
// tensor-core route, which pads [C | n]'s dv + 1 columns and dk to them.
// allow_tc 0 keeps bf16 on the CUDA-core route (to time the two routes).
inline Dims make_dims(int B, int H, int S, int dk, int dv, int L, int dtype, int allow_tc) {
  Dims d{B, H, S, dk, dv, L};
  d.tc = allow_tc && tc_route(dtype, dk, dv, L);
  const int cw = d.tc ? tc::kWide : kT;
  d.nc = (S + L - 1) / L;
  d.Lp = (L + kT - 1) / kT * kT;
  d.Sp = d.nc * d.Lp;
  d.W = dv + 1;
  d.Wp = (d.W + cw - 1) / cw * cw;
  d.nct = d.Wp / cw;              // column tiles of [C | n]
  d.dkp = (dk + cw - 1) / cw * cw;
  d.dkt = d.dkp / kT;             // 64-row tiles of [C | n]
  d.nkp = d.dkp / cw;             // column tiles of dq and dk (dkpart's entries a position)
  d.dvt = (dv + cw - 1) / cw;     // column tiles of dv
  d.sqrt_dk = sqrtf(static_cast<float>(dk));
  return d;
}

inline bool tc_route(int dtype, int dk, int dv, int L) {
  return dtype == kBF16 && dk % 8 == 0 && dv % 8 == 0 && (L + kT - 1) / kT * kT <= kTcMaxLp;
}

// float32 scratch, carved out of one allocation (sizes in floats)
struct Work {
  float *F, *a, *g, *sig, *u;        // per padded position (BH x Sp)
  float* tau;                         // per chunk (BH x nc)
  float *Cp, *dCn;                    // [C | n] at each chunk start, its gradient at each end
  float *P, *dS;                      // per chunk, Lp x Lp
  float *ri, *re;                     // per position and column tile: dh . num (intra, inter)
  float *deni, *dene;                 // per position: den (intra, inter)
  float *invM, *dden, *dFb, *dss;     // per position
  float* G;                           // per position, Wp wide
  float* colpart;                     // per chunk, row tile and position: sum_t D P
  float* dkpart;                      // per position and dk tile: k . (dk's state term)
  float* dotpart;                     // per chunk and state tile: a state product for dm
  float* cscan;                       // per chunk: last F and cummax a (the gates' carry)
  // tensor-core route: bf16 operands per padded position (zero past S),
  // scaled once: q', sigma q', u k (dkp wide); u [v | 1], G, sigma G (Wp
  // wide); and the states as bf16 operands, [C | n] at chunk starts and
  // d[C | n] at chunk ends (per chunk, dkp x Wp)
  __nv_bfloat16 *Qs, *SQs, *UKs, *UV1s, *Gs, *SGs, *Cp16, *dCn16;
};

// the tensor-core route keeps no P, dS or per-row partials in memory, and
// d[C | n] only as bf16 operands
inline size_t layout(const Dims& d, char* base, Work* w) {
  const size_t BH = static_cast<size_t>(d.B) * d.H, pos = BH * d.Sp, ch = BH * d.nc;
  const size_t f32 = d.tc ? 0 : 1;
  const size_t sizes[] = {
      pos, pos, pos, pos, pos, ch,
      ch * d.dkp * d.Wp, f32 * ch * d.dkp * d.Wp,
      f32 * ch * d.Lp * d.Lp, f32 * ch * d.Lp * d.Lp,
      f32 * pos * d.nct, f32 * pos * d.nct, f32 * pos, f32 * pos,
      pos, pos, pos, f32 * pos,
      f32 * pos * d.Wp,
      ch * (d.Lp / kT) * d.Lp, pos * d.nkp, ch * d.dkt * d.nct, 2 * ch};
  float** slots[] = {&w->F, &w->a, &w->g, &w->sig, &w->u, &w->tau, &w->Cp, &w->dCn, &w->P,
                     &w->dS, &w->ri, &w->re, &w->deni, &w->dene, &w->invM, &w->dden, &w->dFb,
                     &w->dss, &w->G, &w->colpart, &w->dkpart, &w->dotpart, &w->cscan};
  size_t at = 0;
  for (int i = 0; i < 23; ++i) {
    if (base) *slots[i] = reinterpret_cast<float*>(base + at);
    at += (sizes[i] * sizeof(float) + 255) / 256 * 256;
  }
  const size_t tc = d.tc ? 1 : 0;
  const size_t bsizes[] = {tc * pos * d.dkp, tc * pos * d.dkp, tc * pos * d.dkp,
                           tc * pos * d.Wp,  tc * pos * d.Wp,  tc * pos * d.Wp,
                           tc * ch * d.dkp * d.Wp, tc * ch * d.dkp * d.Wp};
  __nv_bfloat16** bslots[] = {&w->Qs, &w->SQs, &w->UKs, &w->UV1s, &w->Gs, &w->SGs, &w->Cp16,
                              &w->dCn16};
  for (int i = 0; i < 8; ++i) {
    if (base) *bslots[i] = reinterpret_cast<__nv_bfloat16*>(base + at);
    at += (bsizes[i] * sizeof(__nv_bfloat16) + 255) / 256 * 256;
  }
  return at;
}

// a (B, H, S, ...) tensor read or written through its (b, h, s) strides
template <typename P>
struct Ten {
  P* p;
  int64_t sb, sh, ss;
  __device__ __forceinline__ P* at(int bh, int H, int s) const {
    return p + static_cast<int64_t>(bh / H) * sb + static_cast<int64_t>(bh % H) * sh +
           static_cast<int64_t>(s) * ss;
  }
};

template <typename T>
struct Args {
  Ten<const T> q, k, v, ig, fg, dh;
  Ten<T> dq, dk, dv, di, df;
  Dims d;
  Work w;
};

// positions of chunk c that exist (the last chunk may be ragged)
__device__ __forceinline__ int valid_in(const Dims& d, int c) {
  const int left = d.S - c * d.L;
  return left < d.L ? left : d.L;
}

__device__ __forceinline__ float logsig(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// q / sqrt(dk) rounded to q's dtype, as the plain version scales q
template <typename T> __device__ __forceinline__ float qscale(float x, float s);
template <> __device__ __forceinline__ float qscale<float>(float x, float s) { return x / s; }
template <> __device__ __forceinline__ float qscale<__nv_bfloat16>(float x, float s) {
  return __bfloat162float(__float2bfloat16_rn(x / s));
}

// -- loaders (tile-local row / column, contraction index) ---------------------

// q'_t[j] at (t, j): rows are positions t0 + r of chunk c
template <typename T>
struct QRowK {
  static constexpr bool kKFast = true;
  Ten<const T> q; int bh, H, c, L, t0, nvalid, dk; float sq;
  __device__ float operator()(int r, int j) const {
    const int t = t0 + r;
    return t < nvalid && j < dk ? qscale<T>(ldf(q.at(bh, H, c * L + t) + j), sq) : 0.f;
  }
};

// q'_t[j] at (k = t, column j): the B operand over positions
template <typename T>
struct QKCol {
  static constexpr bool kKFast = false;
  Ten<const T> q; int bh, H, c, L, nvalid, dk, j0; float sq;
  __device__ float operator()(int t, int cc) const {
    const int j = j0 + cc;
    return t < nvalid && j < dk ? qscale<T>(ldf(q.at(bh, H, c * L + t) + j), sq) : 0.f;
  }
};

// scale_t q'_t[j] at (row j, k = t): the A operand of walk_bwd
template <typename T>
struct QT {
  static constexpr bool kKFast = false;
  Ten<const T> q; const float* scale; int bh, H, c, L, nvalid, dk, j0; float sq;
  __device__ float operator()(int r, int t) const {
    const int j = j0 + r;
    return t < nvalid && j < dk ? scale[t] * qscale<T>(ldf(q.at(bh, H, c * L + t) + j), sq) : 0.f;
  }
};

// x_s[j] (k or v) at (k = j, column s): an operand contracted over its width
template <typename T>
struct RowsAsCols {
  static constexpr bool kKFast = true;
  Ten<const T> x; int bh, H, c, L, s0, nvalid, width;
  __device__ float operator()(int j, int cc) const {
    const int s = s0 + cc;
    return s < nvalid && j < width ? ldf(x.at(bh, H, c * L + s) + j) : 0.f;
  }
};

// x_s[j] at (k = s, column j0 + cc): an operand contracted over positions
template <typename T>
struct PosK {
  static constexpr bool kKFast = false;
  Ten<const T> x; int bh, H, c, L, nvalid, width, j0;
  __device__ float operator()(int s, int cc) const {
    const int j = j0 + cc;
    return s < nvalid && j < width ? ldf(x.at(bh, H, c * L + s) + j) : 0.f;
  }
};

// x_s[j] at (row s0 + r, k = j): rows are positions, contracted over width
template <typename T>
struct PosRow {
  static constexpr bool kKFast = true;
  Ten<const T> x; int bh, H, c, L, s0, nvalid, width;
  __device__ float operator()(int r, int j) const {
    const int s = s0 + r;
    return s < nvalid && j < width ? ldf(x.at(bh, H, c * L + s) + j) : 0.f;
  }
};

// k_s[j] at (row j0 + r, k = s): walk_fwd's A
template <typename T>
struct KT {
  static constexpr bool kKFast = false;
  Ten<const T> k; int bh, H, c, L, nvalid, dk, j0;
  __device__ float operator()(int r, int s) const {
    const int j = j0 + r;
    return s < nvalid && j < dk ? ldf(k.at(bh, H, c * L + s) + j) : 0.f;
  }
};

// scale_s [v_s | 1][e] at (k = s, column e0 + cc) (scale null: 1)
template <typename T>
struct ExtK {
  static constexpr bool kKFast = false;
  Ten<const T> v; const float* scale; int bh, H, c, L, nvalid, dv, e0;
  __device__ float operator()(int s, int cc) const {
    const int e = e0 + cc;
    if (s >= nvalid || e > dv) return 0.f;
    const float x = e < dv ? ldf(v.at(bh, H, c * L + s) + e) : 1.f;
    return scale ? scale[s] * x : x;
  }
};

// [v_s | 1][e] at (row s0 + r, k = e)
template <typename T>
struct ExtRow {
  static constexpr bool kKFast = true;
  Ten<const T> v; int bh, H, c, L, s0, nvalid, dv;
  __device__ float operator()(int r, int e) const {
    const int s = s0 + r;
    if (s >= nvalid || e > dv) return 0.f;
    return e < dv ? ldf(v.at(bh, H, c * L + s) + e) : 1.f;
  }
};

// [v_s | 1][e] at (k = e, column s0 + cc)
template <typename T>
struct ExtCol {
  static constexpr bool kKFast = true;
  Ten<const T> v; int bh, H, c, L, s0, nvalid, dv;
  __device__ float operator()(int e, int cc) const {
    const int s = s0 + cc;
    if (s >= nvalid || e > dv) return 0.f;
    return e < dv ? ldf(v.at(bh, H, c * L + s) + e) : 1.f;
  }
};

// -- 1: gate quantities, a warp per (sequence, head, chunk) -------------------

// warp sums and scans in a fixed lane order
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 1a: the in-chunk cumsum F of log sigmoid(f), a = i - F and the in-chunk
// cummax of a (held in g until 1b), 32 positions at a time; the chunk's
// last F and cummax go to cscan.  Positions past S read log-forget 0 and
// input gate -inf, so both carries end at the last valid position.
template <typename T>
__global__ void __launch_bounds__(128) gates_scan(Args<T> A) {
  const Dims& d = A.d;
  const int wid = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (wid >= d.B * d.H * d.nc) return;  // the whole warp
  const Work& w = A.w;
  const int bh = wid / d.nc, c = wid % d.nc, nv = valid_in(d, c);
  const int64_t base = static_cast<int64_t>(bh) * d.Sp + c * d.Lp;
  float Fc = 0.f, mc = -INFINITY;
  for (int r0 = 0; r0 < d.Lp; r0 += 32) {
    const int r = r0 + lane;
    const bool ok = r < nv;
    float F = ok ? logsig(ldf(A.fg.at(bh, d.H, c * d.L + r))) : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, F, o);
      if (lane >= o) F += y;
    }
    F += Fc;
    const float a = ok ? ldf(A.ig.at(bh, d.H, c * d.L + r)) - F : -INFINITY;
    float m = a;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, m, o);
      if (lane >= o) m = fmaxf(m, y);
    }
    m = fmaxf(mc, m);
    w.F[base + r] = ok ? F : 0.f;
    w.a[base + r] = ok ? a : 0.f;
    w.g[base + r] = ok ? m : 0.f;
    Fc = __shfl_sync(0xffffffffu, F, 31);
    mc = __shfl_sync(0xffffffffu, m, 31);
  }
  if (lane == 0) {
    w.cscan[2 * (static_cast<int64_t>(bh) * d.nc + c)] = Fc;
    w.cscan[2 * (static_cast<int64_t>(bh) * d.nc + c) + 1] = mc;
  }
}

// 1b: m at the chunk's start, carried in order over the earlier chunks'
// (last F, cummax) (8 chunks at S 2048); then g = max(m_prev, cummax),
// sigma, u per position and tau
template <typename T>
__global__ void __launch_bounds__(128) gates_exp(Args<T> A) {
  const Dims& d = A.d;
  const int wid = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (wid >= d.B * d.H * d.nc) return;
  const Work& w = A.w;
  const int bh = wid / d.nc, c = wid % d.nc, nv = valid_in(d, c);
  const int64_t ch = static_cast<int64_t>(bh) * d.nc + c;
  const int64_t base = static_cast<int64_t>(bh) * d.Sp + c * d.Lp;
  float mp = -INFINITY;
  for (int64_t cc = ch - c; cc < ch; ++cc) mp = w.cscan[2 * cc] + fmaxf(mp, w.cscan[2 * cc + 1]);
  const float gL = fmaxf(mp, w.cscan[2 * ch + 1]);
  for (int r = lane; r < d.Lp; r += 32) {
    const int64_t p = base + r;
    if (r >= nv) {
      w.g[p] = w.sig[p] = w.u[p] = 0.f;
      continue;
    }
    const float g = fmaxf(mp, w.g[p]);
    w.g[p] = g;
    w.sig[p] = expf(mp - g);
    w.u[p] = expf(w.a[p] - gL);
  }
  if (lane == 0) w.tau[ch] = expf(mp - gL);
}

// -- 2: [C | n] at every chunk start -----------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) walk_fwd(Args<T> A) {
  __shared__ Smem sm;
  const Dims& d = A.d;
  const int j0 = blockIdx.x * kT, e0 = blockIdx.y * kT, bh = blockIdx.z;
  float acc[4][4];
  tile::zero(acc);
  for (int c = 0; c < d.nc; ++c) {
    const int64_t ch = static_cast<int64_t>(bh) * d.nc + c;
    tile::store_tile(A.w.Cp + (ch * d.dkp + j0) * d.Wp + e0, d.Wp, acc);
    if (c == d.nc - 1) break;
    tile::scale(acc, A.w.tau[ch]);
    const int nv = valid_in(d, c);
    KT<T> a{A.k, bh, d.H, c, d.L, nv, d.dk, j0};
    ExtK<T> b{A.v, A.w.u + static_cast<int64_t>(bh) * d.Sp + c * d.Lp, bh, d.H, c, d.L, nv,
              d.dv, e0};
    tile::mma(acc, a, b, 0, nv, sm);
  }
}

// -- 3: P = (q' k^T) o W on and below the diagonal -----------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) p_tiles(Args<T> A) {
  __shared__ Smem sm;
  const Dims& d = A.d;
  const int tt = blockIdx.x, st = blockIdx.y;
  if (st > tt) return;
  const int bh = blockIdx.z / d.nc, c = blockIdx.z % d.nc, nv = valid_in(d, c);
  float acc[4][4];
  tile::zero(acc);
  QRowK<T> a{A.q, bh, d.H, c, d.L, tt * kT, nv, d.dk, d.sqrt_dk};
  RowsAsCols<T> b{A.k, bh, d.H, c, d.L, st * kT, nv, d.dk};
  tile::mma(acc, a, b, 0, d.dk, sm);
  const int64_t pos = static_cast<int64_t>(bh) * d.Sp + c * d.Lp;
  float* P = A.w.P + (static_cast<int64_t>(bh) * d.nc + c) * d.Lp * d.Lp;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = tt * kT + 4 * tile::ty() + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = st * kT + 4 * tile::tx() + j;
      const bool ok = s <= t && t < nv;
      P[static_cast<int64_t>(t) * d.Lp + s] =
          ok ? acc[i][j] * expf(A.w.a[pos + s] - A.w.g[pos + t]) : 0.f;
    }
  }
}

// -- 4: [num | den] again, as per-row partials --------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) num(Args<T> A) {
  __shared__ Smem sm;
  const Dims& d = A.d;
  const int rpc = d.Lp / kT;
  const int c = blockIdx.x / rpc, tt = blockIdx.x % rpc, ct = blockIdx.y, bh = blockIdx.z;
  const int nv = valid_in(d, c), e0 = ct * kT;
  const int64_t ch = static_cast<int64_t>(bh) * d.nc + c;
  const int64_t pos = static_cast<int64_t>(bh) * d.Sp + c * d.Lp;
  float intra[4][4], inter[4][4];
  tile::zero(intra);
  tile::zero(inter);
  const int kend = min((tt + 1) * kT, nv);
  if (tt * kT < nv) {
    MatRowK a{A.w.P + ch * d.Lp * d.Lp, d.Lp, tt * kT};
    ExtK<T> b{A.v, nullptr, bh, d.H, c, d.L, nv, d.dv, e0};
    tile::mma(intra, a, b, 0, kend, sm);
    if (c > 0) {
      QRowK<T> a1{A.q, bh, d.H, c, d.L, tt * kT, nv, d.dk, d.sqrt_dk};
      MatKCol b1{A.w.Cp + ch * d.dkp * d.Wp, d.Wp, e0, d.Wp};
      tile::mma(inter, a1, b1, 0, d.dk, sm);
    }
  }
  float pi[4], pe[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = tt * kT + 4 * tile::ty() + i;
    const bool ok = t < nv;
    const float sg = ok ? A.w.sig[pos + t] : 0.f;
    pi[i] = pe[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + 4 * tile::tx() + j;
      const float ni = intra[i][j], ne = sg * inter[i][j];
      if (ok && e < d.dv) {
        const float g = ldf(A.dh.at(bh, d.H, c * d.L + t) + e);
        pi[i] += g * ni;
        pe[i] += g * ne;
      } else if (ok && e == d.dv) {
        A.w.deni[pos + t] = ni;
        A.w.dene[pos + t] = ne;
      }
    }
  }
  const float si = tile::reduce_rows(pi, sm);
  const float se = tile::reduce_rows(pe, sm);
  const int tid = threadIdx.x;
  if (tid < kT) {
    const int64_t p = (pos + tt * kT + tid) * d.nct + ct;
    A.w.ri[p] = si;
    A.w.re[p] = se;
  }
}

// -- 5: the denominator's branch, per position --------------------------------

template <typename T>
__global__ void rows(Args<T> A) {
  const Dims& d = A.d;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= static_cast<int64_t>(d.B) * d.H * d.Sp) return;
  const Work& w = A.w;
  const int c = static_cast<int>(p % d.Sp) / d.Lp, r = static_cast<int>(p % d.Sp) % d.Lp;
  if (r >= valid_in(d, c)) {
    w.invM[p] = w.dden[p] = w.dFb[p] = w.dss[p] = 0.f;
    return;
  }
  float ri = 0.f, re = 0.f;
  for (int ct = 0; ct < d.nct; ++ct) {
    ri += w.ri[p * d.nct + ct];
    re += w.re[p * d.nct + ct];
  }
  const float den = w.deni[p] + w.dene[p], rho = ri + re;
  const float em = expf(-(w.F[p] + w.g[p]));
  const bool by_den = fabsf(den) >= em;
  const float M = by_den ? fabsf(den) : em, inv = 1.f / M;
  const float dden = by_den ? -copysignf(1.f, den) * rho * inv * inv : 0.f;
  w.invM[p] = inv;
  w.dden[p] = dden;
  w.dFb[p] = by_den ? 0.f : rho * inv;
  w.dss[p] = inv * re + dden * w.dene[p];
}

// -- 6: G = [dh / M | dden], Wp wide ------------------------------------------

template <typename T>
__global__ void g_fill(Args<T> A) {
  const Dims& d = A.d;
  const int64_t p = blockIdx.x;
  const int bh = static_cast<int>(p / d.Sp), c = static_cast<int>(p % d.Sp) / d.Lp,
            r = static_cast<int>(p % d.Sp) % d.Lp;
  const bool ok = r < valid_in(d, c);
  const float inv = A.w.invM[p], dden = A.w.dden[p];
  const T* dh = ok ? A.dh.at(bh, d.H, c * d.L + r) : nullptr;
  for (int e = threadIdx.x; e < d.Wp; e += blockDim.x)
    A.w.G[p * d.Wp + e] = !ok ? 0.f : e < d.dv ? inv * ldf(dh + e) : e == d.dv ? dden : 0.f;
}

// -- 7: dS = (G [v | 1]^T) o W, and column sums of D o P ----------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) ds_tiles(Args<T> A) {
  __shared__ Smem sm;
  const Dims& d = A.d;
  const int tt = blockIdx.x, st = blockIdx.y;
  if (st > tt) return;
  const int bh = blockIdx.z / d.nc, c = blockIdx.z % d.nc, nv = valid_in(d, c);
  const int64_t ch = static_cast<int64_t>(bh) * d.nc + c;
  const int64_t pos = static_cast<int64_t>(bh) * d.Sp + c * d.Lp;
  float acc[4][4];
  tile::zero(acc);
  MatRowK a{A.w.G + pos * d.Wp, d.Wp, tt * kT};
  ExtCol<T> b{A.v, bh, d.H, c, d.L, st * kT, nv, d.dv};
  tile::mma(acc, a, b, 0, d.W, sm);
  const float* P = A.w.P + ch * d.Lp * d.Lp;
  float* dS = A.w.dS + ch * d.Lp * d.Lp;
  float cs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = tt * kT + 4 * tile::ty() + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = st * kT + 4 * tile::tx() + j;
      const int64_t at = static_cast<int64_t>(t) * d.Lp + s;
      const bool ok = s <= t && t < nv;
      dS[at] = ok ? acc[i][j] * expf(A.w.a[pos + s] - A.w.g[pos + t]) : 0.f;
      if (ok) cs[j] += acc[i][j] * P[at];
    }
  }
  const float col = tile::reduce_cols(cs, sm);
  if (threadIdx.x < kT)
    A.w.colpart[(ch * (d.Lp / kT) + tt) * d.Lp + st * kT + threadIdx.x] = col;
}

// -- 8: d[C | n] at every chunk end, walked in reverse -------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) walk_bwd(Args<T> A) {
  __shared__ Smem sm;
  const Dims& d = A.d;
  const int j0 = blockIdx.x * kT, e0 = blockIdx.y * kT, bh = blockIdx.z;
  const int tiles = d.dkt * d.nct, tile_id = blockIdx.x * d.nct + blockIdx.y;
  float acc[4][4];
  tile::zero(acc);
  for (int c = d.nc - 1; c >= 0; --c) {
    const int64_t ch = static_cast<int64_t>(bh) * d.nc + c;
    const int64_t off = (ch * d.dkp + j0) * d.Wp + e0;
    tile::store_tile(A.w.dCn + off, d.Wp, acc);
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dot += acc[i][j] * A.w.Cp[off + (4 * tile::ty() + i) * d.Wp + 4 * tile::tx() + j];
    dot = tile::reduce_block(dot, sm);
    if (threadIdx.x == 0) A.w.dotpart[ch * tiles + tile_id] = dot;
    if (c == 0) break;
    tile::scale(acc, A.w.tau[ch]);
    const int nv = valid_in(d, c);
    const int64_t pos = static_cast<int64_t>(bh) * d.Sp + c * d.Lp;
    QT<T> a{A.q, A.w.sig + pos, bh, d.H, c, d.L, nv, d.dk, j0, d.sqrt_dk};
    MatKCol b{A.w.G + pos * d.Wp, d.Wp, e0, d.Wp};
    tile::mma(acc, a, b, 0, nv, sm);
  }
}

// -- 9: dq = (dS k + sigma G [C | n]^T) / sqrt(dk) ----------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) dq_tiles(Args<T> A) {
  __shared__ Smem sm;
  const Dims& d = A.d;
  const int rpc = d.Lp / kT;
  const int c = blockIdx.x / rpc, tt = blockIdx.x % rpc, j0 = blockIdx.y * kT, bh = blockIdx.z;
  const int nv = valid_in(d, c);
  if (tt * kT >= nv) return;
  const int64_t ch = static_cast<int64_t>(bh) * d.nc + c;
  const int64_t pos = static_cast<int64_t>(bh) * d.Sp + c * d.Lp;
  float intra[4][4], inter[4][4];
  tile::zero(intra);
  tile::zero(inter);
  MatRowK a{A.w.dS + ch * d.Lp * d.Lp, d.Lp, tt * kT};
  PosK<T> b{A.k, bh, d.H, c, d.L, nv, d.dk, j0};
  tile::mma(intra, a, b, 0, min((tt + 1) * kT, nv), sm);
  if (c > 0) {
    MatRowK a1{A.w.G + pos * d.Wp, d.Wp, tt * kT};
    MatTK b1{A.w.Cp + ch * d.dkp * d.Wp, d.Wp, j0, d.dkp};
    tile::mma(inter, a1, b1, 0, d.W, sm);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = tt * kT + 4 * tile::ty() + i;
    if (t >= nv) continue;
    const float sg = A.w.sig[pos + t];
    T* out = A.dq.at(bh, d.H, c * d.L + t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jj = j0 + 4 * tile::tx() + j;
      if (jj < d.dk) store(out + jj, (intra[i][j] + sg * inter[i][j]) / d.sqrt_dk);
    }
  }
}

// -- 10: dk = dS^T q' + u [v | 1] dCn^T, and k . (its state term) ------------

template <typename T>
__global__ void __launch_bounds__(kThreads) dk_tiles(Args<T> A) {
  __shared__ Smem sm;
  const Dims& d = A.d;
  const int rpc = d.Lp / kT;
  const int c = blockIdx.x / rpc, st = blockIdx.x % rpc, jt = blockIdx.y, bh = blockIdx.z;
  const int j0 = jt * kT, nv = valid_in(d, c);
  const int64_t ch = static_cast<int64_t>(bh) * d.nc + c;
  const int64_t pos = static_cast<int64_t>(bh) * d.Sp + c * d.Lp;
  float intra[4][4], inter[4][4];
  tile::zero(intra);
  tile::zero(inter);
  if (st * kT < nv) {
    MatT a{A.w.dS + ch * d.Lp * d.Lp, d.Lp, st * kT};
    QKCol<T> b{A.q, bh, d.H, c, d.L, nv, d.dk, j0, d.sqrt_dk};
    tile::mma(intra, a, b, st * kT, nv, sm);
    if (c < d.nc - 1) {
      ExtRow<T> a1{A.v, bh, d.H, c, d.L, st * kT, nv, d.dv};
      MatTK b1{A.w.dCn + ch * d.dkp * d.Wp, d.Wp, j0, d.dkp};
      tile::mma(inter, a1, b1, 0, d.W, sm);
    }
  }
  float part[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = st * kT + 4 * tile::ty() + i;
    part[i] = 0.f;
    if (s >= nv) continue;
    const float u = A.w.u[pos + s];
    const T* kr = A.k.at(bh, d.H, c * d.L + s);
    T* out = A.dk.at(bh, d.H, c * d.L + s);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jj = j0 + 4 * tile::tx() + j;
      if (jj >= d.dk) continue;
      const float x = u * inter[i][j];
      part[i] += ldf(kr + jj) * x;
      store(out + jj, intra[i][j] + x);
    }
  }
  const float sum = tile::reduce_rows(part, sm);
  if (threadIdx.x < kT) A.w.dkpart[(pos + st * kT + threadIdx.x) * d.nkp + jt] = sum;
}

// -- 11: dv = P^T (dh / M) + u k dC -------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) dv_tiles(Args<T> A) {
  __shared__ Smem sm;
  const Dims& d = A.d;
  const int rpc = d.Lp / kT;
  const int c = blockIdx.x / rpc, st = blockIdx.x % rpc, e0 = blockIdx.y * kT, bh = blockIdx.z;
  const int nv = valid_in(d, c);
  if (st * kT >= nv) return;
  const int64_t ch = static_cast<int64_t>(bh) * d.nc + c;
  const int64_t pos = static_cast<int64_t>(bh) * d.Sp + c * d.Lp;
  float intra[4][4], inter[4][4];
  tile::zero(intra);
  tile::zero(inter);
  MatT a{A.w.P + ch * d.Lp * d.Lp, d.Lp, st * kT};
  MatKCol b{A.w.G + pos * d.Wp, d.Wp, e0, d.dv};
  tile::mma(intra, a, b, st * kT, nv, sm);
  if (c < d.nc - 1) {
    PosRow<T> a1{A.k, bh, d.H, c, d.L, st * kT, nv, d.dk};
    MatKCol b1{A.w.dCn + ch * d.dkp * d.Wp, d.Wp, e0, d.dv};
    tile::mma(inter, a1, b1, 0, d.dk, sm);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = st * kT + 4 * tile::ty() + i;
    if (s >= nv) continue;
    const float u = A.w.u[pos + s];
    T* out = A.dv.at(bh, d.H, c * d.L + s);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + 4 * tile::tx() + j;
      if (e < d.dv) store(out + e, intra[i][j] + u * inter[i][j]);
    }
  }
}

// -- 12: the gates' gradients, a warp per (sequence, head, chunk) ------------
// The gradient into a chunk's last F (m_next = F_L + g_L, g held constant)
// is that of the next chunk's m_prev: with state_dot, the sum of the next
// chunk's partials of <d[C | n]_prev, [C | n]_prev> (the state enters a
// chunk only as e^{m_prev} [C | n]_prev); else the CUDA-core route's sum
// over the next chunk's positions of dss plus tau <dCn, [C | n]>.  Then
// the reverse cumsum of dF over the chunk, 32 positions at a time from the
// end; log sigmoid' for df.
template <typename T>
__global__ void __launch_bounds__(128) gates_bwd(Args<T> A, int state_dot) {
  const Dims& d = A.d;
  const int wid = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (wid >= d.B * d.H * d.nc) return;
  const Work& w = A.w;
  const int bh = wid / d.nc, c = wid % d.nc, nv = valid_in(d, c);
  const int rpc = d.Lp / kT, tiles = d.dkt * d.nct, rt = (nv + kT - 1) / kT;
  const int64_t ch = static_cast<int64_t>(bh) * d.nc + c;
  const int64_t pos = static_cast<int64_t>(bh) * d.Sp + c * d.Lp;
  float dmn = 0.f;
  if (c + 1 < d.nc) {
    float dot = 0.f;
    for (int t = lane; t < tiles; t += 32) dot += w.dotpart[(ch + 1) * tiles + t];
    dot = warp_sum(dot);
    if (state_dot) {
      dmn = dot;
    } else {
      float dm = 0.f;
      for (int r = lane; r < valid_in(d, c + 1); r += 32) dm += w.dss[pos + d.Lp + r];
      dmn = warp_sum(dm) + w.tau[ch + 1] * dot;
    }
  }
  float carry = 0.f;  // sum of dF over the positions past this step
  for (int r0 = d.Lp - 32; r0 >= 0; r0 -= 32) {
    const int r = r0 + lane;
    float da = 0.f, x = 0.f;
    if (r < nv) {
      for (int tt = r / kT; tt < rt; ++tt) da += w.colpart[(ch * rpc + tt) * d.Lp + r];
      for (int jt = 0; jt < d.nkp; ++jt) da += w.dkpart[(pos + r) * d.nkp + jt];
      x = w.dFb[pos + r] - da + (r == d.L - 1 ? dmn : 0.f);
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {  // x = sum of dF over lanes >= lane
      const float y = __shfl_down_sync(0xffffffffu, x, o);
      if (lane + o < 32) x += y;
    }
    if (r < nv) {
      const float f = ldf(A.fg.at(bh, d.H, c * d.L + r));
      store(A.df.at(bh, d.H, c * d.L + r), (carry + x) / (1.f + expf(f)));
      store(A.di.at(bh, d.H, c * d.L + r), da);
    }
    carry += __shfl_sync(0xffffffffu, x, 0);
  }
}

// -- the tensor-core route (bf16): every product on tc::mma -----------------

using B16 = __nv_bfloat16;

// A (B, H, S, width) bf16 input read from the start of chunk c of one
// (sequence, head), as a tile-routine operand: positions (p0 + the position
// index) are the operand's k (kPosIsK) or m, columns c0 + the other index;
// with kOne, column `width` reads 1 ([v | 1]); positions past nv and other
// columns past width read 0.  width is a multiple of 8, so a vector lies
// wholly below it or at and past it.
template <bool kPosIsK, bool kOne>
struct PosLd {
  static constexpr bool kKMajor = !kPosIsK;
  const B16* x;
  int64_t ss;
  int p0, c0, nv, width;
  struct Raw {
    uint4 v;
    int col;
    bool ok;
  };
  __device__ __forceinline__ Raw load(int m, int k) const {
    const int pos = p0 + (kPosIsK ? k : m), col = c0 + (kPosIsK ? m : k);
    const bool ok = pos < nv;
    return {ok && col < width ? load16(x + pos * ss + col) : make_uint4(0u, 0u, 0u, 0u), col, ok};
  }
  __device__ __forceinline__ uint4 pack(const Raw& r) const {
    if (!kOne || r.col != width || !r.ok) return r.v;
    return make_uint4(pack_bf16(1.f, 0.f), 0u, 0u, 0u);  // column width of [v | 1]
  }
};

// a bf16 [positions][ld] operand array of the tensor-core route (Work's
// Qs .. SGs), from the start of a chunk: positions p0 + ... along k
// (kPosIsK) or m, columns c0 + the other; padded with zeros, so no masks
template <bool kPosIsK>
struct ArrLd {
  static constexpr bool kKMajor = !kPosIsK;
  const B16* x;
  int ld, p0, c0;
  using Raw = uint4;
  __device__ __forceinline__ Raw load(int m, int k) const {
    return load16(x + static_cast<int64_t>(p0 + (kPosIsK ? k : m)) * ld + c0 + (kPosIsK ? m : k));
  }
  __device__ __forceinline__ uint4 pack(const Raw& r) const { return r; }
};

// element (j, e) of a chunk's state, a row-major bf16 [dkp][Wp] matrix
// ([C | n] or d[C | n], zero in its padding): j is the operand's m (kJIsM)
// or k, e the other
template <bool kJIsM>
struct MatLd {
  static constexpr bool kKMajor = kJIsM;
  const B16* mat;
  int64_t ld;
  int j0, e0;
  using Raw = uint4;
  __device__ __forceinline__ Raw load(int m, int k) const {
    return load16(mat + (j0 + (kJIsM ? m : k)) * ld + e0 + (kJIsM ? k : m));
  }
  __device__ __forceinline__ uint4 pack(const Raw& r) const { return r; }
};

// element (m, k) of a bf16 [64][ld] tile in shared memory (P or dS)
struct SmemLd {
  static constexpr bool kKMajor = true;
  const B16* t;
  int ld;
  using Raw = uint4;
  __device__ __forceinline__ Raw load(int m, int k) const {
    return *reinterpret_cast<const uint4*>(t + m * ld + k);
  }
  __device__ __forceinline__ uint4 pack(const Raw& r) const { return r; }
};

// operands of chunk c of sequence-head bh
struct Chunk {
  int bh, c, nv;
  int64_t pos, ch;
};
__device__ __forceinline__ Chunk chunk_of(const Dims& d, int bh, int c) {
  return {bh, c, valid_in(d, c), static_cast<int64_t>(bh) * d.Sp + c * d.Lp,
          static_cast<int64_t>(bh) * d.nc + c};
}
// k and [v | 1] straight from the inputs
template <bool kPosIsK>
__device__ __forceinline__ PosLd<kPosIsK, false> k_ld(const Args<B16>& A, const Chunk& k, int p0,
                                                      int c0) {
  return {A.k.at(k.bh, A.d.H, k.c * A.d.L), A.k.ss, p0, c0, k.nv, A.d.dk};
}
template <bool kPosIsK>
__device__ __forceinline__ PosLd<kPosIsK, true> v1_ld(const Args<B16>& A, const Chunk& k, int p0,
                                                      int c0) {
  return {A.v.at(k.bh, A.d.H, k.c * A.d.L), A.v.ss, p0, c0, k.nv, A.d.dv};
}
// an operand array (dkp or Wp wide) from the chunk's first position
template <bool kPosIsK>
__device__ __forceinline__ ArrLd<kPosIsK> arr_ld(const B16* base, int ld, const Chunk& k, int p0,
                                                 int c0) {
  return {base + k.pos * ld, ld, p0, c0};
}

// 2a: the scaled operands, once per position: q' = q / sqrt(dk) rounded to
// bf16 as the plain version rounds it, sigma q', u k, u [v | 1]; zero past S
__global__ void __launch_bounds__(128) prep_pos_tc(Args<B16> A) {
  const Dims& d = A.d;
  const Work& w = A.w;
  const int64_t p = blockIdx.x;
  const int bh = static_cast<int>(p / d.Sp), c = static_cast<int>(p % d.Sp) / d.Lp,
            r = static_cast<int>(p % d.Sp) % d.Lp;
  const bool ok = r < valid_in(d, c);
  const float sig = ok ? w.sig[p] : 0.f, u = ok ? w.u[p] : 0.f, rq = 1.f / d.sqrt_dk;
  const B16* qr = A.q.at(bh, d.H, c * d.L + r);
  const B16* kr = A.k.at(bh, d.H, c * d.L + r);
  const B16* vr = A.v.at(bh, d.H, c * d.L + r);
  for (int j = 8 * threadIdx.x; j < d.dkp; j += 8 * blockDim.x) {
    float q[8], kk[8], sq[8], uk[8];
    const bool in = ok && j < d.dk;
    tc::unpack8(in ? load16(qr + j) : make_uint4(0u, 0u, 0u, 0u), q);
    tc::unpack8(in ? load16(kr + j) : make_uint4(0u, 0u, 0u, 0u), kk);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      q[i] = __bfloat162float(__float2bfloat16_rn(q[i] * rq));
      sq[i] = sig * q[i];
      uk[i] = u * kk[i];
    }
    const int64_t at = p * d.dkp + j;
    *reinterpret_cast<uint4*>(w.Qs + at) = tc::pack8(q);
    *reinterpret_cast<uint4*>(w.SQs + at) = tc::pack8(sq);
    *reinterpret_cast<uint4*>(w.UKs + at) = tc::pack8(uk);
  }
  for (int e = 8 * threadIdx.x; e < d.Wp; e += 8 * blockDim.x) {
    float x[8];
    tc::unpack8(ok && e < d.dv ? load16(vr + e) : make_uint4(0u, 0u, 0u, 0u), x);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = u * (e + i == d.dv ? 1.f : x[i]);
    *reinterpret_cast<uint4*>(w.UV1s + p * d.Wp + e) = tc::pack8(x);
  }
}

// 3b: G = [dh / M | dden] and sigma G once per position (after 3a's 1/M
// and dden); zero past S
__global__ void __launch_bounds__(128) prep_g_tc(Args<B16> A) {
  const Dims& d = A.d;
  const Work& w = A.w;
  const int64_t p = blockIdx.x;
  const int bh = static_cast<int>(p / d.Sp), c = static_cast<int>(p % d.Sp) / d.Lp,
            r = static_cast<int>(p % d.Sp) % d.Lp;
  const bool ok = r < valid_in(d, c);
  const float sig = ok ? w.sig[p] : 0.f, inv = ok ? w.invM[p] : 0.f, dd = ok ? w.dden[p] : 0.f;
  const B16* hr = A.dh.at(bh, d.H, c * d.L + r);
  for (int e = 8 * threadIdx.x; e < d.Wp; e += 8 * blockDim.x) {
    float g[8], sg[8];
    tc::unpack8(ok && e < d.dv ? load16(hr + e) : make_uint4(0u, 0u, 0u, 0u), g);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      g[i] = e + i == d.dv ? dd : inv * g[i];
      sg[i] = sig * g[i];
    }
    *reinterpret_cast<uint4*>(w.Gs + p * d.Wp + e) = tc::pack8(g);
    *reinterpret_cast<uint4*>(w.SGs + p * d.Wp + e) = tc::pack8(sg);
  }
}

__device__ __forceinline__ void store_pair(B16* p, float x, float y) {
  *reinterpret_cast<unsigned*>(p) = pack_bf16(x, y);
}

constexpr int kWJ = tc::kWide / 8;  // n8 tiles a warp of a 128-column product

// A row or column pass's tiles along the chunk (P, D, P^T, dS^T): 128
// columns where two 64-column tiles lie below `end`, else 64; fn<NJ>(c0).
template <class Fn>
__device__ __forceinline__ void along(int c0, int end, Fn&& fn) {
  while (c0 < end) {
    if (c0 + tc::kWide <= end) {
      fn.template operator()<kWJ>(c0);
      c0 += tc::kWide;
    } else {
      fn.template operator()<8>(c0);
      c0 += kT;
    }
  }
}

// P = (q' k^T) o W of rows t0.. and columns s0 .. s0 + 8 NJ into the bf16
// [64][ld] tile P of shared memory
struct PTile {
  B16* P;
  int ld, t0;
  const Args<B16>& A;
  const Chunk& k;
  tc::Smem& sm;
  template <int NJ>
  __device__ __forceinline__ void operator()(int s0) const {
    const Dims& d = A.d;
    float acc[NJ][4];
    tc::zero(acc);
    tc::mma(acc, arr_ld<false>(A.w.Qs, d.dkp, k, t0, 0), k_ld<false>(A, k, s0, 0), 0, d.dk, sm);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = tc::row(2 * hh), t = t0 + r, s = s0 + tc::col(j, 0);
        float x[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          x[i] = s + i <= t && t < k.nv
                     ? acc[j][2 * hh + i] * expf(A.w.a[k.pos + s + i] - A.w.g[k.pos + t]) : 0.f;
        store_pair(P + r * ld + s, x[0], x[1]);
      }
  }
};

// 2b: [C | n] at every chunk start, a block per 64 x 64 tile walking the
// chunks in order: C = tau C + k^T (u [v | 1]), float32 in the
// accumulators; stored in float32 (for dm's products in 4) and as the bf16
// operand of the later passes.  64 columns: the walk's registers then
// leave room for more blocks an SM
__global__ void __launch_bounds__(tc::kThreads) walk_fwd_tc(Args<B16> A) {
  __shared__ tc::Smem64 sm;
  const Dims& d = A.d;
  const int j0 = blockIdx.x * kT, e0 = blockIdx.y * kT, bh = blockIdx.z;
  float acc[8][4];
  tc::zero(acc);
  for (int c = 0; c < d.nc; ++c) {
    const Chunk k = chunk_of(d, bh, c);
    const int64_t off = (k.ch * d.dkp + j0) * d.Wp + e0;
    tc::store_tile(A.w.Cp + off, A.w.Cp16 + off, d.Wp, acc);
    if (c == d.nc - 1) break;
    tc::scale(acc, A.w.tau[k.ch]);
    tc::mma(acc, k_ld<true>(A, k, 0, j0), arr_ld<true>(A.w.UV1s, d.Wp, k, 0, e0), 0, k.nv, sm);
  }
}

// 3a: a block per (chunk, 64-row tile t): P = (q' k^T) o W into shared
// memory; [num | den] = [P | sigma q'] [[v | 1] ; [C | n]_prev] per
// 128-column tile, reduced at once to dh . num and den per row; the
// denominator's branch, 1/M, dden and dF's branch term per row
__global__ void __launch_bounds__(tc::kThreads) rows_num_tc(Args<B16> A) {
  __shared__ tc::Smem sm;
  __shared__ float den_s[kT];
  extern __shared__ float4 smem4[];
  const Dims& d = A.d;
  const int rpc = d.Lp / kT, ld = d.Lp + 8;
  const int c = blockIdx.x / rpc, tt = blockIdx.x % rpc, bh = blockIdx.y, t0 = tt * kT;
  const Chunk k = chunk_of(d, bh, c);
  if (t0 >= k.nv) return;
  B16* P = reinterpret_cast<B16*>(smem4);  // [64][ld]
  const Work& w = A.w;
  const B16* cp = w.Cp16 + k.ch * d.dkp * d.Wp;
  along(0, (tt + 1) * kT, PTile{P, ld, t0, A, k, sm});
  __syncthreads();

  float rho[2] = {0.f, 0.f};
  for (int et = 0; et < d.nct; ++et) {
    const int e0 = et * tc::kWide;
    float acc[kWJ][4];
    tc::zero(acc);
    tc::mma(acc, SmemLd{P, ld}, v1_ld<true>(A, k, 0, e0), 0, (tt + 1) * kT, sm);
    if (c > 0)
      tc::mma(acc, arr_ld<false>(w.SQs, d.dkp, k, t0, 0), MatLd<false>{cp, d.Wp, 0, e0}, 0, d.dk,
              sm);
    float part[kWJ][4];
#pragma unroll
    for (int j = 0; j < kWJ; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = tc::row(2 * hh), t = t0 + r, e = e0 + tc::col(j, 0);
        float dh[2] = {0.f, 0.f};
        if (t < k.nv && e < d.dv) {
          const B16* src = A.dh.at(bh, d.H, c * d.L + t) + e;
          dh[0] = ldf(src);
          dh[1] = ldf(src + 1);
        }
        part[j][2 * hh] = dh[0] * acc[j][2 * hh];
        part[j][2 * hh + 1] = dh[1] * acc[j][2 * hh + 1];
        if (e == d.dv) den_s[r] = acc[j][2 * hh];  // dv is even: column e, not e + 1
      }
    rho[0] += tc::row_sum(part, 0);
    rho[1] += tc::row_sum(part, 1);
  }
  __syncthreads();  // den_s
  if (tc::lane() % 4 == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = tc::row(2 * hh), t = t0 + r;
      if (t >= k.nv) continue;
      const int64_t p = k.pos + t;
      const float den = den_s[r];
      const float em = expf(-(w.F[p] + w.g[p]));
      const bool by_den = fabsf(den) >= em;
      const float inv = 1.f / (by_den ? fabsf(den) : em);
      w.invM[p] = inv;
      w.dden[p] = by_den ? -copysignf(1.f, den) * rho[hh] * inv * inv : 0.f;
      w.dFb[p] = by_den ? 0.f : rho[hh] * inv;
    }
  }
}

// D = G [v | 1]^T of rows t0.. and columns s0 .. s0 + 8 NJ: the column sums
// of D o P (64 columns a colpart entry) and dS = D o W over P in the bf16
// [64][ld] tile of shared memory
struct DTile {
  B16* P;
  int ld, t0, tt;
  const Args<B16>& A;
  const Chunk& k;
  tc::Smem& sm;
  template <int NJ>
  __device__ __forceinline__ void operator()(int s0) const {
    const Dims& d = A.d;
    const Work& w = A.w;
    float acc[NJ][4], dp[NJ][4];
    tc::zero(acc);
    tc::mma(acc, arr_ld<false>(w.Gs, d.Wp, k, t0, 0), v1_ld<false>(A, k, s0, 0), 0, d.W, sm);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = tc::row(2 * hh), t = t0 + r, s = s0 + tc::col(j, 0);
        const __nv_bfloat162 pv = *reinterpret_cast<const __nv_bfloat162*>(P + r * ld + s);
        const float pp[2] = {__bfloat162float(pv.x), __bfloat162float(pv.y)};
        float x[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const bool ok = s + i <= t && t < k.nv;
          const float D = acc[j][2 * hh + i];
          dp[j][2 * hh + i] = ok ? D * pp[i] : 0.f;
          x[i] = ok ? D * expf(w.a[k.pos + s + i] - w.g[k.pos + t]) : 0.f;
        }
        store_pair(P + r * ld + s, x[0], x[1]);
      }
    const float cs = tc::col_sum(dp, sm);
    const int rpc = d.Lp / kT;
    if (threadIdx.x < 8 * NJ) w.colpart[(k.ch * rpc + tt) * d.Lp + s0 + threadIdx.x] = cs;
  }
};

// 3c: a block per (chunk, 64-row tile t): P again; D = G [v | 1]^T, the
// column sums of D o P per 64-column tile, dS = D o W over P in shared
// memory; dq = ([dS | sigma G] [k ; [C | n]_prev^T]) / sqrt(dk) per
// 128-column tile
__global__ void __launch_bounds__(tc::kThreads) rows_dq_tc(Args<B16> A) {
  __shared__ tc::Smem sm;
  extern __shared__ float4 smem4[];
  const Dims& d = A.d;
  const int rpc = d.Lp / kT, ld = d.Lp + 8;
  const int c = blockIdx.x / rpc, tt = blockIdx.x % rpc, bh = blockIdx.y, t0 = tt * kT;
  const Chunk k = chunk_of(d, bh, c);
  if (t0 >= k.nv) return;
  B16* P = reinterpret_cast<B16*>(smem4);  // [64][ld]: P, then dS
  const Work& w = A.w;
  const B16* cp = w.Cp16 + k.ch * d.dkp * d.Wp;
  const int kend = (tt + 1) * kT;
  along(0, kend, PTile{P, ld, t0, A, k, sm});
  // each thread reads back only the P elements it wrote
  along(0, kend, DTile{P, ld, t0, tt, A, k, sm});
  __syncthreads();

  for (int jt = 0; jt < d.nkp; ++jt) {
    const int j0 = jt * tc::kWide;
    float acc[kWJ][4];
    tc::zero(acc);
    tc::mma(acc, SmemLd{P, ld}, k_ld<true>(A, k, 0, j0), 0, kend, sm);
    if (c > 0)
      tc::mma(acc, arr_ld<false>(w.SGs, d.Wp, k, t0, 0), MatLd<true>{cp, d.Wp, j0, 0}, 0, d.W,
              sm);
#pragma unroll
    for (int j = 0; j < kWJ; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = t0 + tc::row(2 * hh), jj = j0 + tc::col(j, 0);
        if (t < k.nv && jj < d.dk)
          store_pair(A.dq.at(bh, d.H, c * d.L + t) + jj, acc[j][2 * hh] / d.sqrt_dk,
                     acc[j][2 * hh + 1] / d.sqrt_dk);
      }
  }
}

// 4: d[C | n] at every chunk end, a block per 64 x 128 tile walking the
// chunks in reverse: dC = tau dC + (sigma q')^T G, float32 in the
// accumulators, stored as the bf16 operand of the column passes; then
// <d[C | n]_prev, [C | n]_prev> of the chunk over the tile, for dm
__global__ void __launch_bounds__(tc::kThreads) walk_bwd_tc(Args<B16> A) {
  __shared__ tc::Smem sm;
  const Dims& d = A.d;
  const int j0 = blockIdx.x * kT, e0 = blockIdx.y * tc::kWide, bh = blockIdx.z;
  const int tiles = d.dkt * d.nct, tile_id = blockIdx.x * d.nct + blockIdx.y;
  float acc[kWJ][4];
  tc::zero(acc);
  for (int c = d.nc - 1; c >= 0; --c) {
    const Chunk k = chunk_of(d, bh, c);
    const int64_t off = (k.ch * d.dkp + j0) * d.Wp + e0;
    tc::store_tile(nullptr, A.w.dCn16 + off, d.Wp, acc);
    if (c == 0) break;
    tc::scale(acc, A.w.tau[k.ch]);
    tc::mma(acc, arr_ld<true>(A.w.SQs, d.dkp, k, 0, j0), arr_ld<true>(A.w.Gs, d.Wp, k, 0, e0), 0,
            k.nv, sm);
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < kWJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dot += acc[j][e] * A.w.Cp[off + tc::row(e) * d.Wp + tc::col(j, e)];
    dot = tc::block_sum(dot, sm);
    if (threadIdx.x == 0) A.w.dotpart[k.ch * tiles + tile_id] = dot;
  }
}

// A column pass's tile of P^T (kDS false: (k q'^T) o W^T) or dS^T (([v | 1]
// G^T) o W^T): rows s from s0, columns t0 .. t0 + 8 NJ, 0 above the diagonal
// and past nv, into the bf16 [64][ld] tile of shared memory
template <bool kDS>
struct TTile {
  B16* T;
  int ld, s0;
  const Args<B16>& A;
  const Chunk& k;
  tc::Smem& sm;
  template <int NJ>
  __device__ __forceinline__ void operator()(int t0) const {
    const Dims& d = A.d;
    const Work& w = A.w;
    float acc[NJ][4];
    tc::zero(acc);
    if constexpr (kDS)
      tc::mma(acc, v1_ld<false>(A, k, s0, 0), arr_ld<false>(w.Gs, d.Wp, k, t0, 0), 0, d.W, sm);
    else
      tc::mma(acc, k_ld<false>(A, k, s0, 0), arr_ld<false>(w.Qs, d.dkp, k, t0, 0), 0, d.dk, sm);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int s = s0 + tc::row(2 * hh), t = t0 + tc::col(j, 0);
        float x[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          x[i] = s <= t + i && t + i < k.nv
                     ? acc[j][2 * hh + i] * expf(w.a[k.pos + s] - w.g[k.pos + t + i]) : 0.f;
        store_pair(T + tc::row(2 * hh) * ld + t, x[0], x[1]);
      }
  }
};

// 5a: a block per (chunk, 64-column tile s): P^T = (k q'^T) o W^T into
// shared memory over the rows t >= s, then dv = [P^T | u k] [G ; dC] per
// 128-column tile
__global__ void __launch_bounds__(tc::kThreads) dv_tc(Args<B16> A) {
  __shared__ tc::Smem sm;
  extern __shared__ float4 smem4[];
  const Dims& d = A.d;
  const int rpc = d.Lp / kT, ld = d.Lp + 8;
  const int c = blockIdx.x / rpc, st = blockIdx.x % rpc, bh = blockIdx.y, s0 = st * kT;
  const Chunk k = chunk_of(d, bh, c);
  if (s0 >= k.nv) return;
  B16* PT = reinterpret_cast<B16*>(smem4);  // [64][ld]
  const B16* dcn = A.w.dCn16 + k.ch * d.dkp * d.Wp;
  const int tend = (k.nv + kT - 1) / kT * kT;
  along(s0, tend, TTile<false>{PT, ld, s0, A, k, sm});
  __syncthreads();
  for (int et = 0; et < d.dvt; ++et) {
    const int e0 = et * tc::kWide;
    float acc[kWJ][4];
    tc::zero(acc);
    tc::mma(acc, SmemLd{PT, ld}, arr_ld<true>(A.w.Gs, d.Wp, k, 0, e0), s0, tend, sm);
    if (c < d.nc - 1)
      tc::mma(acc, arr_ld<false>(A.w.UKs, d.dkp, k, s0, 0), MatLd<false>{dcn, d.Wp, 0, e0}, 0,
              d.dk, sm);
#pragma unroll
    for (int j = 0; j < kWJ; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int s = s0 + tc::row(2 * hh), e = e0 + tc::col(j, 0);
        if (s < k.nv && e < d.dv)
          store_pair(A.dv.at(bh, d.H, c * d.L + s) + e, acc[j][2 * hh], acc[j][2 * hh + 1]);
      }
  }
}

// 5b: a block per (chunk, 64-column tile s): dS^T = ([v | 1] G^T) o W^T into
// shared memory over the rows t >= s, then dk = [u [v | 1] | dS^T] [dCn^T ;
// q'] per 128-column tile, with k . (its state term) per row and tile for da
__global__ void __launch_bounds__(tc::kThreads) dk_tc(Args<B16> A) {
  __shared__ tc::Smem sm;
  extern __shared__ float4 smem4[];
  const Dims& d = A.d;
  const int rpc = d.Lp / kT, ld = d.Lp + 8;
  const int c = blockIdx.x / rpc, st = blockIdx.x % rpc, bh = blockIdx.y, s0 = st * kT;
  const Chunk k = chunk_of(d, bh, c);
  if (s0 >= k.nv) return;
  B16* dST = reinterpret_cast<B16*>(smem4);  // [64][ld]
  const Work& w = A.w;
  const B16* dcn = w.dCn16 + k.ch * d.dkp * d.Wp;
  const int tend = (k.nv + kT - 1) / kT * kT;
  along(s0, tend, TTile<true>{dST, ld, s0, A, k, sm});
  __syncthreads();
  for (int jt = 0; jt < d.nkp; ++jt) {
    const int j0 = jt * tc::kWide;
    float acc[kWJ][4];
    tc::zero(acc);
    float part[2] = {0.f, 0.f};
    if (c < d.nc - 1) {
      tc::mma(acc, arr_ld<false>(w.UV1s, d.Wp, k, s0, 0), MatLd<true>{dcn, d.Wp, j0, 0}, 0, d.W,
              sm);
      float kx[kWJ][4];
#pragma unroll
      for (int j = 0; j < kWJ; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int s = s0 + tc::row(2 * hh), jj = j0 + tc::col(j, 0);
          float kv[2] = {0.f, 0.f};
          if (s < k.nv && jj < d.dk) {
            const B16* src = A.k.at(bh, d.H, c * d.L + s) + jj;
            kv[0] = ldf(src);
            kv[1] = ldf(src + 1);
          }
          kx[j][2 * hh] = kv[0] * acc[j][2 * hh];
          kx[j][2 * hh + 1] = kv[1] * acc[j][2 * hh + 1];
        }
      part[0] = tc::row_sum(kx, 0);
      part[1] = tc::row_sum(kx, 1);
    }
    if (tc::lane() % 4 == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int s = s0 + tc::row(2 * hh);
        if (s < k.nv) w.dkpart[(k.pos + s) * d.nkp + jt] = part[hh];
      }
    }
    tc::mma(acc, SmemLd{dST, ld}, arr_ld<true>(w.Qs, d.dkp, k, 0, j0), s0, tend, sm);
#pragma unroll
    for (int j = 0; j < kWJ; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int s = s0 + tc::row(2 * hh), jj = j0 + tc::col(j, 0);
        if (s < k.nv && jj < d.dk)
          store_pair(A.dk.at(bh, d.H, c * d.L + s) + jj, acc[j][2 * hh], acc[j][2 * hh + 1]);
      }
  }
}

// one L-wide bf16 tile (P, dS, P^T or dS^T) of a row or column pass
inline size_t pass_tc_smem(const Dims& d) { return sizeof(B16) * kT * (d.Lp + 8); }

template <typename T>
int run(Args<T> A, cudaStream_t s) {
  const Dims& d = A.d;
  const int BH = d.B * d.H, rpc = d.Lp / kT;
  const int64_t npos = static_cast<int64_t>(BH) * d.Sp;
  const unsigned gate_blocks = static_cast<unsigned>((BH * d.nc + 3) / 4);
  gates_scan<T><<<gate_blocks, 128, 0, s>>>(A);
  gates_exp<T><<<gate_blocks, 128, 0, s>>>(A);
  if constexpr (std::is_same_v<T, B16>) {
    if (d.tc) {
      const size_t sm = pass_tc_smem(d);
      cudaError_t err = allow_smem(rows_num_tc, sm);
      if (err == cudaSuccess) err = allow_smem(rows_dq_tc, sm);
      if (err == cudaSuccess) err = allow_smem(dv_tc, sm);
      if (err == cudaSuccess) err = allow_smem(dk_tc, sm);
      if (err != cudaSuccess) return err;
      const unsigned npos_u = static_cast<unsigned>(npos);
      prep_pos_tc<<<npos_u, 128, 0, s>>>(A);
      walk_fwd_tc<<<dim3(d.dkt, d.Wp / kT, BH), tc::kThreads, 0, s>>>(A);
      rows_num_tc<<<dim3(rpc * d.nc, BH), tc::kThreads, sm, s>>>(A);
      prep_g_tc<<<npos_u, 128, 0, s>>>(A);
      rows_dq_tc<<<dim3(rpc * d.nc, BH), tc::kThreads, sm, s>>>(A);
      walk_bwd_tc<<<dim3(d.dkt, d.nct, BH), tc::kThreads, 0, s>>>(A);
      dv_tc<<<dim3(rpc * d.nc, BH), tc::kThreads, sm, s>>>(A);
      dk_tc<<<dim3(rpc * d.nc, BH), tc::kThreads, sm, s>>>(A);
      gates_bwd<T><<<gate_blocks, 128, 0, s>>>(A, 1);
      return static_cast<int>(cudaGetLastError());
    }
  }
  walk_fwd<T><<<dim3(d.dkt, d.nct, BH), kThreads, 0, s>>>(A);
  p_tiles<T><<<dim3(rpc, rpc, BH * d.nc), kThreads, 0, s>>>(A);
  num<T><<<dim3(rpc * d.nc, d.nct, BH), kThreads, 0, s>>>(A);
  rows<T><<<static_cast<unsigned>((npos + 255) / 256), 256, 0, s>>>(A);
  g_fill<T><<<static_cast<unsigned>(npos), 256, 0, s>>>(A);
  ds_tiles<T><<<dim3(rpc, rpc, BH * d.nc), kThreads, 0, s>>>(A);
  walk_bwd<T><<<dim3(d.dkt, d.nct, BH), kThreads, 0, s>>>(A);
  dq_tiles<T><<<dim3(rpc * d.nc, d.dkt, BH), kThreads, 0, s>>>(A);
  dk_tiles<T><<<dim3(rpc * d.nc, d.dkt, BH), kThreads, 0, s>>>(A);
  dv_tiles<T><<<dim3(rpc * d.nc, d.dvt, BH), kThreads, 0, s>>>(A);
  gates_bwd<T><<<gate_blocks, 128, 0, s>>>(A, 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* const* in, void* const* out, void* work, const Dims& d,
           const long long* strides, cudaStream_t s) {
  Args<T> A;
  Ten<const T>* ins[6] = {&A.q, &A.k, &A.v, &A.ig, &A.fg, &A.dh};
  Ten<T>* outs[5] = {&A.dq, &A.dk, &A.dv, &A.di, &A.df};
  for (int t = 0; t < 6; ++t)
    *ins[t] = {static_cast<const T*>(in[t]), strides[3 * t], strides[3 * t + 1],
               strides[3 * t + 2]};
  for (int t = 0; t < 5; ++t)
    *outs[t] = {static_cast<T*>(out[t]), strides[18 + 3 * t], strides[19 + 3 * t],
                strides[20 + 3 * t]};
  A.d = d;
  layout(d, static_cast<char*>(work), &A.w);
  return run<T>(A, s);
}

}  // namespace
}  // namespace ham

// Bytes of float32 scratch ham_mlstm_bwd needs, written to *bytes, and
// whether it takes the tensor-core route (1) or the CUDA-core one (0),
// written to *tc.  allow_tc 0 asks for the CUDA-core route.
extern "C" int ham_mlstm_bwd_workspace(int B, int H, int S, int dk, int dv, int L, int dtype,
                                       int allow_tc, long long* bytes, int* tc) {
  if (B < 0 || H < 0 || S < 0 || dk < 1 || dv < 1 || L < 1) return ham::kUnsupported;
  ham::Work w;
  const ham::Dims d = ham::make_dims(B, H, S, dk, dv, L, dtype, allow_tc);
  *bytes = static_cast<long long>(ham::layout(d, nullptr, &w));
  *tc = d.tc;
  return 0;
}

// (dq, dk, dv, di, df) of the mLSTM forward at (q, k, v, i, f) with no
// initial state, for the gradient dh of h.  q, k (B, H, S, dk), v and dh
// (B, H, S, dv), the gates (B, H, S), all of dtype `dtype`, read through
// the (b, h, s) strides in `strides` (q k v i f dh dq dk dv di df, 3 each;
// the last dim of the 4-d tensors has unit stride); the gradients are
// written in the same way.  `work`: ham_mlstm_bwd_workspace bytes for the
// same arguments; allow_tc as there.
extern "C" int ham_mlstm_bwd(const void* q, const void* k, const void* v, const void* ig,
                             const void* fg, const void* dh, void* dq, void* dk, void* dv,
                             void* di, void* df, void* work, int B, int H, int S, int dk_,
                             int dv_, int L, int dtype, int allow_tc, const long long* strides,
                             int device, void* stream) {
  if (dk_ < 1 || dv_ < 1 || L < 1) return ham::kUnsupported;
  if (B == 0 || H == 0 || S == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const void* in[6] = {q, k, v, ig, fg, dh};
  void* out[5] = {dq, dk, dv, di, df};
  const ham::Dims d = ham::make_dims(B, H, S, dk_, dv_, L, dtype, allow_tc);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ham::kF32: return ham::launch<float>(in, out, work, d, strides, s);
    case ham::kBF16: return ham::launch<__nv_bfloat16>(in, out, work, d, strides, s);
    default: return ham::kUnsupported;
  }
}
