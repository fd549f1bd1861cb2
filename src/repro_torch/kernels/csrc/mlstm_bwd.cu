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
// Twelve launches, all float32 on the CUDA cores (both dtypes convert each
// operand to float32 as it is staged; each gradient is rounded once):
//  1 gates_fwd     a thread per (sequence, head): F, a, g, sigma, u, tau;
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
//  9 dq, 10 dk, 11 dv  a block per (chunk, 64 rows, 64 columns);
// 12 gates_bwd     a thread per (sequence, head): da, the m chain, the
//                  reverse cumsum of dF, log sigmoid', di and df.
// Every sum runs in a fixed order with no atomics: two calls give the same
// bits.  Positions past S in the last chunk read zeros and write nothing.
// Bound on an H100: operations, about 2x the forward's products
// (chip_smoke.py's mlstm_bwd_flops); this kernel forms P and D twice and
// the states once more, on the CUDA cores, so it runs far from the bound;
// tensor-core tiles are later work.
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
  int nc, Lp, Sp, W, Wp, nct, dkt, dkp, dvt;
  float sqrt_dk;
};

inline Dims make_dims(int B, int H, int S, int dk, int dv, int L) {
  Dims d{B, H, S, dk, dv, L};
  d.nc = (S + L - 1) / L;
  d.Lp = (L + kT - 1) / kT * kT;
  d.Sp = d.nc * d.Lp;
  d.W = dv + 1;
  d.Wp = (d.W + kT - 1) / kT * kT;
  d.nct = d.Wp / kT;
  d.dkt = (dk + kT - 1) / kT;
  d.dkp = d.dkt * kT;
  d.dvt = (dv + kT - 1) / kT;
  d.sqrt_dk = sqrtf(static_cast<float>(dk));
  return d;
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
  float* dotpart;                     // per chunk and state tile: <dCn, [C | n]>
};

inline size_t layout(const Dims& d, char* base, Work* w) {
  const size_t BH = static_cast<size_t>(d.B) * d.H, pos = BH * d.Sp, ch = BH * d.nc;
  const size_t sizes[] = {
      pos, pos, pos, pos, pos, ch,
      ch * d.dkp * d.Wp, ch * d.dkp * d.Wp,
      ch * d.Lp * d.Lp, ch * d.Lp * d.Lp,
      pos * d.nct, pos * d.nct, pos, pos,
      pos, pos, pos, pos,
      pos * d.Wp,
      ch * (d.Lp / kT) * d.Lp, pos * d.dkt, ch * d.dkt * d.nct};
  float** slots[] = {&w->F, &w->a, &w->g, &w->sig, &w->u, &w->tau, &w->Cp, &w->dCn, &w->P,
                     &w->dS, &w->ri, &w->re, &w->deni, &w->dene, &w->invM, &w->dden, &w->dFb,
                     &w->dss, &w->G, &w->colpart, &w->dkpart, &w->dotpart};
  size_t at = 0;
  for (int i = 0; i < 22; ++i) {
    if (base) *slots[i] = reinterpret_cast<float*>(base + at);
    at += (sizes[i] * sizeof(float) + 255) / 256 * 256;
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

// -- 1: gate quantities -------------------------------------------------------

template <typename T>
__global__ void gates_fwd(Args<T> A) {
  const Dims& d = A.d;
  const int bh = blockIdx.x * blockDim.x + threadIdx.x;
  if (bh >= d.B * d.H) return;
  const Work& w = A.w;
  float mp = -INFINITY;
  for (int c = 0; c < d.nc; ++c) {
    const int nv = valid_in(d, c);
    const int64_t base = static_cast<int64_t>(bh) * d.Sp + c * d.Lp;
    float F = 0.f, acm = -INFINITY, gL = 0.f, FL = 0.f;
    for (int r = 0; r < d.Lp; ++r) {
      const int64_t p = base + r;
      if (r >= nv) {
        w.F[p] = w.a[p] = w.g[p] = w.sig[p] = w.u[p] = 0.f;
        continue;
      }
      F += logsig(ldf(A.fg.at(bh, d.H, c * d.L + r)));
      const float a = ldf(A.ig.at(bh, d.H, c * d.L + r)) - F;
      acm = fmaxf(acm, a);
      const float g = fmaxf(mp, acm);
      w.F[p] = F;
      w.a[p] = a;
      w.g[p] = g;
      w.sig[p] = expf(mp - g);
      gL = g;
      FL = F;
    }
    for (int r = 0; r < nv; ++r) w.u[base + r] = expf(w.a[base + r] - gL);
    w.tau[bh * d.nc + c] = expf(mp - gL);
    mp = FL + gL;
  }
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
  if (threadIdx.x < kT) A.w.dkpart[(pos + st * kT + threadIdx.x) * d.dkt + jt] = sum;
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

// -- 12: the gates' gradients --------------------------------------------------

template <typename T>
__global__ void gates_bwd(Args<T> A) {
  const Dims& d = A.d;
  const int bh = blockIdx.x * blockDim.x + threadIdx.x;
  if (bh >= d.B * d.H) return;
  const Work& w = A.w;
  const int rpc = d.Lp / kT, tiles = d.dkt * d.nct;
  float dm_next = 0.f;   // gradient of the m carried out of chunk c into c + 1
  for (int c = d.nc - 1; c >= 0; --c) {
    const int nv = valid_in(d, c);
    const int64_t ch = static_cast<int64_t>(bh) * d.nc + c;
    const int64_t pos = static_cast<int64_t>(bh) * d.Sp + c * d.Lp;
    float dls = 0.f;   // sum of dF over this chunk's positions >= r
    for (int r = nv - 1; r >= 0; --r) {
      float da = 0.f;
      for (int tt = r / kT; tt < rpc; ++tt) da += w.colpart[(ch * rpc + tt) * d.Lp + r];
      for (int jt = 0; jt < d.dkt; ++jt) da += w.dkpart[(pos + r) * d.dkt + jt];
      float dF = w.dFb[pos + r] - da;
      if (r == d.L - 1) dF += dm_next;
      dls += dF;
      const float f = ldf(A.fg.at(bh, d.H, c * d.L + r));
      store(A.df.at(bh, d.H, c * d.L + r), dls / (1.f + expf(f)));
      store(A.di.at(bh, d.H, c * d.L + r), da);
    }
    float dm = 0.f;
    for (int r = 0; r < nv; ++r) dm += w.dss[pos + r];
    float dot = 0.f;
    for (int t = 0; t < tiles; ++t) dot += w.dotpart[ch * tiles + t];
    dm_next = dm + w.tau[ch] * dot;
  }
}

template <typename T>
int run(Args<T> A, cudaStream_t s) {
  const Dims& d = A.d;
  const int BH = d.B * d.H, rpc = d.Lp / kT;
  const int64_t npos = static_cast<int64_t>(BH) * d.Sp;
  gates_fwd<T><<<(BH + 31) / 32, 32, 0, s>>>(A);
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
  gates_bwd<T><<<(BH + 31) / 32, 32, 0, s>>>(A);
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

// Bytes of float32 scratch ham_mlstm_bwd needs, written to *bytes.
extern "C" int ham_mlstm_bwd_workspace(int B, int H, int S, int dk, int dv, int L,
                                       long long* bytes) {
  if (B < 0 || H < 0 || S < 0 || dk < 1 || dv < 1 || L < 1) return ham::kUnsupported;
  ham::Work w;
  *bytes = static_cast<long long>(ham::layout(ham::make_dims(B, H, S, dk, dv, L), nullptr, &w));
  return 0;
}

// (dq, dk, dv, di, df) of the mLSTM forward at (q, k, v, i, f) with no
// initial state, for the gradient dh of h.  q, k (B, H, S, dk), v and dh
// (B, H, S, dv), the gates (B, H, S), all of dtype `dtype`, read through
// the (b, h, s) strides in `strides` (q k v i f dh dq dk dv di df, 3 each;
// the last dim of the 4-d tensors has unit stride); the gradients are
// written in the same way.  `work`: ham_mlstm_bwd_workspace bytes.
extern "C" int ham_mlstm_bwd(const void* q, const void* k, const void* v, const void* ig,
                             const void* fg, const void* dh, void* dq, void* dk, void* dv,
                             void* di, void* df, void* work, int B, int H, int S, int dk_,
                             int dv_, int L, int dtype, const long long* strides, int device,
                             void* stream) {
  if (dk_ < 1 || dv_ < 1 || L < 1) return ham::kUnsupported;
  if (B == 0 || H == 0 || S == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const void* in[6] = {q, k, v, ig, fg, dh};
  void* out[5] = {dq, dk, dv, di, df};
  const ham::Dims d = ham::make_dims(B, H, S, dk_, dv_, L);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ham::kF32: return ham::launch<float>(in, out, work, d, strides, s);
    case ham::kBF16: return ham::launch<__nv_bfloat16>(in, out, work, d, strides, s);
    default: return ham::kUnsupported;
  }
}
