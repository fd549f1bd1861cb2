// Mamba2 SSD chunked-scan backward for Hopper (sm_90a): the gradient of
// csrc/mamba2_ssd.cu's forward called with no initial state, for the
// gradient of y alone (the final state's gradient is not taken).
//
// The Pallas TPU kernel repro/kernels/mamba2_ssd.py (_ssd_kernel) has no
// backward: the reference trains through XLA's autodiff of its plain
// chunked form (repro/models/mamba2.py ssd_chunked).  Per (sequence, head)
// with group g = h / (H / G), chunks of L positions, Lc the in-chunk cumsum
// of A dt, LL its last value, s <= t inside a chunk:
//   M_ts = (C_t . B_s) e^{Lc_t - Lc_s} dt_s,
//   y_t = sum_s M_ts x_s + e^{Lc_t} C_t h_prev + D x_t,
//   h_next = e^{LL} h_prev + sum_s w_s B_s x_s^T,  w_s = e^{LL - Lc_s} dt_s.
// Given dy: dM_ts = dy_t . x_s, dCB = dM e^{Lc_t - Lc_s} dt_s and
//   dx = M^T dy + w (B dh_next) + D dy,  dC = dCB B + e^{Lc} dy h_prev^T,
//   dB = dCB^T C + w (x dh_next^T),  dh_prev = e^{LL} dh_next + sum_t e^{Lc_t} C_t dy_t^T,
// dt enters three times: as the causal tile's weight dt_s, as the state
// weight w_s and through Lc (d Lc_t = rowsum_t(dM o M) - colsum_t(dM o M)
// + e^{Lc_t} C_t . (h_prev dy_t) - w_t dw_t, plus d LL at the chunk's last
// position; d log(lambda) is its reverse cumsum, ddt gets A times it and
// dA = sum dt d log(lambda)); dD = sum x dy.
// Launches, all float32 on the CUDA cores (each operand converted as it
// is staged; each gradient rounded once):
//  1 gates     a thread per (sequence, head): Lc, e^{Lc}, e^{LL - Lc}, w;
//  2 walk_fwd  a block per (sequence, head): h at every chunk start (the
//              bf16 forward keeps it only as bf16), walked in order;
//  3 walk_bwd  the same for dh at every chunk end, in reverse, with
//              <dh_next, h_prev> for d LL;
//  4 cb_tiles  C B^T per (sequence, group, chunk), on and below the
//              diagonal: one tile for all the group's heads;
//  5 dm_tiles  per (sequence, head, chunk) tile: dy x^T, M and dCB stored,
//              row and column sums of dM o M and of dM o CB o decay;
//  6 dc, 7 db, 8 dx  a block per (chunk, 64 positions, 64 columns):
//              dC and dB per head, dx;
//  9 gates_bwd a thread per (sequence, head): d Lc, its reverse cumsum,
//              ddt, and the head's partial sums of dA and dD;
// 10 reduce    dB and dC summed over each group's heads, dA and dD over
//              the sequences, in a fixed order.
// No float atomics: every sum runs in a fixed order, so two calls give the
// same bits.  Positions past S in the last chunk read zeros (dt too) and
// write nothing.  Bound on an H100: bytes (x, dt, B, C, dy read, every
// gradient written; the products are small at N = P = 64); this kernel
// stores M and dCB per head, which moves far more, and runs on the CUDA
// cores: a fused, tensor-core design is later work.
#include <type_traits>

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
  int B, S, H, G, N, P, L;
  int nc, Lp, Sp, Nt, Pt, Np, Pp, hpg, rpc;
};

inline Dims make_dims(int B, int S, int H, int G, int N, int P, int L) {
  Dims d{B, S, H, G, N, P, L};
  d.nc = (S + L - 1) / L;
  d.Lp = (L + kT - 1) / kT * kT;
  d.Sp = d.nc * d.Lp;
  d.Nt = (N + kT - 1) / kT;
  d.Pt = (P + kT - 1) / kT;
  d.Np = d.Nt * kT;
  d.Pp = d.Pt * kT;
  d.hpg = H / G;
  d.rpc = d.Lp / kT;
  return d;
}

struct Work {
  float *Lc, *E, *dec, *w, *dt;       // per padded position (BH x Sp)
  float* eLL;                          // per chunk (BH x nc)
  float *hp, *dhn;                     // h at each chunk start, dh at each chunk end
  float* CB;                           // per (sequence, group, chunk), Lp x Lp
  float *M, *dCB;                      // per (sequence, head, chunk), Lp x Lp
  float *rowpart, *colpart, *ddtpart;  // per position and 64-tile
  float *epspart, *dwpart;             // per position and N tile
  float *dBh, *dCh;                    // per position, Np wide
  float *dDpart, *dotpart;             // per tile
  float *dAh, *dDh;                    // per (sequence, head)
};

inline size_t layout(const Dims& d, char* base, Work* w) {
  const size_t BH = static_cast<size_t>(d.B) * d.H, pos = BH * d.Sp, ch = BH * d.nc;
  const size_t sq = static_cast<size_t>(d.Lp) * d.Lp;
  const size_t sizes[] = {
      pos, pos, pos, pos, pos, ch,
      ch * d.Np * d.Pp, ch * d.Np * d.Pp,
      static_cast<size_t>(d.B) * d.G * d.nc * sq, ch * sq, ch * sq,
      pos * d.rpc, pos * d.rpc, pos * d.rpc,
      pos * d.Nt, pos * d.Nt,
      pos * d.Np, pos * d.Np,
      ch * d.rpc * d.Pt, ch * d.Nt * d.Pt,
      BH, BH};
  float** slots[] = {&w->Lc, &w->E, &w->dec, &w->w, &w->dt, &w->eLL, &w->hp, &w->dhn,
                     &w->CB, &w->M, &w->dCB, &w->rowpart, &w->colpart, &w->ddtpart,
                     &w->epspart, &w->dwpart, &w->dBh, &w->dCh, &w->dDpart, &w->dotpart,
                     &w->dAh, &w->dDh};
  size_t at = 0;
  for (int i = 0; i < 22; ++i) {
    if (base) *slots[i] = reinterpret_cast<float*>(base + at);
    at += (sizes[i] * sizeof(float) + 255) / 256 * 256;
  }
  return at;
}

// a (B, S, K, ...) tensor through its (b, s, k) strides
template <typename P>
struct Ten {
  P* p;
  int64_t sb, ss, sk;
  __device__ __forceinline__ P* at(int b, int s, int k) const {
    return p + static_cast<int64_t>(b) * sb + static_cast<int64_t>(s) * ss +
           static_cast<int64_t>(k) * sk;
  }
};

template <typename T>
struct Args {
  Ten<const T> x, Bm, Cm, dy;
  Ten<const float> dt;
  const float *A, *D;
  Ten<T> dx, dBm, dCm;
  Ten<float> ddt;
  float *dA, *dD;
  Dims d;
  Work w;
};

__device__ __forceinline__ int valid_in(const Dims& d, int c) {
  const int left = d.S - c * d.L;
  return left < d.L ? left : d.L;
}

// -- loaders: `x` is a (B, S, K, width) operand at sequence b, index k (a
// head or a group), positions c L + (0 .. nvalid) --------------------------

// x_s[j] at (row s0 + r, k = j)
template <typename T>
struct PosRow {
  static constexpr bool kKFast = true;
  Ten<const T> x; int b, k, c, L, s0, nvalid, width;
  __device__ float operator()(int r, int j) const {
    const int s = s0 + r;
    return s < nvalid && j < width ? ldf(x.at(b, c * L + s, k) + j) : 0.f;
  }
};

// x_s[j] at (k = j, column s0 + cc)
template <typename T>
struct PosCol {
  static constexpr bool kKFast = true;
  Ten<const T> x; int b, k, c, L, s0, nvalid, width;
  __device__ float operator()(int j, int cc) const {
    const int s = s0 + cc;
    return s < nvalid && j < width ? ldf(x.at(b, c * L + s, k) + j) : 0.f;
  }
};

// x_s[j0 + cc] at (k = s, column cc)
template <typename T>
struct PosK {
  static constexpr bool kKFast = false;
  Ten<const T> x; int b, k, c, L, nvalid, width, j0;
  __device__ float operator()(int s, int cc) const {
    const int j = j0 + cc;
    return s < nvalid && j < width ? ldf(x.at(b, c * L + s, k) + j) : 0.f;
  }
};

// scale_s x_s[j0 + r] at (row r, k = s)
template <typename T>
struct PosT {
  static constexpr bool kKFast = false;
  Ten<const T> x; const float* scale; int b, k, c, L, nvalid, width, j0;
  __device__ float operator()(int r, int s) const {
    const int j = j0 + r;
    return s < nvalid && j < width ? scale[s] * ldf(x.at(b, c * L + s, k) + j) : 0.f;
  }
};

// -- 1: gate quantities -------------------------------------------------------

template <typename T>
__global__ void gates(Args<T> a) {
  const Dims& d = a.d;
  const int bh = blockIdx.x * blockDim.x + threadIdx.x;
  if (bh >= d.B * d.H) return;
  const int b = bh / d.H, h = bh % d.H;
  const float A = a.A[h];
  const Work& w = a.w;
  for (int c = 0; c < d.nc; ++c) {
    const int nv = valid_in(d, c);
    const int64_t base = static_cast<int64_t>(bh) * d.Sp + c * d.Lp;
    float Lc = 0.f;
    for (int r = 0; r < d.Lp; ++r) {
      const float dt = r < nv ? *a.dt.at(b, c * d.L + r, h) : 0.f;
      Lc += A * dt;
      w.Lc[base + r] = Lc;
      w.dt[base + r] = dt;
    }
    for (int r = 0; r < d.Lp; ++r) {
      w.E[base + r] = expf(w.Lc[base + r]);
      w.dec[base + r] = expf(Lc - w.Lc[base + r]);
      w.w[base + r] = w.dec[base + r] * w.dt[base + r];
    }
    w.eLL[bh * d.nc + c] = expf(Lc);
  }
}

// -- 2: h at every chunk start ----------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) walk_fwd(Args<T> a) {
  __shared__ Smem sm;
  const Dims& d = a.d;
  const int n0 = blockIdx.x * kT, p0 = blockIdx.y * kT, bh = blockIdx.z;
  const int b = bh / d.H, h = bh % d.H, g = h / d.hpg;
  float acc[4][4];
  tile::zero(acc);
  for (int c = 0; c < d.nc; ++c) {
    const int64_t ch = static_cast<int64_t>(bh) * d.nc + c;
    tile::store_tile(a.w.hp + (ch * d.Np + n0) * d.Pp + p0, d.Pp, acc);
    if (c == d.nc - 1) break;
    tile::scale(acc, a.w.eLL[ch]);
    const int nv = valid_in(d, c);
    PosT<T> A{a.Bm, a.w.w + static_cast<int64_t>(bh) * d.Sp + c * d.Lp, b, g, c, d.L, nv, d.N,
              n0};
    PosK<T> B{a.x, b, h, c, d.L, nv, d.P, p0};
    tile::mma(acc, A, B, 0, nv, sm);
  }
}

// -- 3: dh at every chunk end, in reverse ---------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) walk_bwd(Args<T> a) {
  __shared__ Smem sm;
  const Dims& d = a.d;
  const int n0 = blockIdx.x * kT, p0 = blockIdx.y * kT, bh = blockIdx.z;
  const int b = bh / d.H, h = bh % d.H, g = h / d.hpg;
  const int tiles = d.Nt * d.Pt, tile_id = blockIdx.x * d.Pt + blockIdx.y;
  float acc[4][4];
  tile::zero(acc);
  for (int c = d.nc - 1; c >= 0; --c) {
    const int64_t ch = static_cast<int64_t>(bh) * d.nc + c;
    const int64_t off = (ch * d.Np + n0) * d.Pp + p0;
    tile::store_tile(a.w.dhn + off, d.Pp, acc);
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dot += acc[i][j] * a.w.hp[off + (4 * tile::ty() + i) * d.Pp + 4 * tile::tx() + j];
    dot = tile::reduce_block(dot, sm);
    if (threadIdx.x == 0) a.w.dotpart[ch * tiles + tile_id] = dot;
    if (c == 0) break;
    tile::scale(acc, a.w.eLL[ch]);
    const int nv = valid_in(d, c);
    PosT<T> A{a.Cm, a.w.E + static_cast<int64_t>(bh) * d.Sp + c * d.Lp, b, g, c, d.L, nv, d.N,
              n0};
    PosK<T> B{a.dy, b, h, c, d.L, nv, d.P, p0};
    tile::mma(acc, A, B, 0, nv, sm);
  }
}

// -- 4: C B^T per (sequence, group, chunk) ---------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) cb_tiles(Args<T> a) {
  __shared__ Smem sm;
  const Dims& d = a.d;
  const int tt = blockIdx.x, st = blockIdx.y;
  if (st > tt) return;
  const int bg = blockIdx.z / d.nc, c = blockIdx.z % d.nc, b = bg / d.G, g = bg % d.G;
  const int nv = valid_in(d, c);
  float acc[4][4];
  tile::zero(acc);
  PosRow<T> A{a.Cm, b, g, c, d.L, tt * kT, nv, d.N};
  PosCol<T> B{a.Bm, b, g, c, d.L, st * kT, nv, d.N};
  tile::mma(acc, A, B, 0, d.N, sm);
  float* out = a.w.CB + static_cast<int64_t>(blockIdx.z) * d.Lp * d.Lp;
  tile::store_tile(out + static_cast<int64_t>(tt * kT) * d.Lp + st * kT, d.Lp, acc);
}

// -- 5: dM = dy x^T; M, dCB and the sums of the decay's gradient ---------------

template <typename T>
__global__ void __launch_bounds__(kThreads) dm_tiles(Args<T> a) {
  __shared__ Smem sm;
  const Dims& d = a.d;
  const int tt = blockIdx.x, st = blockIdx.y;
  if (st > tt) return;
  const int bh = blockIdx.z / d.nc, c = blockIdx.z % d.nc, b = bh / d.H, h = bh % d.H;
  const int nv = valid_in(d, c);
  float acc[4][4];
  tile::zero(acc);
  PosRow<T> A{a.dy, b, h, c, d.L, tt * kT, nv, d.P};
  PosCol<T> B{a.x, b, h, c, d.L, st * kT, nv, d.P};
  tile::mma(acc, A, B, 0, d.P, sm);
  const int64_t pos = static_cast<int64_t>(bh) * d.Sp + c * d.Lp;
  const int64_t sq = static_cast<int64_t>(d.Lp) * d.Lp;
  const float* CB = a.w.CB + (static_cast<int64_t>(b * d.G + h / d.hpg) * d.nc + c) * sq;
  float* M = a.w.M + static_cast<int64_t>(blockIdx.z) * sq;
  float* dCB = a.w.dCB + static_cast<int64_t>(blockIdx.z) * sq;
  float rp[4] = {0.f, 0.f, 0.f, 0.f}, cp[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = tt * kT + 4 * tile::ty() + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = st * kT + 4 * tile::tx() + j;
      const int64_t at = static_cast<int64_t>(t) * d.Lp + s;
      float m = 0.f, dcb = 0.f;
      if (s <= t && t < nv) {
        const float decay = expf(a.w.Lc[pos + t] - a.w.Lc[pos + s]), ds = a.w.dt[pos + s];
        const float cb = CB[at];
        m = cb * decay * ds;
        dcb = acc[i][j] * decay * ds;
        rp[i] += acc[i][j] * m;
        cp[j] += acc[i][j] * m;
        dp[j] += acc[i][j] * cb * decay;
      }
      M[at] = m;
      dCB[at] = dcb;
    }
  }
  const int rpc = d.rpc, tid = threadIdx.x;
  const float rs = tile::reduce_rows(rp, sm);
  if (tid < kT) a.w.rowpart[(pos + tt * kT + tid) * rpc + st] = rs;
  const float cs = tile::reduce_cols(cp, sm);
  if (tid < kT) a.w.colpart[(pos + st * kT + tid) * rpc + tt] = cs;
  const float ds = tile::reduce_cols(dp, sm);
  if (tid < kT) a.w.ddtpart[(pos + st * kT + tid) * rpc + tt] = ds;
}

// -- 6: dC = dCB B + e^{Lc} dy h_prev^T, and C . (h_prev dy) -----------------

template <typename T>
__global__ void __launch_bounds__(kThreads) dc_tiles(Args<T> a) {
  __shared__ Smem sm;
  const Dims& d = a.d;
  const int c = blockIdx.x / d.rpc, tt = blockIdx.x % d.rpc, nt = blockIdx.y, bh = blockIdx.z;
  const int n0 = nt * kT, b = bh / d.H, h = bh % d.H, g = h / d.hpg, nv = valid_in(d, c);
  const int64_t ch = static_cast<int64_t>(bh) * d.nc + c;
  const int64_t pos = static_cast<int64_t>(bh) * d.Sp + c * d.Lp;
  float intra[4][4], inter[4][4];
  tile::zero(intra);
  tile::zero(inter);
  if (tt * kT < nv) {
    MatRowK A{a.w.dCB + ch * d.Lp * d.Lp, d.Lp, tt * kT};
    PosK<T> B{a.Bm, b, g, c, d.L, nv, d.N, n0};
    tile::mma(intra, A, B, 0, min((tt + 1) * kT, nv), sm);
    if (c > 0) {
      PosRow<T> A1{a.dy, b, h, c, d.L, tt * kT, nv, d.P};
      MatTK B1{a.w.hp + ch * d.Np * d.Pp, d.Pp, n0, d.Np};
      tile::mma(inter, A1, B1, 0, d.P, sm);
    }
  }
  float part[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = tt * kT + 4 * tile::ty() + i;
    part[i] = 0.f;
    const float E = a.w.E[pos + t];
    float* out = a.w.dCh + (pos + t) * d.Np;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tile::tx() + j;
      const float x = E * inter[i][j];
      out[n] = intra[i][j] + x;
      if (t < nv && n < d.N) part[i] += ldf(a.Cm.at(b, c * d.L + t, g) + n) * x;
    }
  }
  const float eps = tile::reduce_rows(part, sm);
  if (threadIdx.x < kT) a.w.epspart[(pos + tt * kT + threadIdx.x) * d.Nt + nt] = eps;
}

// -- 7: dB = dCB^T C + w (x dh_next^T), and dw = B . (dh_next x) -------------

template <typename T>
__global__ void __launch_bounds__(kThreads) db_tiles(Args<T> a) {
  __shared__ Smem sm;
  const Dims& d = a.d;
  const int c = blockIdx.x / d.rpc, st = blockIdx.x % d.rpc, nt = blockIdx.y, bh = blockIdx.z;
  const int n0 = nt * kT, b = bh / d.H, h = bh % d.H, g = h / d.hpg, nv = valid_in(d, c);
  const int64_t ch = static_cast<int64_t>(bh) * d.nc + c;
  const int64_t pos = static_cast<int64_t>(bh) * d.Sp + c * d.Lp;
  float intra[4][4], inter[4][4];
  tile::zero(intra);
  tile::zero(inter);
  if (st * kT < nv) {
    MatT A{a.w.dCB + ch * d.Lp * d.Lp, d.Lp, st * kT};
    PosK<T> B{a.Cm, b, g, c, d.L, nv, d.N, n0};
    tile::mma(intra, A, B, st * kT, nv, sm);
    if (c < d.nc - 1) {
      PosRow<T> A1{a.x, b, h, c, d.L, st * kT, nv, d.P};
      MatTK B1{a.w.dhn + ch * d.Np * d.Pp, d.Pp, n0, d.Np};
      tile::mma(inter, A1, B1, 0, d.P, sm);
    }
  }
  float part[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = st * kT + 4 * tile::ty() + i;
    part[i] = 0.f;
    const float w = a.w.w[pos + s];
    float* out = a.w.dBh + (pos + s) * d.Np;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tile::tx() + j;
      out[n] = intra[i][j] + w * inter[i][j];
      if (s < nv && n < d.N) part[i] += ldf(a.Bm.at(b, c * d.L + s, g) + n) * inter[i][j];
    }
  }
  const float dw = tile::reduce_rows(part, sm);
  if (threadIdx.x < kT) a.w.dwpart[(pos + st * kT + threadIdx.x) * d.Nt + nt] = dw;
}

// -- 8: dx = M^T dy + w (B dh_next) + D dy, and the tile's sum of x dy --------

template <typename T>
__global__ void __launch_bounds__(kThreads) dx_tiles(Args<T> a) {
  __shared__ Smem sm;
  const Dims& d = a.d;
  const int c = blockIdx.x / d.rpc, st = blockIdx.x % d.rpc, pt = blockIdx.y, bh = blockIdx.z;
  const int p0 = pt * kT, b = bh / d.H, h = bh % d.H, g = h / d.hpg, nv = valid_in(d, c);
  const int64_t ch = static_cast<int64_t>(bh) * d.nc + c;
  const int64_t pos = static_cast<int64_t>(bh) * d.Sp + c * d.Lp;
  float* dDpart = a.w.dDpart + (ch * d.rpc + st) * d.Pt + pt;
  if (st * kT >= nv) {
    if (threadIdx.x == 0) *dDpart = 0.f;
    return;
  }
  float intra[4][4], inter[4][4];
  tile::zero(intra);
  tile::zero(inter);
  MatT A{a.w.M + ch * d.Lp * d.Lp, d.Lp, st * kT};
  PosK<T> B{a.dy, b, h, c, d.L, nv, d.P, p0};
  tile::mma(intra, A, B, st * kT, nv, sm);
  if (c < d.nc - 1) {
    PosRow<T> A1{a.Bm, b, g, c, d.L, st * kT, nv, d.N};
    MatKCol B1{a.w.dhn + ch * d.Np * d.Pp, d.Pp, p0, d.Pp};
    tile::mma(inter, A1, B1, 0, d.N, sm);
  }
  const float D = a.D[h];
  float xdy = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = st * kT + 4 * tile::ty() + i;
    if (s >= nv) continue;
    const float w = a.w.w[pos + s];
    const T* x = a.x.at(b, c * d.L + s, h);
    const T* dy = a.dy.at(b, c * d.L + s, h);
    T* out = a.dx.at(b, c * d.L + s, h);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + 4 * tile::tx() + j;
      if (p >= d.P) continue;
      const float g_ = ldf(dy + p);
      xdy += ldf(x + p) * g_;
      store(out + p, intra[i][j] + w * inter[i][j] + D * g_);
    }
  }
  xdy = tile::reduce_block(xdy, sm);
  if (threadIdx.x == 0) *dDpart = xdy;
}

// -- 9: d Lc, its reverse cumsum, ddt; the head's sums for dA and dD ---------

template <typename T>
__global__ void gates_bwd(Args<T> a) {
  const Dims& d = a.d;
  const int bh = blockIdx.x * blockDim.x + threadIdx.x;
  if (bh >= d.B * d.H) return;
  const int b = bh / d.H, h = bh % d.H;
  const float A = a.A[h];
  const Work& w = a.w;
  const int rpc = d.rpc, tiles = d.Nt * d.Pt;
  float dA = 0.f, dD = 0.f;
  for (int c = 0; c < d.nc; ++c) {
    const int nv = valid_in(d, c);
    const int64_t ch = static_cast<int64_t>(bh) * d.nc + c;
    const int64_t pos = static_cast<int64_t>(bh) * d.Sp + c * d.Lp;
    float dLL = 0.f;
    for (int t = 0; t < tiles; ++t) dLL += w.dotpart[ch * tiles + t];
    dLL *= w.eLL[ch];
    for (int r = 0; r < nv; ++r) {
      float dw = 0.f;
      for (int nt = 0; nt < d.Nt; ++nt) dw += w.dwpart[(pos + r) * d.Nt + nt];
      dLL += w.w[pos + r] * dw;
    }
    float dll = 0.f;   // reverse cumsum of d Lc: the gradient of log lambda_r
    for (int r = nv - 1; r >= 0; --r) {
      const int64_t p = pos + r;
      float rows = 0.f, cols = 0.f, ddt = 0.f, eps = 0.f, dw = 0.f;
      for (int st = 0; st <= r / kT; ++st) rows += w.rowpart[p * rpc + st];
      for (int tt = r / kT; tt < rpc; ++tt) {
        cols += w.colpart[p * rpc + tt];
        ddt += w.ddtpart[p * rpc + tt];
      }
      for (int nt = 0; nt < d.Nt; ++nt) {
        eps += w.epspart[p * d.Nt + nt];
        dw += w.dwpart[p * d.Nt + nt];
      }
      float dLc = rows + eps - cols - w.w[p] * dw;
      if (r == nv - 1) dLc += dLL;
      dll += dLc;
      ddt += w.dec[p] * dw + A * dll;
      *a.ddt.at(b, c * d.L + r, h) = ddt;
      dA += w.dt[p] * dll;
    }
    for (int i = 0; i < rpc * d.Pt; ++i) dD += w.dDpart[ch * rpc * d.Pt + i];
  }
  w.dAh[bh] = dA;
  w.dDh[bh] = dD;
}

// -- 10: sums over each group's heads and over the sequences -----------------

template <typename T>
__global__ void reduce(Args<T> a) {
  const Dims& d = a.d;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t total = static_cast<int64_t>(d.B) * d.S * d.G * d.N;
  if (i < total) {
    const int n = static_cast<int>(i % d.N), g = static_cast<int>(i / d.N % d.G);
    const int s = static_cast<int>(i / (static_cast<int64_t>(d.N) * d.G) % d.S);
    const int b = static_cast<int>(i / (static_cast<int64_t>(d.N) * d.G * d.S));
    const int c = s / d.L, r = s % d.L;
    float sb = 0.f, sc = 0.f;
    for (int h = g * d.hpg; h < (g + 1) * d.hpg; ++h) {
      const int64_t p = (static_cast<int64_t>(b) * d.H + h) * d.Sp + c * d.Lp + r;
      sb += a.w.dBh[p * d.Np + n];
      sc += a.w.dCh[p * d.Np + n];
    }
    store(a.dBm.at(b, s, g) + n, sb);
    store(a.dCm.at(b, s, g) + n, sc);
  }
  if (i < d.H) {
    float sA = 0.f, sD = 0.f;
    for (int b = 0; b < d.B; ++b) {
      sA += a.w.dAh[b * d.H + i];
      sD += a.w.dDh[b * d.H + i];
    }
    a.dA[i] = sA;
    a.dD[i] = sD;
  }
}

template <typename T>
int run(Args<T> a, cudaStream_t s) {
  const Dims& d = a.d;
  const int BH = d.B * d.H;
  gates<T><<<(BH + 31) / 32, 32, 0, s>>>(a);
  walk_fwd<T><<<dim3(d.Nt, d.Pt, BH), kThreads, 0, s>>>(a);
  walk_bwd<T><<<dim3(d.Nt, d.Pt, BH), kThreads, 0, s>>>(a);
  cb_tiles<T><<<dim3(d.rpc, d.rpc, d.B * d.G * d.nc), kThreads, 0, s>>>(a);
  dm_tiles<T><<<dim3(d.rpc, d.rpc, BH * d.nc), kThreads, 0, s>>>(a);
  dc_tiles<T><<<dim3(d.rpc * d.nc, d.Nt, BH), kThreads, 0, s>>>(a);
  db_tiles<T><<<dim3(d.rpc * d.nc, d.Nt, BH), kThreads, 0, s>>>(a);
  dx_tiles<T><<<dim3(d.rpc * d.nc, d.Pt, BH), kThreads, 0, s>>>(a);
  gates_bwd<T><<<(BH + 31) / 32, 32, 0, s>>>(a);
  const int64_t total = static_cast<int64_t>(d.B) * d.S * d.G * d.N;
  const int64_t n = total > d.H ? total : d.H;
  reduce<T><<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace ham

// Bytes of float32 scratch ham_ssd_bwd needs, written to *bytes.
extern "C" int ham_ssd_bwd_workspace(int B, int S, int H, int G, int N, int P, int L,
                                     long long* bytes) {
  if (B < 0 || S < 0 || H < 1 || G < 1 || H % G || N < 1 || P < 1 || L < 1)
    return ham::kUnsupported;
  ham::Work w;
  *bytes = static_cast<long long>(
      ham::layout(ham::make_dims(B, S, H, G, N, P, L), nullptr, &w));
  return 0;
}

// (dx, ddt, dA, dBm, dCm, dD) of the SSD forward at (x, dt, A, Bm, Cm, D)
// with no initial state, for the gradient dy of y.  x and dy (B, S, H, P)
// and Bm, Cm (B, S, G, N) of dtype `dtype`, dt (B, S, H) float32, read
// through the (b, s, head-or-group) strides in `strides` (x Bm Cm dy dt dx
// dBm dCm ddt, 3 each; unit last-dim stride); A and D (H,) float32
// contiguous; dx, dBm and dCm are written in `dtype`, ddt, dA and dD in
// float32.  `work`: ham_ssd_bwd_workspace bytes.
extern "C" int ham_ssd_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                           const void* Cm, const void* D, const void* dy, void* dx, void* ddt,
                           void* dA, void* dBm, void* dCm, void* dD, void* work, int B, int S,
                           int H, int G, int N, int P, int L, int dtype,
                           const long long* strides, int device, void* stream) {
  if (H < 1 || G < 1 || H % G || N < 1 || P < 1 || L < 1) return ham::kUnsupported;
  if (B == 0 || S == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const ham::Dims d = ham::make_dims(B, S, H, G, N, P, L);
  auto s = static_cast<cudaStream_t>(stream);
  auto ten = [&](auto* p, int t) {
    return ham::Ten<std::remove_pointer_t<decltype(p)>>{p, strides[3 * t], strides[3 * t + 1],
                                                         strides[3 * t + 2]};
  };
  auto go = [&](auto tag) -> int {
    using T = decltype(tag);
    ham::Args<T> a;
    a.x = ten(static_cast<const T*>(x), 0);
    a.Bm = ten(static_cast<const T*>(Bm), 1);
    a.Cm = ten(static_cast<const T*>(Cm), 2);
    a.dy = ten(static_cast<const T*>(dy), 3);
    a.dt = ten(static_cast<const float*>(dt), 4);
    a.dx = ten(static_cast<T*>(dx), 5);
    a.dBm = ten(static_cast<T*>(dBm), 6);
    a.dCm = ten(static_cast<T*>(dCm), 7);
    a.ddt = ten(static_cast<float*>(ddt), 8);
    a.A = static_cast<const float*>(A);
    a.D = static_cast<const float*>(D);
    a.dA = static_cast<float*>(dA);
    a.dD = static_cast<float*>(dD);
    a.d = d;
    ham::layout(d, static_cast<char*>(work), &a.w);
    return ham::run<T>(a, s);
  };
  switch (dtype) {
    case ham::kF32: return go(float{});
    case ham::kBF16: return go(__nv_bfloat16{});
    default: return ham::kUnsupported;
  }
}
