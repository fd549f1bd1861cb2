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
// dA = sum dt d log(lambda)); dD = sum x dy.  colsum_s(dM o M) is dt_s
// times ddt's causal term sum_t dM_ts CB_ts e^{Lc_t - Lc_s}.
// Both routes share the gate passes, a warp per (sequence, head, chunk)
// (Lc and the reverse cumsum restart at every chunk):
//  1 gates      Lc by a warp scan of A dt, then e^{Lc}, e^{LL - Lc}, w;
//  . (the route's passes)
//  2 gates_bwd  d Lc from the passes' per-position sums, its reverse
//               cumsum (warp scans from the chunk's end), ddt, and the
//               chunk's partial sums of dA and dD;
//  3 reduce     dB and dC over each group's heads (or head blocks), dA
//               and dD over the sequences and chunks, in a fixed order.
// Tensor-core route (bf16, N = P = 64, L <= 256): every product on
// csrc/tile_bf16.cuh's mma.sync tile (bf16 operands, float32
// accumulators), no M, dCB, dB or dC per head in device memory; four
// more launches, seven in all:
//  a walk_fwd_tc  a block per (sequence, head): h at every chunk start,
//                 walked in order, h = e^{LL} h + (w B)^T x with w B
//                 rounded once; float32 in the accumulators, stored as the
//                 bf16 operand the later products round it to;
//  b walk_bwd_tc  the same for dh at every chunk end, in reverse, with
//                 <dh_next, h_prev> for d LL;
//  c rows_tc      a block per (64-position t tile, chunk, sequence, group,
//                 block of the group's heads), heaviest first: C B^T of
//                 its row of tiles once, bf16 in shared memory; per head,
//                 e^{Lc} dy h_prev^T, then per s tile dM = dy x^T, the
//                 row sums of dM o M and dCB = dM o decay o dt into a
//                 shared 64 x 64 tile that dC += dCB B reads at once; dC
//                 summed over the block's heads in the accumulators, in
//                 head order, and stored once a block;
//  d cols_tc      a block per (64-position s tile, ...), lightest t range
//                 last: B C^T of its column of tiles once; per head the
//                 state terms w (B dh_next) and w (x dh_next^T) with dw =
//                 B . (dh_next x), then per t tile dM^T = x dy^T, ddt's
//                 causal term, M^T and dCB^T into two shared tiles that dx
//                 += M^T dy and dB += dCB^T C read at once; dx (+ D dy)
//                 stored per head, dB summed over the block's heads.
// The head blocks split a group's heads so the grid fills the card (H 80
// at B 4, S 2048: 4 blocks of 20); reduce adds their dB and dC in order.
// The row and column passes are held to 168 registers, three blocks an SM
// (244 unbounded, two an SM): a few bytes spill, and the pair ran in 1.51
// ms against 1.79 at zamba2-2.7b's step shape on an H100 (four blocks an
// SM spilled more and took 2.05).
// CUDA-core route (float32, and bf16 at other widths), the first port's
// passes between the gates, all float32 on csrc/tile_f32.cuh (each operand
// converted as it is staged; each gradient rounded once):
//  4 walk_fwd   a block per (sequence, head, 64 x 64 tile of h): h at
//               every chunk start (the bf16 forward keeps it only as
//               bf16), walked in order;
//  5 walk_bwd   the same for dh at every chunk end, in reverse;
//  6 cb_tiles   C B^T per (sequence, group, chunk), on and below the
//               diagonal: one tile for all the group's heads;
//  7 dm_tiles   per (sequence, head, chunk) tile: dy x^T, M and dCB stored,
//               row and column sums of dM o M and of dM o CB o decay;
//  8 dc, 9 db, 10 dx  a block per (chunk, 64 positions, 64 columns):
//               dC and dB per head, dx.
// No float atomics: every sum runs in a fixed order, so two calls give the
// same bits.  Positions past S in the last chunk read zeros (dt too) and
// write nothing.  Bound on an H100: bytes (x, dt, B, C, dy read, every
// gradient written; the products are small at N = P = 64).  The
// tensor-core route forms dM twice (rows and columns), C B^T once per
// block, and restages each 64 x 64 product's operands through loader
// functors, so its products and their staging, not bytes, bound it.
#include <initializer_list>
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
using B16 = __nv_bfloat16;

// The tensor-core route's chunk limit: a row or column of C B^T tiles
// ([64][Lp + 8] bf16) in shared memory beside the tile routine's.
constexpr int kTcMaxL = 256;
// Blocks of the row and column passes the head blocks aim for: four a
// streaming multiprocessor.
constexpr int kTcBlocksPerSm = 4;
constexpr int kTileLd = kT + 8;   // row pitch (bf16) of a shared 64 x 64 tile

struct Dims {
  int B, S, H, G, N, P, L;
  int nc, Lp, Sp, Nt, Pt, Np, Pp, hpg, rpc;
  int tc;        // the tensor-core route
  int nhb, hpb;  // tensor-core route: head blocks of a group, heads a block
};

inline bool tc_route(int dtype, int N, int P, int L) {
  return dtype == kBF16 && N == kT && P == kT && L <= kTcMaxL;
}

// tc: the tensor-core route (the caller has checked tc_route); sms: the
// card's streaming multiprocessors, for the head blocks
inline Dims make_dims(int B, int S, int H, int G, int N, int P, int L, int tc, int sms) {
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
  d.tc = tc;
  const int base = B * G * d.nc * d.rpc;
  int nhb = base > 0 ? (kTcBlocksPerSm * sms + base - 1) / base : 1;
  nhb = nhb < 1 ? 1 : nhb > d.hpg ? d.hpg : nhb;
  d.hpb = (d.hpg + nhb - 1) / nhb;
  d.nhb = (d.hpg + d.hpb - 1) / d.hpb;
  return d;
}

struct Work {
  // both routes
  float *Lc, *E, *dec, *w, *dt;        // per padded position (BH x Sp)
  float *eLL, *dAc, *dDc;              // per chunk (BH x nc)
  float *dotpart, *dDpart;             // per chunk and tile
  // CUDA-core route
  float *hp, *dhn;                     // h at each chunk start, dh at each chunk end
  float* CB;                           // per (sequence, group, chunk), Lp x Lp
  float *M, *dCB;                      // per (sequence, head, chunk), Lp x Lp
  float *rowpart, *colpart, *ddtpart;  // per position and 64-tile
  float *epspart, *dwpart;             // per position and N tile
  float *dBh, *dCh;                    // per position, Np wide
  // tensor-core route
  B16 *hp16, *dhn16;                   // per chunk, N x P, the bf16 operands
  float *rows, *eps, *ddtc, *dw;       // per position: the passes' sums
  float *dBp, *dCp;                    // per (head block, sequence, position, group), N wide
};

// Lay the route's parts out from base (sizes only when base is null);
// returns the bytes.  Parts the route does not use take none.
inline size_t layout(const Dims& d, char* base, Work* w) {
  *w = Work{};
  const size_t BH = static_cast<size_t>(d.B) * d.H, pos = BH * d.Sp, ch = BH * d.nc;
  const size_t sq = static_cast<size_t>(d.Lp) * d.Lp;
  size_t at = 0;
  auto part = [&](auto** slot, size_t n) {
    using P = std::remove_reference_t<decltype(**slot)>;
    if (base) *slot = reinterpret_cast<P*>(base + at);
    at += (n * sizeof(P) + 255) / 256 * 256;
  };
  for (float** p : {&w->Lc, &w->E, &w->dec, &w->w, &w->dt}) part(p, pos);
  for (float** p : {&w->eLL, &w->dAc, &w->dDc}) part(p, ch);
  if (d.tc) {
    part(&w->dotpart, ch);
    part(&w->dDpart, ch * d.rpc);
    part(&w->hp16, ch * d.N * d.P);
    part(&w->dhn16, ch * d.N * d.P);
    for (float** p : {&w->rows, &w->eps, &w->ddtc, &w->dw}) part(p, pos);
    const size_t hb = static_cast<size_t>(d.nhb) * d.B * d.Sp * d.G * d.N;
    part(&w->dBp, hb);
    part(&w->dCp, hb);
    return at;
  }
  part(&w->dotpart, ch * d.Nt * d.Pt);
  part(&w->dDpart, ch * d.rpc * d.Pt);
  part(&w->hp, ch * d.Np * d.Pp);
  part(&w->dhn, ch * d.Np * d.Pp);
  part(&w->CB, static_cast<size_t>(d.B) * d.G * d.nc * sq);
  part(&w->M, ch * sq);
  part(&w->dCB, ch * sq);
  for (float** p : {&w->rowpart, &w->colpart, &w->ddtpart}) part(p, pos * d.rpc);
  for (float** p : {&w->epspart, &w->dwpart}) part(p, pos * d.Nt);
  part(&w->dBh, pos * d.Np);
  part(&w->dCh, pos * d.Np);
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

// -- the CUDA-core route's loaders: `x` is a (B, S, K, width) operand at
// sequence b, index k (a head or a group), positions c L + (0 .. nvalid) --

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

// -- 1: gate quantities, a warp per (sequence, head, chunk) -------------------

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Lc by an inclusive warp scan of A dt, 32 positions at a time (dt = 0 past
// S, so Lc holds its last value there); then e^{Lc}, e^{LL - Lc}, w and e^{LL}
template <typename T>
__global__ void __launch_bounds__(128) gates(Args<T> a) {
  const Dims& d = a.d;
  const int wid = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (wid >= d.B * d.H * d.nc) return;  // the whole warp
  const Work& w = a.w;
  const int bh = wid / d.nc, c = wid % d.nc, b = bh / d.H, h = bh % d.H, nv = valid_in(d, c);
  const int64_t base = static_cast<int64_t>(bh) * d.Sp + c * d.Lp;
  const float A = a.A[h];
  float carry = 0.f;
  for (int r0 = 0; r0 < d.Lp; r0 += 32) {
    const int r = r0 + lane;
    const float dt = r < nv ? *a.dt.at(b, c * d.L + r, h) : 0.f;
    float x = A * dt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    x += carry;
    w.Lc[base + r] = x;
    w.dt[base + r] = dt;
    carry = __shfl_sync(0xffffffffu, x, 31);
  }
  for (int r = lane; r < d.Lp; r += 32) {
    const float Lc = w.Lc[base + r];
    w.E[base + r] = expf(Lc);
    w.dec[base + r] = expf(carry - Lc);
    w.w[base + r] = w.dec[base + r] * w.dt[base + r];
  }
  if (lane == 0) w.eLL[static_cast<int64_t>(bh) * d.nc + c] = expf(carry);
}

// -- 4: h at every chunk start ----------------------------------------------------

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

// -- 5: dh at every chunk end, in reverse ---------------------------------------

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

// -- 6: C B^T per (sequence, group, chunk) ---------------------------------------

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

// -- 7: dM = dy x^T; M, dCB and the sums of the decay's gradient ---------------

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

// -- 8: dC = dCB B + e^{Lc} dy h_prev^T, and C . (h_prev dy) -----------------

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

// -- 9: dB = dCB^T C + w (x dh_next^T), and dw = B . (dh_next x) -------------

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

// -- 10: dx = M^T dy + w (B dh_next) + D dy, and the tile's sum of x dy --------

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

// -- the tensor-core route (bf16, N = P = 64): every product on tc::mma ----

// A (B, S, K, 64) bf16 input from the first position of a chunk, as a
// tile-routine operand: positions p0 + the position index are the
// operand's k (kPosIsK) or m, columns c0 + the other; positions past nv
// read 0.  kScaled (positions along k): each value times scale[position],
// rounded to bf16 once.
template <bool kPosIsK, bool kScaled = false>
struct PosLd {
  static constexpr bool kKMajor = !kPosIsK;
  const B16* x;
  int64_t ss;
  int p0, c0, nv;
  const float* scale;
  struct Raw {
    uint4 v;
    float s;
  };
  __device__ __forceinline__ Raw load(int m, int k) const {
    const int pos = p0 + (kPosIsK ? k : m), col = c0 + (kPosIsK ? m : k);
    const bool ok = pos < nv;
    return {ok ? load16(x + pos * ss + col) : make_uint4(0u, 0u, 0u, 0u),
            kScaled && ok ? scale[pos] : 0.f};
  }
  __device__ __forceinline__ uint4 pack(const Raw& r) const {
    if constexpr (!kScaled) {
      return r.v;
    } else {
      float f[8];
      tc::unpack8(r.v, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] *= r.s;
      return tc::pack8(f);
    }
  }
};

// element (j, e) of a chunk's bf16 state operand, row-major [N][P] (h or
// dh): j is the operand's m (kJIsM) or k, e the other
template <bool kJIsM>
struct MatLd {
  static constexpr bool kKMajor = kJIsM;
  const B16* mat;
  using Raw = uint4;
  __device__ __forceinline__ Raw load(int m, int k) const {
    return load16(mat + (kJIsM ? m : k) * kT + (kJIsM ? k : m));
  }
  __device__ __forceinline__ uint4 pack(const Raw& r) const { return r; }
};

// element (m, k) of a bf16 [64][kTileLd] tile in shared memory
struct SmemLd {
  static constexpr bool kKMajor = true;
  const B16* t;
  using Raw = uint4;
  __device__ __forceinline__ Raw load(int m, int k) const {
    return *reinterpret_cast<const uint4*>(t + m * kTileLd + k);
  }
  __device__ __forceinline__ uint4 pack(const Raw& r) const { return r; }
};

// operands of chunk c of sequence b: head h, group g
struct Chunk {
  int b, h, g, c, nv;
  int64_t pos, ch;   // first padded position of the chunk, chunk index (BH x nc)
};
__device__ __forceinline__ Chunk chunk_of(const Dims& d, int b, int h, int c) {
  const int64_t bh = static_cast<int64_t>(b) * d.H + h;
  return {b, h, h / d.hpg, c, valid_in(d, c), bh * d.Sp + c * d.Lp, bh * d.nc + c};
}
// the (B, S, K, 64) input t from chunk k's first position, at head-or-group i
template <bool kPosIsK>
__device__ __forceinline__ PosLd<kPosIsK> pos_ld(const Ten<const B16>& t, const Dims& d,
                                                 const Chunk& k, int i, int p0) {
  return {t.at(k.b, k.c * d.L, i), t.ss, p0, 0, k.nv, nullptr};
}
// the same scaled by the per-position array `scale` (BH x Sp) along k
__device__ __forceinline__ PosLd<true, true> scaled_ld(const Ten<const B16>& t, const Dims& d,
                                                       const Chunk& k, int i,
                                                       const float* scale) {
  return {t.at(k.b, k.c * d.L, i), t.ss, 0, 0, k.nv, scale + k.pos};
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}
__device__ __forceinline__ void store_pair(B16* p, float x, float y) {
  *reinterpret_cast<unsigned*>(p) = pack_bf16(x, y);
}
__device__ __forceinline__ float2 load_pair(const B16* p) {
  const unsigned u = *reinterpret_cast<const unsigned*>(p);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
// a 64 x 64 accumulator tile as bf16 into a shared [64][ld] array at column c0
__device__ __forceinline__ void tile_to_smem(B16* dst, int ld, int c0, const float (&acc)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      store_pair(dst + tc::row(2 * hh) * ld + c0 + tc::col(j, 0), acc[j][2 * hh],
                 acc[j][2 * hh + 1]);
}

using Acc = float[8][4];

// a: h at every chunk start, a block per (sequence, head) walking the
// chunks in order: h = e^{LL} h + (w B)^T x, stored as bf16
__global__ void __launch_bounds__(tc::kThreads) walk_fwd_tc(Args<B16> a) {
  __shared__ tc::Smem64 sm;
  const Dims& d = a.d;
  const int b = blockIdx.x / d.H, h = blockIdx.x % d.H;
  Acc acc;
  tc::zero(acc);
  for (int c = 0; c < d.nc; ++c) {
    const Chunk k = chunk_of(d, b, h, c);
    tc::store_tile(nullptr, a.w.hp16 + k.ch * kT * kT, kT, acc);
    if (c == d.nc - 1) break;
    tc::scale(acc, a.w.eLL[k.ch]);
    tc::mma(acc, scaled_ld(a.Bm, d, k, k.g, a.w.w), pos_ld<true>(a.x, d, k, h, 0), 0, k.nv, sm);
  }
}

// b: dh at every chunk end, in reverse: dh = e^{LL} dh + (e^{Lc} C)^T dy,
// stored as bf16, with <dh_next, h_prev> per chunk
__global__ void __launch_bounds__(tc::kThreads) walk_bwd_tc(Args<B16> a) {
  __shared__ tc::Smem64 sm;
  const Dims& d = a.d;
  const int b = blockIdx.x / d.H, h = blockIdx.x % d.H;
  Acc acc;
  tc::zero(acc);
  for (int c = d.nc - 1; c >= 0; --c) {
    const Chunk k = chunk_of(d, b, h, c);
    tc::store_tile(nullptr, a.w.dhn16 + k.ch * kT * kT, kT, acc);
    const B16* hp = a.w.hp16 + k.ch * kT * kT;
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 v = load_pair(hp + tc::row(2 * hh) * kT + tc::col(j, 0));
        dot += acc[j][2 * hh] * v.x + acc[j][2 * hh + 1] * v.y;
      }
    dot = tc::block_sum(dot, sm);
    if (threadIdx.x == 0) a.w.dotpart[k.ch] = dot;
    if (c == 0) break;
    tc::scale(acc, a.w.eLL[k.ch]);
    tc::mma(acc, scaled_ld(a.Cm, d, k, k.g, a.w.E), pos_ld<true>(a.dy, d, k, h, 0), 0, k.nv, sm);
  }
}

// The row and column passes' block: tile i of the chunk (64 positions),
// chunk c, sequence b, group g, head block hb; the heads [h0, h1).
// Blocks are numbered with the tile outermost; `heavy_last` puts the
// highest tile index first.
struct PassBlock {
  int i, c, b, g, h0, h1;
};
__device__ __forceinline__ PassBlock pass_block(const Dims& d, bool high_first) {
  const int per = d.nc * d.B * d.G * d.nhb;
  int r = static_cast<int>(blockIdx.x) % per;
  const int i = static_cast<int>(blockIdx.x) / per;
  PassBlock p;
  p.i = high_first ? d.rpc - 1 - i : i;
  const int hb = r % d.nhb;
  r /= d.nhb;
  p.g = r % d.G;
  r /= d.G;
  p.b = r % d.B;
  p.c = r / d.B;
  p.h0 = p.g * d.hpg + hb * d.hpb;
  p.h1 = min(p.h0 + d.hpb, (p.g + 1) * d.hpg);
  return p;
}
// the pass's dB or dC share of the block's heads, float32, at (head block,
// sequence, padded position, group)
__device__ __forceinline__ void store_share(float* out, const Dims& d, const PassBlock& p,
                                            const Acc& acc) {
  const int hb = (p.h0 - p.g * d.hpg) / d.hpb;
  const int64_t row0 = ((static_cast<int64_t>(hb) * d.B + p.b) * d.Sp + p.c * d.Lp + p.i * kT);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int64_t at = ((row0 + tc::row(2 * hh)) * d.G + p.g) * kT + tc::col(j, 0);
      *reinterpret_cast<float2*>(out + at) = make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
    }
}

// shared memory of the row pass: the tile routine's, a row of C B^T tiles
// ([64][Lp + 8]) and one 64 x 64 tile
inline size_t rows_smem(int Lp) {
  return sizeof(tc::Smem64) + 2 * static_cast<size_t>(kT) * (Lp + 8 + kTileLd);
}
// the column pass: one more tile
inline size_t cols_smem(int Lp) { return rows_smem(Lp) + 2 * kT * kTileLd; }

// c: a block per (t tile, chunk, sequence, group, head block), the tile
// with most s tiles first: dC = e^{Lc} dy h_prev^T + dCB B summed over
// the block's heads, the row sums of dM o M and e^{Lc_t} C_t . (h_prev dy_t)
__global__ void __launch_bounds__(tc::kThreads, 3) rows_tc(Args<B16> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Dims& d = a.d;
  tc::Smem64& sm = *reinterpret_cast<tc::Smem64*>(smem);
  const int ldcb = d.Lp + 8;
  B16* cbs = reinterpret_cast<B16*>(smem + sizeof(tc::Smem64));   // [64][ldcb]: C_t . B_s
  B16* tile = cbs + kT * ldcb;                                     // [64][kTileLd]: dCB
  const PassBlock p = pass_block(d, true);
  const int t0 = p.i * kT;
  const Chunk k0 = chunk_of(d, p.b, p.h0, p.c);
  if (t0 >= k0.nv) return;   // past S: nothing of the tile is read
  // C B^T of the row's tiles on and below the diagonal, once for the heads
  for (int st = 0; st <= p.i; ++st) {
    Acc acc;
    tc::zero(acc);
    tc::mma(acc, pos_ld<false>(a.Cm, d, k0, p.g, t0), pos_ld<false>(a.Bm, d, k0, p.g, st * kT),
            0, kT, sm);
    tile_to_smem(cbs, ldcb, st * kT, acc);   // each thread reads back only its own
  }
  Acc dc;
  tc::zero(dc);
  for (int h = p.h0; h < p.h1; ++h) {
    const Chunk k = chunk_of(d, p.b, h, p.c);
    const float* Lc = a.w.Lc + k.pos;
    const float* dt = a.w.dt + k.pos;
    float eps[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
    if (p.c > 0) {   // e^{Lc_t} dy_t h_prev^T, and C_t . it
      Acc acc;
      tc::zero(acc);
      tc::mma(acc, pos_ld<false>(a.dy, d, k, h, t0), MatLd<true>{a.w.hp16 + k.ch * kT * kT}, 0,
              kT, sm);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = t0 + tc::row(2 * hh);
        const float E = a.w.E[k.pos + t];
        const B16* Ct = a.Cm.at(p.b, p.c * d.L + t, p.g);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float* v = &acc[j][2 * hh];
          v[0] *= E;
          v[1] *= E;
          if (t < k.nv) {
            const float2 cv = load_pair(Ct + tc::col(j, 0));
            eps[hh] += cv.x * v[0] + cv.y * v[1];
          }
          dc[j][2 * hh] += v[0];
          dc[j][2 * hh + 1] += v[1];
        }
      }
    }
    for (int st = 0; st <= p.i; ++st) {
      Acc dm;
      tc::zero(dm);
      tc::mma(dm, pos_ld<false>(a.dy, d, k, h, t0), pos_ld<false>(a.x, d, k, h, st * kT), 0, kT,
              sm);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = tc::row(2 * hh), t = t0 + r;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int s = st * kT + tc::col(j, e);
            v[e] = 0.f;
            if (s <= t && t < k.nv) {
              const float dd = expf(Lc[t] - Lc[s]) * dt[s];
              const float cb = __bfloat162float(cbs[r * ldcb + s]);
              rs[hh] += dm[j][2 * hh + e] * cb * dd;
              v[e] = dm[j][2 * hh + e] * dd;
            }
          }
          store_pair(tile + r * kTileLd + tc::col(j, 0), v[0], v[1]);
        }
      }
      __syncthreads();   // the dCB tile is whole before the product stages it
      tc::mma(dc, SmemLd{tile}, pos_ld<true>(a.Bm, d, k, p.g, st * kT), 0, kT, sm);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float r = quad_sum(rs[hh]), e = quad_sum(eps[hh]);
      const int t = t0 + tc::row(2 * hh);
      if (tc::lane() % 4 == 0 && t < k.nv) {
        a.w.rows[k.pos + t] = r;
        a.w.eps[k.pos + t] = e;
      }
    }
  }
  store_share(a.w.dCp, d, p, dc);
}

// d: a block per (s tile, chunk, sequence, group, head block), the tile
// with most t tiles first: dx = M^T dy + w (B dh_next) + D dy per head,
// dB = dCB^T C + w (x dh_next^T) summed over the block's heads, dw = B .
// (dh_next x), ddt's causal term sum_t dM_ts CB_ts decay_ts and the tile's
// sum of x dy
__global__ void __launch_bounds__(tc::kThreads, 3) cols_tc(Args<B16> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Dims& d = a.d;
  tc::Smem64& sm = *reinterpret_cast<tc::Smem64*>(smem);
  const int ldcb = d.Lp + 8;
  B16* cbs = reinterpret_cast<B16*>(smem + sizeof(tc::Smem64));   // [64][ldcb]: B_s . C_t
  B16* tm = cbs + kT * ldcb;                                       // [64][kTileLd]: M^T
  B16* td = tm + kT * kTileLd;                                     // [64][kTileLd]: dCB^T
  const PassBlock p = pass_block(d, false);
  const int s0 = p.i * kT;
  const Chunk k0 = chunk_of(d, p.b, p.h0, p.c);
  if (s0 >= k0.nv) return;
  const int tend = (k0.nv + kT - 1) / kT;   // t tiles p.i .. tend - 1
  for (int tt = p.i; tt < tend; ++tt) {
    Acc acc;
    tc::zero(acc);
    tc::mma(acc, pos_ld<false>(a.Bm, d, k0, p.g, s0), pos_ld<false>(a.Cm, d, k0, p.g, tt * kT),
            0, kT, sm);
    tile_to_smem(cbs, ldcb, tt * kT, acc);
  }
  Acc db;
  tc::zero(db);
  for (int h = p.h0; h < p.h1; ++h) {
    const Chunk k = chunk_of(d, p.b, h, p.c);
    const float* Lc = a.w.Lc + k.pos;
    const float* dt = a.w.dt + k.pos;
    const float* wv = a.w.w + k.pos;
    Acc dx;
    tc::zero(dx);
    float dw[2] = {0.f, 0.f}, dtc[2] = {0.f, 0.f};
    if (p.c < d.nc - 1) {   // the state terms
      const B16* dhn = a.w.dhn16 + k.ch * kT * kT;
      Acc acc;
      tc::zero(acc);
      tc::mma(acc, pos_ld<false>(a.x, d, k, h, s0), MatLd<true>{dhn}, 0, kT, sm);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int s = s0 + tc::row(2 * hh);
        const float ws = wv[s];
        const B16* Bs = a.Bm.at(p.b, p.c * d.L + s, p.g);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float* v = &acc[j][2 * hh];
          if (s < k.nv) {
            const float2 bv = load_pair(Bs + tc::col(j, 0));
            dw[hh] += bv.x * v[0] + bv.y * v[1];
          }
          db[j][2 * hh] += ws * v[0];
          db[j][2 * hh + 1] += ws * v[1];
        }
      }
      tc::mma(dx, pos_ld<false>(a.Bm, d, k, p.g, s0), MatLd<false>{dhn}, 0, kT, sm);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float ws = wv[s0 + tc::row(2 * hh)];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          dx[j][2 * hh] *= ws;
          dx[j][2 * hh + 1] *= ws;
        }
      }
    }
    for (int tt = p.i; tt < tend; ++tt) {
      Acc dm;   // dM^T: rows s, columns t
      tc::zero(dm);
      tc::mma(dm, pos_ld<false>(a.x, d, k, h, s0), pos_ld<false>(a.dy, d, k, h, tt * kT), 0, kT,
              sm);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = tc::row(2 * hh), s = s0 + r;
        const float dts = dt[s];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float m[2], g[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int t = tt * kT + tc::col(j, e);
            m[e] = g[e] = 0.f;
            if (s <= t && t < k.nv) {
              const float dec = expf(Lc[t] - Lc[s]);
              const float q = __bfloat162float(cbs[r * ldcb + t]) * dec;
              dtc[hh] += dm[j][2 * hh + e] * q;
              m[e] = q * dts;
              g[e] = dm[j][2 * hh + e] * dec * dts;
            }
          }
          store_pair(tm + r * kTileLd + tc::col(j, 0), m[0], m[1]);
          store_pair(td + r * kTileLd + tc::col(j, 0), g[0], g[1]);
        }
      }
      __syncthreads();   // both tiles whole before the products stage them
      tc::mma(dx, SmemLd{tm}, pos_ld<true>(a.dy, d, k, h, tt * kT), 0, kT, sm);
      tc::mma(db, SmemLd{td}, pos_ld<true>(a.Cm, d, k, p.g, tt * kT), 0, kT, sm);
    }
    // dx + D dy, stored; the tile's sum of x dy; dw and ddt's causal term
    const float D = a.D[h];
    float xdy = 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int s = s0 + tc::row(2 * hh);
      if (s < k.nv) {
        const int sp = p.c * d.L + s;
        const B16* xs = a.x.at(p.b, sp, h);
        const B16* gs = a.dy.at(p.b, sp, h);
        B16* out = a.dx.at(p.b, sp, h);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = tc::col(j, 0);
          const float2 xv = load_pair(xs + col), gv = load_pair(gs + col);
          xdy += xv.x * gv.x + xv.y * gv.y;
          store_pair(out + col, dx[j][2 * hh] + D * gv.x, dx[j][2 * hh + 1] + D * gv.y);
        }
      }
      const float w_ = quad_sum(dw[hh]), c_ = quad_sum(dtc[hh]);
      if (tc::lane() % 4 == 0 && s < k.nv) {
        a.w.dw[k.pos + s] = w_;
        a.w.ddtc[k.pos + s] = c_;
      }
    }
    xdy = tc::block_sum(xdy, sm);
    if (threadIdx.x == 0) a.w.dDpart[k.ch * d.rpc + p.i] = xdy;
  }
  store_share(a.w.dBp, d, p, db);
}

// -- 2: d Lc, its reverse cumsum, ddt; the chunk's sums for dA and dD -------

// A warp per (sequence, head, chunk).  The route's per-position sums: the
// tensor-core route's passes leave one value a position (rows, eps, ddtc,
// dw) and one <dh_next, h_prev> and one x . dy sum per 64-position tile;
// the CUDA-core route's leave partials per 64-tile or N tile, summed here
// in tile order.
template <typename T>
__global__ void __launch_bounds__(128) gates_bwd(Args<T> a) {
  const Dims& d = a.d;
  const int wid = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (wid >= d.B * d.H * d.nc) return;
  const Work& w = a.w;
  const int bh = wid / d.nc, c = wid % d.nc, b = bh / d.H, h = bh % d.H, nv = valid_in(d, c);
  const int64_t ch = static_cast<int64_t>(bh) * d.nc + c;
  const int64_t pos = static_cast<int64_t>(bh) * d.Sp + c * d.Lp;
  const float A = a.A[h];
  const int rpc = d.rpc, rt = (nv + kT - 1) / kT;
  const int tiles = d.tc ? 1 : d.Nt * d.Pt, dparts = d.tc ? rt : rt * d.Pt;
  auto dw_at = [&](int r) {
    if (d.tc) return w.dw[pos + r];
    float s = 0.f;
    for (int nt = 0; nt < d.Nt; ++nt) s += w.dwpart[(pos + r) * d.Nt + nt];
    return s;
  };
  float dot = 0.f, sw = 0.f, dD = 0.f;
  for (int t = lane; t < tiles; t += 32) dot += w.dotpart[ch * tiles + t];
  for (int r = lane; r < nv; r += 32) sw += w.w[pos + r] * dw_at(r);
  // dDpart: the tiles of positions below nv (CUDA-core route: P tiles each)
  const int64_t dbase = d.tc ? ch * rpc : ch * rpc * d.Pt;
  for (int i = lane; i < dparts; i += 32) dD += w.dDpart[dbase + i];
  const float dLL = w.eLL[ch] * warp_sum(dot) + warp_sum(sw);
  float carry = 0.f, dA = 0.f;   // carry: the sum of d Lc past this step
  for (int r0 = d.Lp - 32; r0 >= 0; r0 -= 32) {
    const int r = r0 + lane;
    const int64_t p = pos + r;
    float x = 0.f, ddtc = 0.f, dw = 0.f;
    if (r < nv) {
      float rows = 0.f, cols = 0.f, eps = 0.f;
      dw = dw_at(r);
      if (d.tc) {
        rows = w.rows[p];
        eps = w.eps[p];
        ddtc = w.ddtc[p];
        cols = w.dt[p] * ddtc;
      } else {
        for (int st = 0; st <= r / kT; ++st) rows += w.rowpart[p * rpc + st];
        for (int tt = r / kT; tt < rpc; ++tt) {
          cols += w.colpart[p * rpc + tt];
          ddtc += w.ddtpart[p * rpc + tt];
        }
        for (int nt = 0; nt < d.Nt; ++nt) eps += w.epspart[p * d.Nt + nt];
      }
      x = rows + eps - cols - w.w[p] * dw + (r == nv - 1 ? dLL : 0.f);
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {  // x = sum of d Lc over lanes >= lane
      const float y = __shfl_down_sync(0xffffffffu, x, o);
      if (lane + o < 32) x += y;
    }
    const float dll = carry + x;   // the gradient of log lambda_r
    if (r < nv) {
      *a.ddt.at(b, c * d.L + r, h) = ddtc + w.dec[p] * dw + A * dll;
      dA += w.dt[p] * dll;
    }
    carry += __shfl_sync(0xffffffffu, x, 0);
  }
  dA = warp_sum(dA);
  dD = warp_sum(dD);
  if (lane == 0) {
    w.dAc[ch] = dA;
    w.dDc[ch] = dD;
  }
}

// -- 3: sums over each group's heads and over the sequences -----------------

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
    if (d.tc) {   // the head blocks' shares, in order
      for (int hb = 0; hb < d.nhb; ++hb) {
        const int64_t p =
            (((static_cast<int64_t>(hb) * d.B + b) * d.Sp + c * d.Lp + r) * d.G + g) * d.N + n;
        sb += a.w.dBp[p];
        sc += a.w.dCp[p];
      }
    } else {
      for (int h = g * d.hpg; h < (g + 1) * d.hpg; ++h) {
        const int64_t p = (static_cast<int64_t>(b) * d.H + h) * d.Sp + c * d.Lp + r;
        sb += a.w.dBh[p * d.Np + n];
        sc += a.w.dCh[p * d.Np + n];
      }
    }
    store(a.dBm.at(b, s, g) + n, sb);
    store(a.dCm.at(b, s, g) + n, sc);
  }
  if (i < d.H) {   // dA and dD: the chunks' sums, sequence by sequence in order
    float sA = 0.f, sD = 0.f;
    for (int b = 0; b < d.B; ++b)
      for (int c = 0; c < d.nc; ++c) {
        const int64_t ch = (static_cast<int64_t>(b) * d.H + i) * d.nc + c;
        sA += a.w.dAc[ch];
        sD += a.w.dDc[ch];
      }
    a.dA[i] = sA;
    a.dD[i] = sD;
  }
}

template <typename T>
int run(Args<T> a, cudaStream_t s) {
  const Dims& d = a.d;
  const int BH = d.B * d.H;
  const unsigned gate_blocks = (BH * d.nc + 3) / 4;
  gates<T><<<gate_blocks, 128, 0, s>>>(a);
  if constexpr (std::is_same_v<T, B16>) {
    if (d.tc) {
      cudaError_t err = allow_smem_once<rows_tc>(rows_smem(kTcMaxL));
      if (err == cudaSuccess) err = allow_smem_once<cols_tc>(cols_smem(kTcMaxL));
      if (err != cudaSuccess) return err;
      const unsigned blocks = d.rpc * d.nc * d.B * d.G * d.nhb;
      walk_fwd_tc<<<BH, tc::kThreads, 0, s>>>(a);
      walk_bwd_tc<<<BH, tc::kThreads, 0, s>>>(a);
      rows_tc<<<blocks, tc::kThreads, rows_smem(d.Lp), s>>>(a);
      cols_tc<<<blocks, tc::kThreads, cols_smem(d.Lp), s>>>(a);
    }
  }
  if (!d.tc) {
    walk_fwd<T><<<dim3(d.Nt, d.Pt, BH), kThreads, 0, s>>>(a);
    walk_bwd<T><<<dim3(d.Nt, d.Pt, BH), kThreads, 0, s>>>(a);
    cb_tiles<T><<<dim3(d.rpc, d.rpc, d.B * d.G * d.nc), kThreads, 0, s>>>(a);
    dm_tiles<T><<<dim3(d.rpc, d.rpc, BH * d.nc), kThreads, 0, s>>>(a);
    dc_tiles<T><<<dim3(d.rpc * d.nc, d.Nt, BH), kThreads, 0, s>>>(a);
    db_tiles<T><<<dim3(d.rpc * d.nc, d.Nt, BH), kThreads, 0, s>>>(a);
    dx_tiles<T><<<dim3(d.rpc * d.nc, d.Pt, BH), kThreads, 0, s>>>(a);
  }
  gates_bwd<T><<<gate_blocks, 128, 0, s>>>(a);
  const int64_t total = static_cast<int64_t>(d.B) * d.S * d.G * d.N;
  const int64_t n = total > d.H ? total : d.H;
  reduce<T><<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the dims of a call, or false for a shape the kernels do not take (tc:
// the tensor-core route was asked for)
inline bool dims_of(int B, int S, int H, int G, int N, int P, int L, int dtype, int tc, int sms,
                    Dims* d) {
  if (B < 0 || S < 0 || H < 1 || G < 1 || H % G || N < 1 || P < 1 || L < 1 || sms < 1)
    return false;
  if (tc && !tc_route(dtype, N, P, L)) return false;
  *d = make_dims(B, S, H, G, N, P, L, tc, sms);
  return true;
}

}  // namespace
}  // namespace ham

// Bytes of scratch ham_ssd_bwd needs, written to *bytes.  tc: the
// tensor-core route (bf16, N = P = 64, L <= 256), else the CUDA-core
// route; sms: the card's streaming multiprocessors.
extern "C" int ham_ssd_bwd_workspace(int B, int S, int H, int G, int N, int P, int L, int dtype,
                                     int tc, int sms, long long* bytes) {
  ham::Dims d;
  if (!ham::dims_of(B, S, H, G, N, P, L, dtype, tc, sms, &d)) return ham::kUnsupported;
  ham::Work w;
  *bytes = static_cast<long long>(ham::layout(d, nullptr, &w));
  return 0;
}

// (dx, ddt, dA, dBm, dCm, dD) of the SSD forward at (x, dt, A, Bm, Cm, D)
// with no initial state, for the gradient dy of y.  x and dy (B, S, H, P)
// and Bm, Cm (B, S, G, N) of dtype `dtype`, dt (B, S, H) float32, read
// through the (b, s, head-or-group) strides in `strides` (x Bm Cm dy dt dx
// dBm dCm ddt, 3 each; unit last-dim stride); A and D (H,) float32
// contiguous; dx, dBm and dCm are written in `dtype`, ddt, dA and dD in
// float32.  tc, sms: as ham_ssd_bwd_workspace; `work`: its bytes.
extern "C" int ham_ssd_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                           const void* Cm, const void* D, const void* dy, void* dx, void* ddt,
                           void* dA, void* dBm, void* dCm, void* dD, void* work, int B, int S,
                           int H, int G, int N, int P, int L, int dtype, int tc, int sms,
                           const long long* strides, int device, void* stream) {
  ham::Dims d;
  if (!ham::dims_of(B, S, H, G, N, P, L, dtype, tc, sms, &d)) return ham::kUnsupported;
  if (B == 0 || S == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
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
