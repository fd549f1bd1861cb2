// Grouped (per-expert) matmul for the MoE layer, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/grouped_matmul.py
// (_gmm_kernel): out[e] = x[e] @ w[e] over the capacity-padded dispatch
// layout (E, C, d) x (E, d, f) -> (E, C, f), products and sums in float32,
// the output rounded once to the input dtype after the last d step.
//
// Bound on an H100: bytes at decode (C <= 8: every call streams all E expert
// matrices, 268 MB for olmoe's gate at 2 flops per weight element per token),
// and on paper still bytes at a 1024-token prefill (C = 160).  Four kernels,
// the route chosen by the Python wrapper (grouped_matmul.py `route`):
//  * wgmma (bf16, C > 8): a persistent grid, one block per SM, walks the
//    tiles (256-row chunk of C, expert, 128 columns of f), full chunks
//    first, so one tile covers the whole capacity of a prefill and each w
//    tile leaves device memory once.  One producer warpgroup starts TMA
//    loads (64 x 64 boxes, 128-byte swizzle, zero past every edge) into a
//    4-stage ring guarded by mbarriers; two consumer warpgroups, one per
//    64-column half of the tile, multiply every 64-row slab of x with wgmma
//    m64n64k16 (x K-major, w N-major, float32 accumulators), keeping one
//    stage of products in flight before handing a stage back, and store
//    bf16 pairs from the fragments (single elements at an odd f) while the
//    producer already loads the next tile;
//  * stream (bf16, C <= 8): one block per (256-column slab of f, expert),
//    two to an SM; a producer warp streams 16-row TMA boxes of w (128-byte
//    swizzle) through an 8-stage ring, and four consumer warps take the
//    stages in turn and form out^T = w^T x^T on the tensor cores (mma.sync
//    m16n8k16: w^T by ldmatrix.trans as the A operand, the 8 rows of x as
//    the 8 columns of B); the warps' sums meet in shared memory in warp
//    order (no atomics), so the sum's order is fixed;
//  * skinny (float32, C <= 8): one block per (expert, 32 * VN columns of
//    f); lane l of every warp owns one 16-byte vector of w columns, so a
//    warp reads 512 contiguous bytes of one w row; the 8 warps split d,
//    each streaming its rows with 8 loads in flight per thread, while the 8
//    rows of x sit in shared memory as float32 (512 d positions per stage);
//    the warps' partial sums meet in shared memory;
//  * tiled (float32, C > 8): 64 x 64 tiles on the CUDA cores, staged as
//    float32, 4 x 4 outputs per thread, each 32-deep partial sum added to
//    the accumulator, which keeps the rounding error of a d = 2048 sum near
//    that of a blocked sum; the blocks that share a w tile run next to each
//    other, so w is read from device memory about once and from L2 for the
//    other C tiles.  (The tensor cores take float32 only as TF32, which
//    would miss the float32 tolerance.)
// Every kernel reads x and w through strides with a unit last dim.  The TMA
// routes take every view the wrapper accepts: it demands 16-byte aligned
// bases and outer strides (_build.check_inputs), which is what a tensor map
// needs, and a ragged d or f (a row that ends inside a 16-byte vector) is
// read as zeros past the edge by TMA.  The float32 kernels load 16-byte
// vectors where a vector lies inside the matrix and element by element at a
// ragged edge.  Skipping experts that received no token is later work.
#include "common.cuh"

namespace ham {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// skinny kernel
constexpr int kRows = 8;       // rows of x a skinny block carries (C <= kRows)
constexpr int kChunkD = 512;   // d positions of x per shared-memory stage
constexpr int kGroup = 4;      // consecutive w rows a warp takes at a time
constexpr int kInFlight = 2;   // groups loaded before the first is used

// tiled kernel (float32)
constexpr int kBC = 64, kBF = 64, kBD = 32;
constexpr int kPadX = 4;       // x-tile row padding (floats), keeps float4 rows aligned

// The first n elements of a 16-byte vector at p (all of them when n >= N,
// none when n <= 0), the rest zero.  A partial vector is read element by
// element, so nothing past the matrix edge is touched.
template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* p, int n) {
  constexpr int N = Vec<T>::N;
  if (n >= N) return load16(p);
  unsigned wd[4] = {0u, 0u, 0u, 0u};
  if (n > 0) {
    if constexpr (sizeof(T) == 4) {
      const unsigned* q = reinterpret_cast<const unsigned*>(p);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < n) wd[i] = q[i];
    } else {
      const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i < n) wd[i / 2] |= static_cast<unsigned>(q[i]) << (16 * (i % 2));
    }
  }
  return make_uint4(wd[0], wd[1], wd[2], wd[3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gmm_skinny(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
           int C, int D, int F, int64_t x_se, int64_t x_sc, int64_t w_se, int64_t w_sd,
           int64_t o_se, int64_t o_sc) {
  constexpr int VN = Vec<T>::N;
  constexpr int kStep = kWarps * kGroup;  // rows between one warp's groups
  static_assert(kWarps * 32 * VN <= kRows * kChunkD, "reduction buffer fits in xs");
  static_assert(32 * VN <= kThreads, "one thread per output column");
  __shared__ __align__(16) float xs[kRows * kChunkD];  // x[e, c, d0 + j] at c * kChunkD + j

  const int e = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col = (blockIdx.x * 32 + lane) * VN;  // this lane's first column
  const int ncol = F - col;                       // columns of the vector inside f
  const T* xe = x + e * x_se;
  const T* we = w + e * w_se + col;

  float acc[kRows][VN];
#pragma unroll
  for (int c = 0; c < kRows; ++c)
#pragma unroll
    for (int j = 0; j < VN; ++j) acc[c][j] = 0.f;

  for (int d0 = 0; d0 < D; d0 += kChunkD) {
    const int nd = min(kChunkD, D - d0);
    __syncthreads();  // the previous stage is consumed
    for (int i = threadIdx.x; i < kRows * (kChunkD / VN); i += kThreads) {
      const int c = i / (kChunkD / VN), j = (i % (kChunkD / VN)) * VN;
      float f[VN];
      Vec<T>::to_float(load_vec(xe + c * x_sc + d0 + j, c < C ? nd - j : 0), f);
#pragma unroll
      for (int u = 0; u < VN; ++u) xs[c * kChunkD + j + u] = f[u];
    }
    __syncthreads();
    if (ncol <= 0) continue;  // a lane past f keeps the block's barriers

    for (int r0 = warp * kGroup; r0 < nd; r0 += kStep * kInFlight) {
      uint4 raw[kInFlight][kGroup];
#pragma unroll
      for (int g = 0; g < kInFlight; ++g)
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const int r = r0 + g * kStep + u;
          raw[g][u] = r < nd ? load_vec(we + (d0 + r) * w_sd, ncol) : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
      for (int g = 0; g < kInFlight; ++g) {
        const int r = r0 + g * kStep;  // rows past nd hold zero w and zero x
        if (r >= nd) break;
        float wf[kGroup][VN];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) Vec<T>::to_float(raw[g][u], wf[u]);
#pragma unroll
        for (int c = 0; c < kRows; ++c) {
          const float4 xv = *reinterpret_cast<const float4*>(xs + c * kChunkD + r);
          const float xr[kGroup] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int u = 0; u < kGroup; ++u)
#pragma unroll
            for (int j = 0; j < VN; ++j) acc[c][j] = fmaf(xr[u], wf[u][j], acc[c][j]);
        }
      }
    }
  }

  // the warps' partial sums, one row of x at a time, through xs
  float* red = xs;  // [kWarps][32 * VN]
  T* orow = out + e * o_se + blockIdx.x * 32 * VN;
  const int t = threadIdx.x;
#pragma unroll
  for (int c = 0; c < kRows; ++c) {  // unrolled: acc stays in registers
    if (c >= C) break;                // the same for the whole block
    __syncthreads();
#pragma unroll
    for (int j = 0; j < VN; ++j) red[warp * 32 * VN + lane * VN + j] = acc[c][j];
    __syncthreads();
    if (t < 32 * VN && blockIdx.x * 32 * VN + t < F) {
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) s += red[wi * 32 * VN + t];
      store(orow + c * o_sc + t, s);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gmm_tiled(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out,
          int C, int D, int F, int64_t x_se, int64_t x_sc, int64_t w_se, int64_t w_sd,
          int64_t o_se, int64_t o_sc) {
  using T = float;
  constexpr int VN = Vec<T>::N;
  constexpr int XR = kBD / VN;                 // vectors per x-tile row
  constexpr int WR = kBF / VN;                 // vectors per w-tile row
  constexpr int XV = kBC * XR / kThreads;      // x vectors per thread
  constexpr int WV = kBD * WR / kThreads;      // w vectors per thread
  static_assert(XV >= 1 && WV >= 1 && kThreads == 256, "tile shape");
  __shared__ __align__(16) float xs[kBD][kBC + kPadX];  // x tile, transposed: xs[k][c]
  __shared__ __align__(16) float ws[kBD][kBF];          // w tile: ws[k][f]

  const int e = blockIdx.z, c0 = blockIdx.x * kBC, f0 = blockIdx.y * kBF;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* xe = x + e * x_se;
  const T* we = w + e * w_se;

  uint4 xr[XV], wr[WV];
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int i = 0; i < XV; ++i) {
      const int idx = threadIdx.x + i * kThreads, row = idx / XR, k = (idx % XR) * VN;
      const int c = c0 + row;
      xr[i] = load_vec(xe + (c < C ? c : 0) * x_sc + k0 + k, c < C ? D - k0 - k : 0);
    }
#pragma unroll
    for (int i = 0; i < WV; ++i) {
      const int idx = threadIdx.x + i * kThreads, row = idx / WR, j = (idx % WR) * VN;
      const int k = k0 + row;
      wr[i] = load_vec(we + (k < D ? k : 0) * w_sd + f0 + j, k < D ? F - f0 - j : 0);
    }
  };
  auto store_tiles = [&]() {
#pragma unroll
    for (int i = 0; i < XV; ++i) {
      const int idx = threadIdx.x + i * kThreads, row = idx / XR, k = (idx % XR) * VN;
      float f[VN];
      Vec<T>::to_float(xr[i], f);
#pragma unroll
      for (int u = 0; u < VN; ++u) xs[k + u][row] = f[u];
    }
#pragma unroll
    for (int i = 0; i < WV; ++i) {
      const int idx = threadIdx.x + i * kThreads, row = idx / WR, j = (idx % WR) * VN;
      float f[VN];
      Vec<T>::to_float(wr[i], f);
#pragma unroll
      for (int u = 0; u < VN; u += 4)
        *reinterpret_cast<float4*>(&ws[row][j + u]) = make_float4(f[u], f[u + 1], f[u + 2], f[u + 3]);
    }
  };

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  load_tiles(0);
  for (int k0 = 0; k0 < D; k0 += kBD) {
    __syncthreads();  // the previous tile is consumed
    store_tiles();
    __syncthreads();
    if (k0 + kBD < D) load_tiles(k0 + kBD);  // in flight while this tile is multiplied
    float part[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[r][j] = 0.f;
#pragma unroll 8
    for (int k = 0; k < kBD; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[r][j] = fmaf(av[r], bv[j], part[r][j]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] += part[r][j];
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int c = c0 + ty * 4 + r;
    if (c >= C) continue;
    T* orow = out + e * o_se + c * o_sc;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int fc = f0 + tx * 4 + j;
      if (fc < F) store(orow + fc, acc[r][j]);
    }
  }
}

// ---- TMA routes (bf16) ------------------------------------------------------

// named barrier among the `n` threads of the consumer warps (id 0 is
// __syncthreads')
__device__ __forceinline__ void consumers_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" :: "r"(n) : "memory");
}

// stream kernel (bf16, C <= 8, decode)
constexpr int kSWarps = 4;                      // consumer warps
constexpr int kSThreads = 32 * (kSWarps + 1);   // + one producer warp
constexpr int kSRows = 16;                      // w rows per ring stage: one k16 step
constexpr int kSStages = 8;                     // ring depth: 128 KB in flight per SM
constexpr int kSCols = 256;                     // slab width: 16 m16 tiles of f
constexpr int kSBox = 64;                       // f columns of a TMA box (128 bytes, swizzled)
constexpr int kSStageBytes = kSRows * kSCols * 2;
constexpr int kSXD = 512;                       // d positions of x staged at a time
constexpr int kSXS = kSXD + 8;                  // bf16 row stride of the staged x
constexpr size_t kSSmem = 1024 + kSStages * kSStageBytes + kRows * kSXS * 2;
static_assert(kSWarps * kRows * kSCols * 4 <= kSStages * kSStageBytes, "reduction fits the ring");

__global__ void __launch_bounds__(kSThreads)
gmm_stream(const __grid_constant__ CUtensorMap wmap, const __nv_bfloat16* __restrict__ x,
           __nv_bfloat16* __restrict__ out, int C, int D, int F, int64_t x_se, int64_t x_sc,
           int64_t o_se, int64_t o_sc) {
  using T = __nv_bfloat16;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kSStages], empty[kSStages];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = smem;                                            // [stage][box][row][64]
  T* xs = reinterpret_cast<T*>(smem + kSStages * kSStageBytes);          // [c][kSXS]

  const int slab = blockIdx.x, e = blockIdx.y;
  const int nst = (D + kSRows - 1) / kSRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 0) {  // producer: one lane keeps the ring full with TMA boxes of w
    if (lane == 0)
      for (int i = 0; i < nst; ++i) {
        const int s = i % kSStages;
        mbar_wait(&empty[s], ((i / kSStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kSStageBytes);
        for (int bx = 0; bx < kSCols / kSBox; ++bx)
          tma_load_3d(ring + s * kSStageBytes + bx * kSRows * 128, &wmap, &full[s],
                      slab * kSCols + bx * kSBox, i * kSRows, e);
      }
  } else {
    // consumer warp cw takes stages cw, cw + kSWarps, ...: out^T = w^T x^T on
    // the tensor cores, w^T the A operand (16 f x 16 d, ldmatrix.trans from
    // the swizzled box), x^T the B operand (16 d x 8 rows of C)
    const int cw = warp - 1, ct = threadIdx.x - 32;
    const T* xe = x + e * x_se;
    float acc[kSCols / 16][4];
#pragma unroll
    for (int mt = 0; mt < kSCols / 16; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][i] = 0.f;
    for (int i = 0; i < nst; ++i) {
      const int r0 = i * kSRows;
      if (r0 % kSXD == 0) {  // the next kSXD positions of x, bf16, zero past C and past d
        consumers_sync(32 * kSWarps);
        for (int idx = ct; idx < kRows * (kSXD / 8); idx += 32 * kSWarps) {
          const int c = idx / (kSXD / 8), j = (idx % (kSXD / 8)) * 8;
          const int p = r0 + j;
          *reinterpret_cast<uint4*>(xs + c * kSXS + j) =
              load_vec(xe + c * x_sc + p, c < C ? D - p : 0);
        }
        consumers_sync(32 * kSWarps);
      }
      if (i % kSWarps != cw) continue;
      const int s = i % kSStages;
      mbar_wait(&full[s], (i / kSStages) & 1);
      const unsigned char* st = ring + s * kSStageBytes;
      const T* xr = xs + (lane / 4) * kSXS + r0 % kSXD + 2 * (lane % 4);
      const unsigned b0 = *reinterpret_cast<const unsigned*>(xr);
      const unsigned b1 = *reinterpret_cast<const unsigned*>(xr + 8);
      const int dr = (lane & 7) + ((lane >> 4) << 3);  // the stage row this lane addresses
#pragma unroll
      for (int mt = 0; mt < kSCols / 16; ++mt) {
        const int col = mt * 16 + ((lane >> 3) & 1) * 8;
        const int chunk = (col % kSBox) / 8;           // 16-byte chunk, 128-byte swizzle
        unsigned a[4];
        ldmatrix_x4_trans(a, st + (col / kSBox) * kSRows * 128 + dr * 128 +
                                 ((chunk ^ (dr & 7)) * 16));
        mma_bf16(acc[mt], a, b0, b1);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // the consumer warps' sums meet in the ring (every stage has landed and
    // been read), then add in warp order (deterministic); fragment (mt, i):
    // f column 16 mt + lane / 4 + 8 (i / 2), row of C 2 (lane % 4) + i % 2
    consumers_sync(32 * kSWarps);
    float* red = reinterpret_cast<float*>(smem);  // [warp][c][col]
#pragma unroll
    for (int mt = 0; mt < kSCols / 16; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[(cw * kRows + 2 * (lane % 4) + i % 2) * kSCols + mt * 16 + lane / 4 + 8 * (i / 2)] =
            acc[mt][i];
    consumers_sync(32 * kSWarps);
    for (int idx = ct; idx < kRows * kSCols; idx += 32 * kSWarps) {
      const int c = idx / kSCols, col = slab * kSCols + idx % kSCols;
      if (c >= C || col >= F) continue;
      float sum = 0.f;
      for (int w = 0; w < kSWarps; ++w) sum += red[w * kRows * kSCols + idx];
      store(out + e * o_se + c * o_sc + col, sum);
    }
  }
}

// wgmma kernel: out[e] (M x N) = A[e] (M x K) B[e] (K x N), bf16 operands
// read in place through TMA maps.  The forward (C > 8, prefill) is M = C,
// K = d, N = f with x K-major and w N-major; the backward's products are
// dx = dy w^T (M = C, K = f, N = d: dy K-major, w^T K-major, since w[e]'s
// rows run along f) and dw = x^T dy (M = d, K = C, N = f: x^T M-major,
// since x[e]'s rows run along d; dy N-major).  The layouts are template
// parameters: they fix which coordinate of each operand's map is
// innermost, the shared-memory descriptors and wgmma's transpose bits.
// Every box is 64 x 64 elements with the 128-byte swizzle, so a stage has
// one layout whatever the operands'.
constexpr int kWN = 128;                       // N columns of a tile (two 64-wide boxes)
constexpr int kWK = 64;                        // K per stage
constexpr int kWSlabs = 4;                     // 64-row slabs of M a tile covers (256 rows)
constexpr int kWStages = 4;
constexpr int kWThreads = 384;                 // producer warpgroup + 2 consumer warpgroups
constexpr int kWSlabBytes = 64 * kWK * 2;      // 8 KB: one 64 x 64 box of A
constexpr int kWBoxBytes = kWK * 64 * 2;       // 8 KB: one 64 x 64 box of B
constexpr int kWStageBytes = kWSlabs * kWSlabBytes + 2 * kWBoxBytes;
constexpr size_t kWSmem = 1024 + kWStages * kWStageBytes;

// Operand layouts of a wgmma product (template parameter of gmm_wgmma).
struct FwdLayout {  // out = x w: A K-major, B N-major; tiles (256-row chunk, expert, N tile)
  static constexpr bool kAMajorM = false, kBMajorK = false, kExpertOuter = false;
};
struct DxLayout {   // dx = dy w^T: A K-major, B K-major; tiles (expert, chunk, N tile)
  static constexpr bool kAMajorM = false, kBMajorK = true, kExpertOuter = true;
};
struct DwLayout {   // dw = x^T dy: A M-major, B N-major; tiles (expert, chunk, N tile)
  static constexpr bool kAMajorM = true, kBMajorK = false, kExpertOuter = true;
};

template <class Lay>
__global__ void __launch_bounds__(kWThreads, 1)
gmm_wgmma(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
          __nv_bfloat16* __restrict__ out, int E, int M, int N, int nk, int ntiles,
          int64_t o_se, int64_t o_sc) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kWStages], empty[kWStages];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int nf = (N + kWN - 1) / kWN, nm = (M + kWSlabs * 64 - 1) / (kWSlabs * 64);
  const int wg = threadIdx.x / 128, tw = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();
  // tile t: (256-row chunk of M, expert, N tile), full chunks first, or
  // (expert, chunk, N tile), so one expert's operands stay in L2 while its
  // tiles run; block b takes tiles b, b + gridDim.x, ...
  auto tile_of = [&](int t, int& mi, int& e, int& fi) {
    fi = t % nf;
    if (Lay::kExpertOuter) {
      mi = (t / nf) % nm;
      e = t / (nf * nm);
    } else {
      e = (t / nf) % E;
      mi = t / (E * nf);
    }
  };

  if (wg == 0) {  // producer warpgroup: one thread starts the TMA loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tw == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        int mi, e, fi;
        tile_of(t, mi, e, fi);
        const int row0 = mi * kWSlabs * 64;
        const int nslab = min(kWSlabs, (M - row0 + 63) / 64);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % kWStages;
          mbar_wait(&empty[s], ((it / kWStages) & 1) ^ 1);
          unsigned char* st = smem + s * kWStageBytes;
          mbar_expect_tx(&full[s], nslab * kWSlabBytes + 2 * kWBoxBytes);
          for (int sl = 0; sl < nslab; ++sl) {
            if (Lay::kAMajorM)   // map (M, K, E)
              tma_load_3d(st + sl * kWSlabBytes, &amap, &full[s], row0 + sl * 64, kt * kWK, e);
            else                 // map (K, M, E)
              tma_load_3d(st + sl * kWSlabBytes, &amap, &full[s], kt * kWK, row0 + sl * 64, e);
          }
          unsigned char* bs = st + kWSlabs * kWSlabBytes;
          for (int h = 0; h < 2; ++h) {
            if (Lay::kBMajorK)   // map (K, N, E)
              tma_load_3d(bs + h * kWBoxBytes, &bmap, &full[s], kt * kWK, fi * kWN + h * 64, e);
            else                 // map (N, K, E)
              tma_load_3d(bs + h * kWBoxBytes, &bmap, &full[s], fi * kWN + h * 64, kt * kWK, e);
          }
        }
      }
    }
  } else {        // consumer warpgroup c: columns 64 c .. 64 c + 63 of every slab of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1, warp = tw / 32, lane = tw % 32;
    float acc[kWSlabs][32];
    int it = 0, held = -1;  // held: the stage whose products may still be in flight
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      int mi, e, fi;
      tile_of(t, mi, e, fi);
      const int row0 = mi * kWSlabs * 64;
      const int nslab = min(kWSlabs, (M - row0 + 63) / 64);
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kWStages;
        mbar_wait(&full[s], (it / kWStages) & 1);
        const unsigned char* st = smem + s * kWStageBytes;
        const unsigned char* bs = st + kWSlabs * kWSlabBytes + c * kWBoxBytes;
#pragma unroll
        for (int sl = 0; sl < kWSlabs; ++sl) wgmma_fence_operands(acc[sl]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWK / 16; ++kk) {
          // a 16-deep step: 32 bytes along a K-major box's swizzled rows,
          // or 16 rows of 128 bytes of an MN-major box; 8-row groups 1024
          // bytes apart (SBO)
          const uint64_t db = Lay::kBMajorK ? wgmma_desc(bs + kk * 32, 16, 1024)
                                            : wgmma_desc(bs + kk * 16 * 128, kWBoxBytes, 1024);
          const int scale = kt > 0 || kk > 0;
#pragma unroll
          for (int sl = 0; sl < kWSlabs; ++sl) {
            const unsigned char* as = st + sl * kWSlabBytes;
            const uint64_t da = Lay::kAMajorM ? wgmma_desc(as + kk * 16 * 128, kWSlabBytes, 1024)
                                              : wgmma_desc(as + kk * 32, 16, 1024);
            if (sl < nslab)
              wgmma_m64n64k16<Lay::kAMajorM ? 1 : 0, Lay::kBMajorK ? 0 : 1>(acc[sl], da, db,
                                                                             scale);
          }
        }
        wgmma_commit();
        // one stage of products stays in flight: once the previous stage's
        // are done, its buffers go back to the producer
        wgmma_wait<1>();
        if (held >= 0 && tw == 0) mbar_arrive(&empty[held]);
        held = s;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int sl = 0; sl < kWSlabs; ++sl) wgmma_fence_operands(acc[sl]);
      if (tw == 0) mbar_arrive(&empty[held]);
      held = -1;
      // epilogue, while the producer loads the next tile: bf16 pairs from
      // the fragments (single elements where a pair is not 4-byte aligned
      // or reaches past N); d[4 j + i] of slab sl is row 64 sl + 16 warp +
      // lane / 4 + 8 (i / 2), column 64 c + 8 j + 2 (lane % 4) + i % 2
      __nv_bfloat16* oe = out + e * o_se;
      const bool pairs = o_se % 2 == 0 && o_sc % 2 == 0;
#pragma unroll
      for (int sl = 0; sl < kWSlabs; ++sl) {
        if (sl >= nslab) break;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = fi * kWN + c * 64 + j * 8 + 2 * (lane % 4);
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int row = row0 + sl * 64 + warp * 16 + lane / 4 + 8 * hr;
            const float v0 = acc[sl][4 * j + 2 * hr], v1 = acc[sl][4 * j + 2 * hr + 1];
            if (row >= M || col >= N) continue;
            if (pairs && col + 1 < N) {
              *reinterpret_cast<unsigned*>(oe + row * o_sc + col) = pack_bf16(v0, v1);
            } else {
              store(oe + row * o_sc + col, v0);
              if (col + 1 < N) store(oe + row * o_sc + col + 1, v1);
            }
          }
        }
      }
    }
  }
}

// Routes, chosen by the Python wrapper (kernels/grouped_matmul.py `route`).
enum Route : int { kSkinny = 0, kTiled = 1, kStream = 2, kWgmma = 3 };

// A byte stride usable in a tensor map: a size-1 dim's stride is never
// used to address, so any multiple of 16 stands in for it.
inline uint64_t map_stride(long long elems, int size) {
  return size > 1 ? static_cast<uint64_t>(elems) * 2 : 16;
}

int launch_stream(const __nv_bfloat16* x, const __nv_bfloat16* w, __nv_bfloat16* out, int E,
                  int C, int D, int F, const long long* st, cudaStream_t stream) {
  // w as (f, d, E), boxes of 16 rows x 64 columns, 128-byte swizzle; the
  // weights' maps come from the table after a layer's first call
  const CUtensorMap* wmap = cached_tensor_map(w, F, D, E, map_stride(st[3], D),
                                              map_stride(st[2], E), kSBox, kSRows,
                                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (!wmap) return kTensorMap;
  cudaError_t err = allow_smem_once<gmm_stream>(kSSmem);
  if (err != cudaSuccess) return err;
  gmm_stream<<<dim3((F + kSCols - 1) / kSCols, E), kSThreads, kSSmem, stream>>>(
      *wmap, x, out, C, D, F, st[0], st[1], st[4], st[5]);
  return cudaGetLastError();
}

// A 64 x 64 box map of a bf16 (d0 innermost, d1, E) operand whose two
// outer element strides are s1 (along d1) and s2 (along E)
inline bool box_map(CUtensorMap* map, const __nv_bfloat16* p, int d0, int d1, int E,
                    long long s1, long long s2) {
  return encode_tensor_map(map, p, d0, d1, E, map_stride(s1, d1), map_stride(s2, E), 64, 64,
                           CU_TENSOR_MAP_SWIZZLE_128B);
}

template <class Lay>
int launch_product(const CUtensorMap& amap, const CUtensorMap& bmap, __nv_bfloat16* out, int E,
                   int M, int N, int K, int grid, long long o_se, long long o_sc,
                   cudaStream_t stream) {
  cudaError_t err = allow_smem_once<gmm_wgmma<Lay>>(kWSmem);
  if (err != cudaSuccess) return err;
  const int nf = (N + kWN - 1) / kWN, nm = (M + kWSlabs * 64 - 1) / (kWSlabs * 64);
  const int ntiles = nm * E * nf;
  if (grid < 1) return kUnsupported;
  gmm_wgmma<Lay><<<min(grid, ntiles), kWThreads, kWSmem, stream>>>(
      amap, bmap, out, E, M, N, (K + kWK - 1) / kWK, ntiles, o_se, o_sc);
  return cudaGetLastError();
}

int launch_wgmma(const __nv_bfloat16* x, const __nv_bfloat16* w, __nv_bfloat16* out, int E,
                 int C, int D, int F, int grid, const long long* st, cudaStream_t stream) {
  // x as (d, C, E), w as (f, d, E); x is a new activation every call, w's
  // map comes from the table
  CUtensorMap xmap;
  const CUtensorMap* wmap = cached_tensor_map(w, F, D, E, map_stride(st[3], D),
                                              map_stride(st[2], E), 64, kWK,
                                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (!wmap || !box_map(&xmap, x, D, C, E, st[1], st[0])) return kTensorMap;
  return launch_product<FwdLayout>(xmap, *wmap, out, E, C, F, D, grid, st[4], st[5], stream);
}

// dx = dy w^T and dw = x^T dy, one product each, reading x (E, C, d), w (E,
// d, f) and dy (E, C, f) where they lie.  st: element strides (x_se, x_sc,
// w_se, w_sd, dy_se, dy_sc, dx_se, dx_sc, dw_se, dw_sd).
int launch_backward(const __nv_bfloat16* x, const __nv_bfloat16* w, const __nv_bfloat16* dy,
                    __nv_bfloat16* dx, __nv_bfloat16* dw, int E, int C, int D, int F, int grid,
                    const long long* st, cudaStream_t stream) {
  CUtensorMap dymap, xmap;
  // dx: A = dy as (f, C, E), B = w^T as w's (f, d, E), from the table
  const CUtensorMap* wmap = cached_tensor_map(w, F, D, E, map_stride(st[3], D),
                                              map_stride(st[2], E), 64, kWK,
                                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (!wmap || !box_map(&dymap, dy, F, C, E, st[5], st[4])) return kTensorMap;
  int err = launch_product<DxLayout>(dymap, *wmap, dx, E, C, D, F, grid, st[6], st[7], stream);
  if (err != 0) return err;
  // dw: A = x^T as x's (d, C, E), B = dy as (f, C, E): both maps box 64 x
  // 64, so dy's serves again; the contraction over C reads zeros past C
  if (!box_map(&xmap, x, D, C, E, st[1], st[0])) return kTensorMap;
  return launch_product<DwLayout>(xmap, dymap, dw, E, D, F, C, grid, st[8], st[9], stream);
}

int launch_f32(int route, const float* x, const float* w, float* out, int E, int C, int D, int F,
               const long long* st, cudaStream_t stream) {
  if (route == kSkinny && C <= kRows) {
    constexpr int cols = 32 * Vec<float>::N;
    gmm_skinny<float><<<dim3((F + cols - 1) / cols, E), kThreads, 0, stream>>>(
        x, w, out, C, D, F, st[0], st[1], st[2], st[3], st[4], st[5]);
  } else if (route == kTiled) {
    const dim3 grid((C + kBC - 1) / kBC, (F + kBF - 1) / kBF, E);  // C tiles of one w tile adjacent
    gmm_tiled<<<grid, kThreads, 0, stream>>>(x, w, out, C, D, F, st[0], st[1], st[2], st[3],
                                             st[4], st[5]);
  } else {
    return kUnsupported;
  }
  return cudaGetLastError();
}

int launch_bf16(int route, int grid, const __nv_bfloat16* x, const __nv_bfloat16* w,
                __nv_bfloat16* out, int E, int C, int D, int F, const long long* st,
                cudaStream_t stream) {
  if (route == kStream && C <= kRows) return launch_stream(x, w, out, E, C, D, F, st, stream);
  if (route == kWgmma) return launch_wgmma(x, w, out, E, C, D, F, grid, st, stream);
  return kUnsupported;
}

}  // namespace
}  // namespace ham

// (dx, dw) of out = x w for the gradient dy of out, bf16: x (E, C, d), w (E,
// d, f), dy and dx, dw of their shapes, every operand read in place
// through its element strides (unit last dim; bases and outer strides
// 16-byte aligned): st = (x_se, x_sc, w_se, w_sd, dy_se, dy_sc, dx_se,
// dx_sc, dw_se, dw_sd); grid: persistent blocks of each product.  Two
// launches of the wgmma kernel.  Returns 0 or the launch error.
extern "C" int ham_grouped_matmul_backward(const void* x, const void* w, const void* dy, void* dx,
                                           void* dw, int E, int C, int D, int F, int grid,
                                           const long long* st, int device, void* stream) {
  if (E == 0 || D == 0 || F == 0) return 0;
  if (C == 0) return ham::kUnsupported;  // dw would be zeros the kernel does not write
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  using B16 = __nv_bfloat16;
  return ham::launch_backward(static_cast<const B16*>(x), static_cast<const B16*>(w),
                              static_cast<const B16*>(dy), static_cast<B16*>(dx),
                              static_cast<B16*>(dw), E, C, D, F, grid, st,
                              static_cast<cudaStream_t>(stream));
}

// x (E, C, d), w (E, d, f), out (E, C, f): element strides of the two outer
// dims (the last dim is contiguous; bases and outer strides 16-byte
// aligned).  route: 0 skinny (float32, C <= 8), 1 tiled (float32), 2 stream
// (bf16, C <= 8), 3 wgmma (bf16); grid: the wgmma route's persistent
// blocks.  Returns 0 or the launch error.
extern "C" int ham_grouped_matmul(
    const void* x, const void* w, void* out, int E, int C, int D, int F, int dtype, int route,
    int grid, long long x_se, long long x_sc, long long w_se, long long w_sd,
    long long o_se, long long o_sc, int device, void* stream) {
  if (E == 0 || C == 0 || F == 0) return 0;
  if (E > 65535) return ham::kUnsupported;  // the experts index a grid dim
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long st[6] = {x_se, x_sc, w_se, w_sd, o_se, o_sc};
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ham::kF32:
      return ham::launch_f32(route, static_cast<const float*>(x), static_cast<const float*>(w),
                             static_cast<float*>(out), E, C, D, F, st, s);
    case ham::kBF16:
      return ham::launch_bf16(route, grid, static_cast<const __nv_bfloat16*>(x),
                              static_cast<const __nv_bfloat16*>(w),
                              static_cast<__nv_bfloat16*>(out), E, C, D, F, st, s);
    default: return ham::kUnsupported;
  }
}
