// Grouped (per-expert) matmul for the MoE layer, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/grouped_matmul.py
// (_gmm_kernel): out[e] = x[e] @ w[e] over the capacity-padded dispatch
// layout (E, C, d) x (E, d, f) -> (E, C, f), products and sums in float32,
// the output rounded once to the input dtype after the last d step.
//
// Bound on an H100: bytes at decode (C <= 8: every call streams all E expert
// matrices, 268 MB for olmoe's gate at 2 flops per weight element per token),
// and on paper still bytes at a 1024-token prefill (C = 160).  Three kernels:
//  * skinny (C <= 8, decode): one block per (expert, 32 * VN columns of f);
//    lane l of every warp owns one 16-byte vector of w columns, so a warp
//    reads 512 contiguous bytes of one w row; the 8 warps split d, each
//    streaming its rows with 8 loads in flight per thread, while the 8 rows
//    of x sit in shared memory as float32 (512 d positions per stage); the
//    warps' partial sums meet in shared memory at the end.  w is read from
//    device memory exactly once per call;
//  * mma (bf16, C > 8, prefill): 64 x 128 output tiles on the tensor cores
//    (mma.sync m16n8k16, float32 accumulators, 8 warps of 32 x 32); 32-deep
//    bf16 x and w tiles go to shared memory with cp.async in a 3-stage ring
//    (zero-filled past a ragged edge) and into registers with ldmatrix (.trans
//    for w, whose rows run along f); the row padding keeps ldmatrix free of
//    bank conflicts;
//  * tiled (float32, C > 8): the same tiling on the CUDA cores, 64 x 64
//    tiles staged as float32, 4 x 4 outputs per thread, each 32-deep partial
//    sum added to the accumulator, which keeps the rounding error of a
//    d = 2048 sum near that of a blocked sum.  (The tensor cores take float32
//    only as TF32, which would miss the float32 tolerance.)
// The prefill kernels run the blocks that share a w tile (all C tiles of one
// expert and f tile) next to each other, so w is read from device memory
// about once and from L2 for the other C tiles.  All three read x and w
// through strides with a unit last dim, in 16-byte vectors where a vector
// lies inside the matrix and element by element at a ragged edge, and write
// the output element by element.  wgmma, TMA and skipping experts that
// received no token are later work.
#include <type_traits>

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

// mma kernel (bf16)
constexpr int kMC = 64, kMF = 128, kMK = 32;  // block tile: C x f, d per stage
constexpr int kStages = 3;                    // cp.async ring depth
constexpr int kAS = kMK + 8;                  // x-tile row, bf16 (80 B: conflict-free ldmatrix)
constexpr int kBS = kMF + 8;                  // w-tile row, bf16 (272 B: conflict-free ldmatrix)

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

__global__ void __launch_bounds__(kThreads)
gmm_mma(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
        __nv_bfloat16* __restrict__ out, int C, int D, int F, int64_t x_se, int64_t x_sc,
        int64_t w_se, int64_t w_sd, int64_t o_se, int64_t o_sc) {
  using T = __nv_bfloat16;
  constexpr int VN = Vec<T>::N;
  static_assert(kMC * kMK / VN == kThreads && kMK * kMF / VN == 2 * kThreads, "tile shape");
  __shared__ __align__(16) T as[kStages][kMC][kAS];  // x tiles: as[s][c][k]
  __shared__ __align__(16) T bs[kStages][kMK][kBS];  // w tiles: bs[s][k][f]

  const int c0 = blockIdx.x * kMC, f0 = blockIdx.y * kMF, e = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = (warp % 2) * 32, wn = (warp / 2) * 32;  // this warp's 32 x 32 of the tile
  const T* xe = x + e * x_se;
  const T* we = w + e * w_se;

  auto load_stage = [&](int s, int k0) {
    {  // x: 64 rows x 4 vectors, one per thread
      const int row = threadIdx.x / (kMK / VN), k = (threadIdx.x % (kMK / VN)) * VN;
      const int c = c0 + row;
      const int n = c < C ? min(VN, max(0, D - k0 - k)) : 0;
      cp_async16(&as[s][row][k], n > 0 ? xe + c * x_sc + k0 + k : xe, 2 * n);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // w: 32 rows x 16 vectors, two per thread
      const int idx = threadIdx.x + i * kThreads;
      const int row = idx / (kMF / VN), j = (idx % (kMF / VN)) * VN;
      const int k = k0 + row;
      const int n = k < D ? min(VN, max(0, F - f0 - j)) : 0;
      cp_async16(&bs[s][row][j], n > 0 ? we + k * w_sd + f0 + j : we, 2 * n);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][j][u] = 0.f;

  const int nk = (D + kMK - 1) / kMK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s * kMK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // stage kt has landed
    __syncthreads();               // ... for every thread, and stage kt - 1 is consumed
    const int pf = kt + kStages - 1;
    if (pf < nk) load_stage(pf % kStages, pf * kMK);
    cp_async_commit();
    const int s = kt % kStages;
#pragma unroll
    for (int kk = 0; kk < kMK; kk += 16) {
      unsigned a[2][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a[i], &as[s][wm + i * 16 + (lane & 15)][kk + (lane >> 4) * 8]);
      // b[jj] = {b0, b1} of n-tile 2 jj, then {b0, b1} of n-tile 2 jj + 1
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        ldmatrix_x4_trans(b[jj], &bs[s][kk + (lane & 15)][wn + jj * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], a[i], b[j / 2][2 * (j % 2)], b[j / 2][2 * (j % 2) + 1]);
    }
  }

  // accumulator (i, j): rows wm + 16 i + lane / 4 (+ 8), columns wn + 8 j + 2 (lane % 4) (+ 1)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + wm + i * 16 + lane / 4 + 8 * h;
      if (c >= C) continue;
      T* orow = out + e * o_se + c * o_sc;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int fc = f0 + wn + j * 8 + 2 * (lane % 4);
        if (fc < F) store(orow + fc, acc[i][j][2 * h]);
        if (fc + 1 < F) store(orow + fc + 1, acc[i][j][2 * h + 1]);
      }
    }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int E, int C, int D, int F,
           const long long* st, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  if (C <= kRows) {
    constexpr int cols = 32 * Vec<T>::N;
    const dim3 grid((F + cols - 1) / cols, E);
    gmm_skinny<T><<<grid, kThreads, 0, stream>>>(xp, wp, op, C, D, F, st[0], st[1], st[2],
                                                 st[3], st[4], st[5]);
  } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const dim3 grid((C + kMC - 1) / kMC, (F + kMF - 1) / kMF, E);  // C tiles of one w tile adjacent
    gmm_mma<<<grid, kThreads, 0, stream>>>(xp, wp, op, C, D, F, st[0], st[1], st[2], st[3],
                                           st[4], st[5]);
  } else {
    const dim3 grid((C + kBC - 1) / kBC, (F + kBF - 1) / kBF, E);  // C tiles of one w tile adjacent
    gmm_tiled<<<grid, kThreads, 0, stream>>>(xp, wp, op, C, D, F, st[0], st[1], st[2], st[3],
                                             st[4], st[5]);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace ham

// x (E, C, d), w (E, d, f), out (E, C, f): element strides of the two outer
// dims (the last dim is contiguous).  Returns 0 or the launch error.
extern "C" int ham_grouped_matmul(
    const void* x, const void* w, void* out, int E, int C, int D, int F, int dtype,
    long long x_se, long long x_sc, long long w_se, long long w_sd,
    long long o_se, long long o_sc, int device, void* stream) {
  if (E == 0 || C == 0 || F == 0) return 0;
  if (E > 65535) return ham::kUnsupported;  // the experts index a grid dim
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long st[6] = {x_se, x_sc, w_se, w_sd, o_se, o_sc};
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ham::kF32: return ham::launch<float>(x, w, out, E, C, D, F, st, s);
    case ham::kBF16: return ham::launch<__nv_bfloat16>(x, w, out, E, C, D, F, st, s);
    default: return ham::kUnsupported;
  }
}
