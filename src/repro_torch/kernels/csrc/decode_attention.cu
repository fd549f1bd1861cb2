// Single-token GQA decode attention over a KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (_decode_kernel): for each sequence b and kv head h, the q_per_kv query
// heads of the group attend over keys j < lengths[b] of the cache, with an
// online softmax in float32.
//
// Bound on an H100: bytes (the valid K/V prefix is read once; 4 flops per
// cached element per query head).  At the serving shape (B 8 x Hkv 8, 2048
// positions of d = 128 in bf16) that is 67 MB, 20 us at 3.35 TB/s, and
// reaching it takes most of the 132 SMs with copies in flight on each.
// Design:
//  * the valid cache of one (sequence, kv head) is split into `splits`
//    ranges (1, 2, 4 or 8, chosen on the host from B * Hkv alone so that
//    about 128 blocks run, one an SM), one block each; the blocks of one
//    (sequence, kv head) form a thread block cluster.  Each block derives
//    its range from lengths[b] on the device (ceil(len / splits) rounded up
//    to 64 keys), so the host never reads the lengths; an empty range
//    contributes max kNegInf, sum 0 and accumulator 0;
//  * every block holds the whole query group, so each K/V element leaves
//    device memory once per group (the Pallas kernel's GQA property); K/V
//    tiles stay in their own dtype in a 3-stage cp.async ring in shared
//    memory, read through (b, h, s) strides straight from the model's
//    (B, S, Hkv, d) cache, the next two tiles loading while one is consumed
//    (~109 KB at d = 128 in bf16: two blocks an SM);
//  * the 4 warps each take a quarter of every tile and keep their own
//    online-softmax state (max, sum, accumulator) in registers, so a tile
//    costs one barrier; bf16 runs Q K^T and P V as mma.sync m16n8k16 on the
//    tensor cores with the group padded to 16 rows, P going from the score
//    accumulators straight into A fragments; float32 runs both products on
//    the CUDA cores (the tensor cores take float32 only as TF32);
//  * the merge happens in the same launch: the warps' states merge in
//    shared memory, every block leaves its (max, sum, accumulator) there,
//    and after a cluster barrier rank 0 reads the others' through
//    distributed shared memory, rescales, sums and writes
//    acc / max(sum, 1e-30); a second barrier keeps the others resident
//    until it has read them.  No scratch in device memory, one launch.
//
// The int8 variant (ham_decode_attention_q8) reads the reference's kv_quant
// cache (repro/models/layers.py:269-301): int8 K/V with one float32 scale
// per (sequence, position, kv head) vector.  Its bound is bytes too, half
// the bf16 cache's plus the scales (at the serving shape 33.6 MB + 1.0 MB,
// 10.3 us).  It is the same kernel with one step more per tile: the int8
// rows (16 per cp.async) and their scales arrive in a ring of their own,
// and each warp widens its own rows of the current stage into one tile of
// the compute type, k = round(T(int8) * T(scale)) as the reference
// dequantizes, before the unchanged split/cluster/mma.sync body consumes
// them.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace ham {
namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQpk = 16;    // query heads per kv head (the mma tile's 16 rows)
constexpr int kMaxSplits = 8;  // the largest portable cluster
constexpr int kStages = 3;     // cp.async ring depth
constexpr int kAlign = 64;     // a split's range is a multiple of this many keys

// keys a ring stage holds, and a tile row with 16 bytes of padding (elements)
template <typename T>
__host__ __device__ constexpr int tile_keys() { return sizeof(T) == 2 ? 64 : 32; }
template <typename T, int D>
__host__ __device__ constexpr int row_elems() { return D + 16 / static_cast<int>(sizeof(T)); }

// int8 tile rows: D bytes and 16 of padding
template <int D>
__host__ __device__ constexpr int row8() { return D + 16; }

// the K/V ring; with Q8 the int8 ring, its scales and the widened tile
template <typename T, int D, bool Q8>
__host__ __device__ constexpr size_t ring_bytes() {
  return Q8 ? kStages * 2 * tile_keys<T>() * (row8<D>() + sizeof(float)) +
                  sizeof(T) * 2 * tile_keys<T>() * row_elems<T, D>()
            : sizeof(T) * kStages * 2 * tile_keys<T>() * row_elems<T, D>();
}
// part_acc, part_m, part_l, blk_acc, blk_m, blk_l and the merge weights
template <int D>
__host__ __device__ constexpr size_t merge_bytes() {
  return sizeof(float) * (kWarps * kMaxQpk * (D + 2) + kMaxQpk * (D + 2) +
                          kMaxSplits * kMaxQpk);
}
// the ring, whose bytes hold the merge buffers after the key loop
template <typename T, int D, bool Q8>
__host__ __device__ constexpr size_t pool_bytes() {
  return ring_bytes<T, D, Q8>() > merge_bytes<D>() ? ring_bytes<T, D, Q8>() : merge_bytes<D>();
}
// float32 only: each warp's p and rescale per head
template <typename T>
__host__ __device__ constexpr size_t scratch_bytes() {
  return std::is_same_v<T, float>
             ? sizeof(float) * kWarps * kMaxQpk * (tile_keys<T>() / kWarps + 1) : 0;
}
template <typename T, int D, bool Q8>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(T) * kMaxQpk * row_elems<T, D>() + pool_bytes<T, D, Q8>() + scratch_bytes<T>();
}

// the scales of the int8 variant: element strides of (b, h, s); null
// pointers for the plain variant
struct Scales {
  const float* k;
  const float* v;
  int64_t k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
};

// the reference's dequantization, q_dtype(x) * q_dtype(scale) rounded to
// q_dtype (an int8 value and a bf16 scale multiply exactly in float32)
__device__ __forceinline__ float dequant(int8_t x, float s, float) { return x * s; }
__device__ __forceinline__ __nv_bfloat16 dequant(int8_t x, float s, __nv_bfloat16) {
  return __float2bfloat16_rn(static_cast<float>(x) * __bfloat162float(__float2bfloat16_rn(s)));
}

template <typename T, int D, bool Q8>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const std::conditional_t<Q8, int8_t, T>* __restrict__ k,
              const std::conditional_t<Q8, int8_t, T>* __restrict__ v,
              const int* __restrict__ lengths, T* __restrict__ out, int qpk, int S,
              int64_t q_sb, int64_t q_sh, int64_t q_sg,
              int64_t k_sb, int64_t k_sh, int64_t k_ss,
              int64_t v_sb, int64_t v_sh, int64_t v_ss,
              int64_t o_sb, int64_t o_sh, int64_t o_sg, float scale_log2, Scales sc) {
  using KV = std::conditional_t<Q8, int8_t, T>;
  constexpr bool kBF16 = std::is_same_v<T, __nv_bfloat16>;
  constexpr int KT = tile_keys<T>();          // keys a stage
  constexpr int KW = KT / kWarps;             // keys a warp takes of each stage
  constexpr int RS = row_elems<T, D>();       // tile row (elements)
  constexpr int VN = 16 / sizeof(T);          // elements of a 16-byte vector
  constexpr int CH = D / VN;                  // 16-byte vectors a row
  constexpr int R8 = row8<D>();               // int8 tile row (bytes)
  static_assert(D % 16 == 0, "head_dim");

  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);        // [kMaxQpk][RS]; rows >= qpk zero
  T* ring = qs + kMaxQpk * RS;                // [kStages][K, V][KT][RS]
  // int8 variant: [kStages][K, V][KT][R8] bytes, then [kStages][K, V][KT]
  // scales, then the widened [K, V][KT][RS] tile the body reads
  int8_t* ring8 = reinterpret_cast<int8_t*>(ring);
  float* scl = reinterpret_cast<float*>(ring8 + kStages * 2 * KT * R8);
  T* wide = reinterpret_cast<T*>(scl + kStages * 2 * KT);
  // after the key loop the ring holds the merge buffers
  float* part_acc = reinterpret_cast<float*>(ring);  // [kWarps][kMaxQpk][D]
  float* part_m = part_acc + kWarps * kMaxQpk * D;   // [kWarps][kMaxQpk]
  float* part_l = part_m + kWarps * kMaxQpk;
  float* blk_acc = part_l + kWarps * kMaxQpk;        // [kMaxQpk][D]: what rank 0 reads
  float* blk_m = blk_acc + kMaxQpk * D;
  float* blk_l = blk_m + kMaxQpk;
  float* wgt = blk_l + kMaxQpk;                      // [kMaxSplits][kMaxQpk]
  float* scratch =
      reinterpret_cast<float*>(reinterpret_cast<char*>(ring) + pool_bytes<T, D, Q8>());

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = gridDim.x, rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int len = min(max(lengths[b], 0), S);
  const int chunk = ((len + splits - 1) / splits + kAlign - 1) / kAlign * kAlign;
  const int k_lo = min(len, rank * chunk), k_hi = min(len, k_lo + chunk);
  const int nt = (k_hi - k_lo + KT - 1) / KT;
  const KV* kb = k + b * k_sb + h * k_sh;
  const KV* vb = v + b * v_sb + h * v_sh;

  // the group's query rows (rows >= qpk zero) in the first cp.async group
  const T* qb = q + b * q_sb + h * q_sh;
  for (int idx = tid; idx < kMaxQpk * CH; idx += kThreads) {
    const int g = idx / CH, c = (idx % CH) * VN;
    cp_async16(qs + g * RS + c, g < qpk ? qb + g * q_sg + c : qb, g < qpk ? 16 : 0);
  }
  // key tile i -> stage i % kStages; keys at or past k_hi are zero-filled
  const auto load_tile = [&](int i) {
    const int key0 = k_lo + i * KT;
    if constexpr (Q8) {
      int8_t* ks = ring8 + (i % kStages) * 2 * KT * R8;
      int8_t* vs = ks + KT * R8;
      for (int idx = tid; idx < KT * (D / 16); idx += kThreads) {
        const int r = idx / (D / 16), c = (idx % (D / 16)) * 16;
        const bool ok = key0 + r < k_hi;
        cp_async16(ks + r * R8 + c, ok ? kb + (key0 + r) * k_ss + c : kb, ok ? 16 : 0);
        cp_async16(vs + r * R8 + c, ok ? vb + (key0 + r) * v_ss + c : vb, ok ? 16 : 0);
      }
      float* ss = scl + (i % kStages) * 2 * KT;  // [K, V][KT]
      const float* kscale = sc.k + b * sc.k_sb + h * sc.k_sh;
      const float* vscale = sc.v + b * sc.v_sb + h * sc.v_sh;
      for (int r = tid; r < 2 * KT; r += kThreads) {
        const int key = key0 + r % KT;
        const bool ok = key < k_hi;
        const float* src = r < KT ? kscale + key * sc.k_ss : vscale + key * sc.v_ss;
        cp_async4(ss + r, ok ? src : kscale, ok ? 4 : 0);
      }
    } else {
      T* ks = ring + (i % kStages) * 2 * KT * RS;
      T* vs = ks + KT * RS;
      for (int idx = tid; idx < KT * CH; idx += kThreads) {
        const int r = idx / CH, c = (idx % CH) * VN;
        const bool ok = key0 + r < k_hi;
        cp_async16(ks + r * RS + c, ok ? kb + (key0 + r) * k_ss + c : kb, ok ? 16 : 0);
        cp_async16(vs + r * RS + c, ok ? vb + (key0 + r) * v_ss + c : vb, ok ? 16 : 0);
      }
    }
  };
  // the K and V tiles of key tile t: the ring's stage (landed for every
  // thread at the caller's barrier), or (int8) the stage widened into
  // `wide`.  Each warp reads only its own KW rows of K and V, so it widens
  // just those: warp-local syncs, no second block barrier
  const auto stage = [&](int t) -> const T* {
    if constexpr (Q8) {
      const int8_t* src = ring8 + (t % kStages) * 2 * KT * R8;
      const float* ss = scl + (t % kStages) * 2 * KT;
      __syncwarp();  // this warp's lanes are done with its rows of the last tile
      for (int idx = lane; idx < 2 * KW * CH; idx += 32) {
        const int rr = idx / CH, c = (idx % CH) * VN;  // rr: K rows, then V rows
        const int r = KW * warp + (rr < KW ? rr : KT - KW + rr);
        const float s = ss[r];
        using Raw = std::conditional_t<VN == 8, uint2, unsigned>;  // VN int8 values
        alignas(16) int8_t x[VN];
        *reinterpret_cast<Raw*>(x) = *reinterpret_cast<const Raw*>(src + r * R8 + c);
        alignas(16) T y[VN];
#pragma unroll
        for (int e = 0; e < VN; ++e) y[e] = dequant(x[e], s, T{});
        *reinterpret_cast<uint4*>(wide + r * RS + c) = *reinterpret_cast<const uint4*>(y);
      }
      __syncwarp();
      return wide;
    } else {
      return ring + (t % kStages) * 2 * KT * RS;
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nt) load_tile(i);
    cp_async_commit();
  }

  if constexpr (kBF16) {
    // ---- tensor cores: rows of the group padded to 16, keys 16 a warp a tile
    unsigned qf[D / 16][4];
    float acc[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};  // rows lane / 4 (+ 8)

    for (int t = 0; t < nt; ++t) {
      cp_async_wait<kStages - 2>();  // tile t (and q) have landed ...
      __syncthreads();               // ... for every thread, and tile t - 1 is consumed
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ldmatrix_x4(qf[kk], qs + (lane & 15) * RS + kk * 16 + (lane >> 4) * 8);
      }
      if (t + kStages - 1 < nt) load_tile(t + kStages - 1);
      cp_async_commit();
      const T* kt = stage(t) + KW * warp * RS;  // this warp's keys
      const T* vt = kt + KT * RS;
      const int kw0 = k_lo + t * KT + KW * warp;
      if (kw0 >= k_hi) continue;  // warp-uniform: none of this warp's keys is valid

      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        unsigned kf[4];  // {b0, b1} of keys kw0 + 0..7, then of kw0 + 8..15
        ldmatrix_x4(kf, kt + ((lane & 7) + (lane >> 4) * 8) * RS + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[0], qf[kk], kf[0], kf[1]);
        mma_bf16(s[1], qf[kk], kf[2], kf[3]);
      }
      // element (j, e): key kw0 + 8 j + 2 (lane % 4) + e % 2, row lane / 4 + 8 (e / 2)
      const bool tail = kw0 + KW > k_hi;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] *= scale_log2;
          if (tail && kw0 + 8 * j + 2 * (lane % 4) + (e & 1) >= k_hi) s[j][e] = kNegInf;
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = fmaxf(fmaxf(s[0][2 * hh], s[0][2 * hh + 1]),
                         fmaxf(s[1][2 * hh], s[1][2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_i[hh], mx);
        const float m_use = m_new == kNegInf ? 0.f : m_new;
        const float alpha = exp2f(m_i[hh] - m_use);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
            s[j][e] = exp2f(s[j][e] - m_use);
            sum += s[j][e];
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l_i[hh] = alpha * l_i[hh] + sum;
        m_i[hh] = m_new;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[j][2 * hh] *= alpha;
          acc[j][2 * hh + 1] *= alpha;
        }
      }
      const unsigned a[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                             pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        unsigned vf[4];
        ldmatrix_x4_trans(vf, vt + (lane & 15) * RS + dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], a, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], a, vf[2], vf[3]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring, which now takes the partials
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int g = lane / 4 + 8 * hh;
      if (lane % 4 == 0) {
        part_m[warp * kMaxQpk + g] = m_i[hh];
        part_l[warp * kMaxQpk + g] = l_i[hh];
      }
      float* pa = part_acc + (warp * kMaxQpk + g) * D + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        pa[8 * j] = acc[j][2 * hh];
        pa[8 * j + 1] = acc[j][2 * hh + 1];
      }
    }
  } else {
    // ---- CUDA cores: lane scores key lane % KW of the warp's KW against heads
    // lane / KW + HS i; then owns columns lane + 32 u of every head for P V
    constexpr int HS = 32 / KW;           // lanes sharing a key
    constexpr int NH = kMaxQpk / HS;      // heads a lane scores
    constexpr int CU = (D + 31) / 32;     // columns a lane accumulates per head
    const int j = lane % KW, h0 = lane / KW;
    float* pw = scratch + warp * kMaxQpk * (KW + 1);  // [kMaxQpk][KW] p, then [kMaxQpk] rescale
    float* aw = pw + kMaxQpk * KW;
    float acc[kMaxQpk][CU];
#pragma unroll
    for (int g = 0; g < kMaxQpk; ++g)
#pragma unroll
      for (int u = 0; u < CU; ++u) acc[g][u] = 0.f;
    float m_i[NH], l_i[NH];
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      m_i[i] = kNegInf;
      l_i[i] = 0.f;
    }

    for (int t = 0; t < nt; ++t) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (t + kStages - 1 < nt) load_tile(t + kStages - 1);
      cp_async_commit();
      const T* kt = stage(t) + KW * warp * RS;
      const T* vt = kt + KT * RS;
      const int kw0 = k_lo + t * KT + KW * warp;
      if (kw0 >= k_hi) continue;

      float s[NH];
#pragma unroll
      for (int i = 0; i < NH; ++i) s[i] = 0.f;
#pragma unroll 4
      for (int c = 0; c < D; c += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(kt + j * RS + c);
#pragma unroll
        for (int i = 0; i < NH; ++i) {
          if (h0 + HS * i < qpk) {
            const float4 qv = *reinterpret_cast<const float4*>(qs + (h0 + HS * i) * RS + c);
            s[i] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
          }
        }
      }
      const bool valid = kw0 + j < k_hi;
#pragma unroll
      for (int i = 0; i < NH; ++i) {
        const float x = valid ? s[i] * scale_log2 : kNegInf;
        float mx = x;
#pragma unroll
        for (int off = 1; off < KW; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_i[i], mx);
        const float m_use = m_new == kNegInf ? 0.f : m_new;
        const float alpha = exp2f(m_i[i] - m_use);
        const float p = exp2f(x - m_use);
        float sum = p;
#pragma unroll
        for (int off = 1; off < KW; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        l_i[i] = alpha * l_i[i] + sum;
        m_i[i] = m_new;
        pw[(h0 + HS * i) * KW + j] = p;
        if (j == 0) aw[h0 + HS * i] = alpha;
      }
      __syncwarp();
#pragma unroll
      for (int g = 0; g < kMaxQpk; ++g) {
        if (g < qpk) {
          const float alpha = aw[g];
#pragma unroll
          for (int u = 0; u < CU; ++u) acc[g][u] *= alpha;
        }
      }
#pragma unroll
      for (int jj = 0; jj < KW; ++jj) {
        float vv[CU];
#pragma unroll
        for (int u = 0; u < CU; ++u) vv[u] = lane + 32 * u < D ? vt[jj * RS + lane + 32 * u] : 0.f;
#pragma unroll
        for (int g = 0; g < kMaxQpk; ++g) {
          if (g < qpk) {
            const float p = pw[g * KW + jj];
#pragma unroll
            for (int u = 0; u < CU; ++u) acc[g][u] += p * vv[u];
          }
        }
      }
      __syncwarp();  // pw and aw are read before the next tile writes them
    }
    cp_async_wait<0>();
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int i = 0; i < NH; ++i) {
        part_m[warp * kMaxQpk + h0 + HS * i] = m_i[i];
        part_l[warp * kMaxQpk + h0 + HS * i] = l_i[i];
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxQpk; ++g)
#pragma unroll
      for (int u = 0; u < CU; ++u)
        if (lane + 32 * u < D) part_acc[(warp * kMaxQpk + g) * D + lane + 32 * u] = acc[g][u];
  }
  __syncthreads();

  // merge the warps: blk = sum_w part_w * 2^(m_w - M), M = max_w m_w (a warp
  // that saw no key has m = kNegInf, l = 0, acc = 0 and adds nothing)
  if (tid < qpk) {
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, part_m[w * kMaxQpk + tid]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = exp2f(part_m[w * kMaxQpk + tid] - M);
      wgt[w * kMaxQpk + tid] = c;
      L += c * part_l[w * kMaxQpk + tid];
    }
    blk_m[tid] = M;
    blk_l[tid] = L;
  }
  __syncthreads();
  for (int idx = tid; idx < qpk * D; idx += kThreads) {
    const int g = idx / D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += wgt[w * kMaxQpk + g] * part_acc[w * kMaxQpk * D + idx];
    blk_acc[idx] = a;
  }

  // merge the cluster: rank 0 reads every block's (blk_m, blk_l, blk_acc)
  cluster.sync();
  if (rank == 0) {
    if (tid < qpk) {
      float M = kNegInf;
      for (int r = 0; r < splits; ++r) M = fmaxf(M, cluster.map_shared_rank(blk_m, r)[tid]);
      float L = 0.f;
      for (int r = 0; r < splits; ++r) {
        const float c = exp2f(cluster.map_shared_rank(blk_m, r)[tid] - M);
        wgt[r * kMaxQpk + tid] = c;
        L += c * cluster.map_shared_rank(blk_l, r)[tid];
      }
      const float inv = 1.f / fmaxf(L, 1e-30f);
      for (int r = 0; r < splits; ++r) wgt[r * kMaxQpk + tid] *= inv;
    }
    __syncthreads();
    T* ob = out + b * o_sb + h * o_sh;
    for (int idx = tid; idx < qpk * D; idx += kThreads) {
      const int g = idx / D, c = idx % D;
      float a = 0.f;
      for (int r = 0; r < splits; ++r)
        a += wgt[r * kMaxQpk + g] * cluster.map_shared_rank(blk_acc, r)[idx];
      store(ob + g * o_sg + c, a);
    }
  }
  cluster.sync();  // the other blocks stay resident until rank 0 has read them
}

template <typename T, int D, bool Q8>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* out,
           int B, int Hkv, int qpk, int S, int splits, const long long* st, const Scales& sc,
           cudaStream_t stream) {
  using KV = std::conditional_t<Q8, int8_t, T>;
  auto kernel = decode_kernel<T, D, Q8>;
  constexpr size_t smem = smem_bytes<T, D, Q8>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;  // the splits of one (sequence, kv head)
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q), static_cast<const KV*>(k),
                           static_cast<const KV*>(v), lengths, static_cast<T*>(out), qpk, S,
                           st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
                           st[10], st[11],
                           1.4426950408889634f / sqrtf(static_cast<float>(D)), sc);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, bool Q8>
int dispatch(int d, const void* q, const void* k, const void* v, const int* lengths, void* out,
             int B, int Hkv, int qpk, int S, int splits, const long long* st, const Scales& sc,
             cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32, Q8>(q, k, v, lengths, out, B, Hkv, qpk, S, splits, st, sc, stream);
    case 64: return launch<T, 64, Q8>(q, k, v, lengths, out, B, Hkv, qpk, S, splits, st, sc, stream);
    case 80: return launch<T, 80, Q8>(q, k, v, lengths, out, B, Hkv, qpk, S, splits, st, sc, stream);
    case 128:
      return launch<T, 128, Q8>(q, k, v, lengths, out, B, Hkv, qpk, S, splits, st, sc, stream);
    case 192:
      return launch<T, 192, Q8>(q, k, v, lengths, out, B, Hkv, qpk, S, splits, st, sc, stream);
    default: return kUnsupported;
  }
}

template <bool Q8>
int run(const void* q, const void* k, const void* v, const void* lengths, void* out, int B,
        int Hkv, int qpk, int S, int d, int dtype, int splits, const long long* st,
        const Scales& sc, int device, void* stream) {
  if (qpk < 1 || qpk > kMaxQpk) return kUnsupported;
  if (splits != 1 && splits != 2 && splits != 4 && splits != kMaxSplits) return kUnsupported;
  if (B == 0 || Hkv == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int* len = static_cast<const int*>(lengths);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return dispatch<float, Q8>(d, q, k, v, len, out, B, Hkv, qpk, S, splits, st, sc, s);
    case kBF16:
      return dispatch<__nv_bfloat16, Q8>(d, q, k, v, len, out, B, Hkv, qpk, S, splits, st, sc,
                                         s);
    default: return kUnsupported;
  }
}

}  // namespace
}  // namespace ham

// q (B, Hkv, qpk, d), k/v (B, Hkv, S, d), out (B, Hkv, qpk, d): element
// strides of the three outer dims (the last dim is contiguous); lengths (B,)
// int32 on the device; splits in {1, 2, 4, 8} blocks (one cluster) per
// (sequence, kv head).  Returns 0 or the launch error.
extern "C" int ham_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths, void* out,
    int B, int Hkv, int qpk, int S, int d, int dtype, int splits,
    long long q_sb, long long q_sh, long long q_sg,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_sg,
    int device, void* stream) {
  const long long st[12] = {q_sb, q_sh, q_sg, k_sb, k_sh, k_ss,
                            v_sb, v_sh, v_ss, o_sb, o_sh, o_sg};
  return ham::run<false>(q, k, v, lengths, out, B, Hkv, qpk, S, d, dtype, splits, st,
                         ham::Scales{}, device, stream);
}

// The int8 variant: k/v int8 (B, Hkv, S, d) as above; k_scale/v_scale
// float32 (B, Hkv, S, 1), element strides of their three outer dims; q and
// out float32 or bf16 (dtype), K/V dequantized to that type.
extern "C" int ham_decode_attention_q8(
    const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
    const void* lengths, void* out,
    int B, int Hkv, int qpk, int S, int d, int dtype, int splits,
    long long q_sb, long long q_sh, long long q_sg,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_sg,
    long long ks_sb, long long ks_sh, long long ks_ss,
    long long vs_sb, long long vs_sh, long long vs_ss,
    int device, void* stream) {
  const long long st[12] = {q_sb, q_sh, q_sg, k_sb, k_sh, k_ss,
                            v_sb, v_sh, v_ss, o_sb, o_sh, o_sg};
  const ham::Scales sc{static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                       ks_sb, ks_sh, ks_ss, vs_sb, vs_sh, vs_ss};
  return ham::run<true>(q, k, v, lengths, out, B, Hkv, qpk, S, d, dtype, splits, st, sc,
                        device, stream);
}
