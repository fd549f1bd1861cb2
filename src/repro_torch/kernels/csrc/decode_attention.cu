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
//    and after a cluster barrier each block reads every block's (max, sum)
//    and the accumulator elements of its share of the rows through
//    distributed shared memory, rescales, sums and writes
//    acc / max(sum, 1e-30); a second barrier keeps every block resident
//    until the others have read it.  No scratch in device memory, one
//    launch.
//
// The int8 variant (ham_decode_attention_q8) reads the reference's kv_quant
// cache (repro/models/layers.py:269-301): int8 K/V with one float32 scale
// per (sequence, position, kv head) vector.  Its bound is bytes too, half
// the bf16 cache's plus the scales (at the serving shape 33.6 MB + 1.0 MB,
// 10.3 us).  Its bf16 route (decode_q8_bf16) keeps the split, cluster merge
// and mma.sync body and never widens a tile in shared memory:
//  * int8 rows (16 a cp.async) and their scales arrive in a 2-stage ring of
//    256 keys (the bytes of 128 bf16 keys), 32 for each of 8 warps: with
//    one block an SM at the serving shape, two warps on each sub-partition
//    hide each other's latencies.  Each lane reads its bytes of K and V
//    from the ring as int8 and turns them into bf16 B fragments in
//    registers, right before the mma: x ^ 0x80 biases a byte to 0..255, __byte_perm puts it
//    under the exponent of 2^23, and subtracting 2^23 + 128 gives x as an
//    exact float, whose high half is x as an exact bf16 (|x| <= 128);
//  * the fragments' element order is chosen so that each lane reads
//    contiguous bytes: in Q K^T lane (g, c) takes key g's bytes
//    [c D/4, (c + 1) D/4), one 4-byte word an mma, and q's A fragments are
//    read in the same permutation of d (d is contracted, so it cancels); in
//    P V lane (g, c) takes bytes [g D/8, (g + 1) D/8) of keys 2c, 2c + 1,
//    2c + 8, 2c + 9, byte t feeding output tile t, so output column n of
//    tile t is d = n D/8 + t, undone where the partials are written;
//  * the scales leave the inner loop: k_scale belongs to a key, so it
//    multiplies that key's score column after Q K^T (with scale_log2), and
//    v_scale multiplies p before p is rounded into P V's A fragment; the
//    softmax sums take p unscaled.  This rounds once less than the
//    reference (bf16(x) * bf16(scale) rounded); the scales are rounded to
//    bf16 first, as the reference rounds them.
// The float32 route (decode_kernel<float, D, true>) widens each warp's rows
// of a stage into a float tile in shared memory, k = x * scale as the
// reference dequantizes, before the unchanged CUDA-core body consumes them.
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
// The merge buffers' offsets (floats) in the pool: part_acc [W][kMaxQpk]
// rows of D + Pad, part_m and part_l [W][kMaxQpk] (of W warps), blk_acc
// [kMaxQpk][D], blk_m, blk_l, and the merge weights
template <int D, int W = kWarps, int Pad = 0>
struct MergeLayout {
  static constexpr int kRow = D + Pad;
  static constexpr int kM = W * kMaxQpk * kRow;
  static constexpr int kL = kM + W * kMaxQpk;
  static constexpr int kBlk = kL + W * kMaxQpk;
  static constexpr int kBlkM = kBlk + kMaxQpk * D;
  static constexpr int kBlkL = kBlkM + kMaxQpk;
  static constexpr int kWgt = kBlkL + kMaxQpk;
  static constexpr int kEnd = kWgt + (W > kMaxSplits ? W : kMaxSplits) * kMaxQpk;
};
template <int D, int W = kWarps, int Pad = 0>
__host__ __device__ constexpr size_t merge_bytes() {
  return sizeof(float) * MergeLayout<D, W, Pad>::kEnd;
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

// the reference's dequantization into float32: x * scale, rounded once
__device__ __forceinline__ float dequant(int8_t x, float s) { return x * s; }

// This block's range [k_lo, k_hi) of the valid keys: the cache of one
// (sequence, kv head) split into as many ranges as the cluster has blocks,
// each a multiple of kAlign keys (an empty range has k_lo == k_hi)
__device__ __forceinline__ void key_range(int length, int S, int& k_lo, int& k_hi) {
  const int splits = gridDim.x, rank = static_cast<int>(cg::this_cluster().block_rank());
  const int len = min(max(length, 0), S);
  const int chunk = ((len + splits - 1) / splits + kAlign - 1) / kAlign * kAlign;
  k_lo = min(len, rank * chunk);
  k_hi = min(len, k_lo + chunk);
}

// Each of the block's W warps has left its (max, sum, accumulator) of each
// row in pool's part_m, part_l and part_acc ([W][kMaxQpk](D)) and the
// block has synchronised: merge the warps, then the cluster's blocks
// through distributed shared memory; each block writes its share of the
// rows' elements of ob (rank 0 alone would read splits times as many
// remote elements before the launch could end), rank 0 the lse.  With
// kTiles, a row's accumulator is stored tile-major, the mma tile's column
// first: position 8 n + col holds d = col kTiles + n (what
// decode_q8_bf16's P V tiles make), in rows padded by 8 floats; 0:
// position d holds d, rows unpadded.  Only rows < qpk are read.
template <typename T, int D, int W = kWarps, int kTiles = 0>
__device__ void merge_store(float* pool, int qpk, int b, int h, T* __restrict__ ob,
                            int64_t o_sg, float* __restrict__ lse) {
  using Lay = MergeLayout<D, W, kTiles ? 8 : 0>;
  constexpr int kN = 32 * W;   // threads of the block
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = gridDim.x, rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  float* part_acc = pool;                            // [W][kMaxQpk][Lay::kRow]
  float* part_m = pool + Lay::kM;                    // [W][kMaxQpk]
  float* part_l = pool + Lay::kL;
  float* blk_acc = pool + Lay::kBlk;                 // [kMaxQpk][D]: what the others read
  float* blk_m = pool + Lay::kBlkM;
  float* blk_l = pool + Lay::kBlkL;
  float* wgt = pool + Lay::kWgt;                     // [max(W, kMaxSplits)][kMaxQpk]
  // merge the warps: blk = sum_w part_w * 2^(m_w - M), M = max_w m_w (a warp
  // that saw no key has m = kNegInf, l = 0, acc = 0 and adds nothing)
  if (tid < qpk) {
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < W; ++w) M = fmaxf(M, part_m[w * kMaxQpk + tid]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float c = exp2f(part_m[w * kMaxQpk + tid] - M);
      wgt[w * kMaxQpk + tid] = c;
      L += c * part_l[w * kMaxQpk + tid];
    }
    blk_m[tid] = M;
    blk_l[tid] = L;
  }
  __syncthreads();
  for (int idx = tid; idx < qpk * D; idx += kN) {
    const int g = idx / D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w)
      a += wgt[w * kMaxQpk + g] * part_acc[(w * kMaxQpk + g) * Lay::kRow + idx % D];
    blk_acc[idx] = a;
  }

  // merge the cluster: each block reads every block's (blk_m, blk_l) and
  // the blk_acc elements of its share
  cluster.sync();
  if (tid < qpk) {
    // each remote read issued before any is used (they are independent)
    float mr[kMaxSplits], lr[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      mr[r] = r < splits ? cluster.map_shared_rank(blk_m, r)[tid] : kNegInf;
      lr[r] = r < splits ? cluster.map_shared_rank(blk_l, r)[tid] : 0.f;
    }
    float M = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) M = fmaxf(M, mr[r]);
    float L = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      const float c = exp2f(mr[r] - M);
      if (r < splits) wgt[r * kMaxQpk + tid] = c;
      L += c * lr[r];
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
    for (int r = 0; r < splits; ++r) wgt[r * kMaxQpk + tid] *= inv;
    // the row's log-sum-exp in natural log (scores are in log2 units):
    // what the shards of a sequence-sharded cache are merged by
    if (lse && rank == 0) lse[(static_cast<int64_t>(b) * gridDim.y + h) * qpk + tid] =
        (M + log2f(L)) * 0.6931471805599453f;
  }
  __syncthreads();
  const int per = (qpk * D + splits - 1) / splits;
  const int lo = rank * per, hi = min(qpk * D, lo + per);
  for (int idx = lo + tid; idx < hi; idx += kN) {
    const int g = idx / D, c = idx % D;
    float x[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      x[r] = r < splits ? cluster.map_shared_rank(blk_acc, r)[idx] : 0.f;
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < splits) a += wgt[r * kMaxQpk + g] * x[r];
    store(ob + g * o_sg + (kTiles ? c % 8 * kTiles + c / 8 : c), a);
  }
  cluster.sync();  // every block stays resident until the others have read it
}

template <typename T, int D, bool Q8>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const std::conditional_t<Q8, int8_t, T>* __restrict__ k,
              const std::conditional_t<Q8, int8_t, T>* __restrict__ v,
              const int* __restrict__ lengths, T* __restrict__ out, int qpk, int S,
              int64_t q_sb, int64_t q_sh, int64_t q_sg,
              int64_t k_sb, int64_t k_sh, int64_t k_ss,
              int64_t v_sb, int64_t v_sh, int64_t v_ss,
              int64_t o_sb, int64_t o_sh, int64_t o_sg, float scale_log2, Scales sc,
              float* __restrict__ lse) {
  using KV = std::conditional_t<Q8, int8_t, T>;
  constexpr bool kBF16 = std::is_same_v<T, __nv_bfloat16>;
  constexpr int KT = tile_keys<T>();          // keys a stage
  constexpr int KW = KT / kWarps;             // keys a warp takes of each stage
  constexpr int RS = row_elems<T, D>();       // tile row (elements)
  constexpr int VN = 16 / sizeof(T);          // elements of a 16-byte vector
  constexpr int CH = D / VN;                  // 16-byte vectors a row
  constexpr int R8 = row8<D>();               // int8 tile row (bytes)
  static_assert(D % 16 == 0, "head_dim");
  static_assert(!Q8 || std::is_same_v<T, float>, "a bf16 int8 decode is decode_q8_bf16");

  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);        // [kMaxQpk][RS]; rows >= qpk zero
  T* ring = qs + kMaxQpk * RS;                // [kStages][K, V][KT][RS]
  // int8 variant: [kStages][K, V][KT][R8] bytes, then [kStages][K, V][KT]
  // scales, then the widened [K, V][KT][RS] tile the body reads
  int8_t* ring8 = reinterpret_cast<int8_t*>(ring);
  float* scl = reinterpret_cast<float*>(ring8 + kStages * 2 * KT * R8);
  T* wide = reinterpret_cast<T*>(scl + kStages * 2 * KT);
  // after the key loop the ring holds the merge buffers
  float* pool = reinterpret_cast<float*>(ring);
  float* part_acc = pool;                            // [kWarps][kMaxQpk][D]
  float* part_m = part_acc + kWarps * kMaxQpk * D;   // [kWarps][kMaxQpk]
  float* part_l = part_m + kWarps * kMaxQpk;
  float* scratch =
      reinterpret_cast<float*>(reinterpret_cast<char*>(ring) + pool_bytes<T, D, Q8>());

  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int k_lo, k_hi;
  key_range(lengths[b], S, k_lo, k_hi);
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
        alignas(16) int8_t x[VN];   // VN = 4 int8 values
        *reinterpret_cast<unsigned*>(x) = *reinterpret_cast<const unsigned*>(src + r * R8 + c);
        alignas(16) T y[VN];
#pragma unroll
        for (int e = 0; e < VN; ++e) y[e] = dequant(x[e], s);
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
  merge_store<T, D>(pool, qpk, b, h, out + b * o_sb + h * o_sh, o_sg, lse);
}

// ---- the int8 cache on the tensor cores: the bf16 route of the int8 variant
constexpr int kWarps8 = 8;    // warps a block: two on each SM sub-partition
constexpr int kThreads8 = 32 * kWarps8;
constexpr int kKeys8 = 256;   // keys a ring stage holds (32 a warp)
constexpr int kStages8 = 2;   // its ring depth: one stage loads while one is consumed

// the int8 ring: [kStages8][K, V][kKeys8][row8] bytes, then [kStages8][K,
// V][kKeys8] float32 scales
template <int D>
__host__ __device__ constexpr size_t ring8_bytes() {
  return kStages8 * 2 * kKeys8 * (row8<D>() + sizeof(float));
}
template <int D>
__host__ __device__ constexpr size_t smem8_bytes() {
  return sizeof(__nv_bfloat16) * kMaxQpk * row_elems<__nv_bfloat16, D>() +
         (ring8_bytes<D>() > merge_bytes<D, kWarps8, 8>() ? ring8_bytes<D>()
                                                           : merge_bytes<D, kWarps8, 8>());
}

// NB bytes at p into words (the widest loads p's alignment, a divisor of NB
// up to 16, allows; NB even)
template <int NB>
__device__ __forceinline__ void load_bytes(const int8_t* p, unsigned (&w)[(NB + 3) / 4]) {
  if constexpr (NB % 16 == 0) {
#pragma unroll
    for (int i = 0; i < NB / 16; ++i) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = x.x, w[4 * i + 1] = x.y, w[4 * i + 2] = x.z, w[4 * i + 3] = x.w;
    }
  } else if constexpr (NB % 8 == 0) {
#pragma unroll
    for (int i = 0; i < NB / 8; ++i) {
      const uint2 x = reinterpret_cast<const uint2*>(p)[i];
      w[2 * i] = x.x, w[2 * i + 1] = x.y;
    }
  } else if constexpr (NB % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NB / 4; ++i) w[i] = reinterpret_cast<const unsigned*>(p)[i];
  } else {
    static_assert(NB % 2 == 0, "an even number of bytes");
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) {
      const unsigned x = reinterpret_cast<const unsigned short*>(p)[i];
      w[i / 2] = i % 2 ? w[i / 2] | x << 16 : x;
    }
  }
}

// byte `sel` of u, an int8 value biased by x ^ 0x80, as an exact float:
// 2^23 + (x + 128) laid out under the float's exponent, less 2^23 + 128
__device__ __forceinline__ float i8_float(unsigned u, unsigned sel) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u | sel)) - 8388736.f;
}
// two floats that are bf16 values (integers of at most 8 bits) as one bf16x2
// register, lo in the low half: their high halves, exactly
__device__ __forceinline__ unsigned pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}
// a scale rounded to bf16, as the reference rounds it before multiplying
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int D>
__global__ void __launch_bounds__(kThreads8)
decode_q8_bf16(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k,
               const int8_t* __restrict__ v, const int* __restrict__ lengths,
               __nv_bfloat16* __restrict__ out, int qpk, int S,
               int64_t q_sb, int64_t q_sh, int64_t q_sg,
               int64_t k_sb, int64_t k_sh, int64_t k_ss,
               int64_t v_sb, int64_t v_sh, int64_t v_ss,
               int64_t o_sb, int64_t o_sh, int64_t o_sg, float scale_log2, Scales sc,
               float* __restrict__ lse) {
  using T = __nv_bfloat16;
  constexpr int KT = kKeys8;              // keys a stage
  constexpr int KW = KT / kWarps8;        // keys a warp takes of each stage
  constexpr int RS = row_elems<T, D>();   // q row (elements)
  constexpr int CH = D / 8;               // 16-byte vectors of a q row
  constexpr int R8 = row8<D>();           // int8 row (bytes)
  constexpr int CK = D / 4;               // bytes of a K row a lane converts
  constexpr int CV = D / 8;               // bytes of a V row a lane converts = P V's tiles
  static_assert(D % 16 == 0 && KW % 16 == 0, "head_dim, keys a warp");

  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);    // [kMaxQpk][RS]; rows >= qpk zero
  int8_t* ring = reinterpret_cast<int8_t*>(qs + kMaxQpk * RS);
  float* scl = reinterpret_cast<float*>(ring + kStages8 * 2 * KT * R8);
  using Lay = MergeLayout<D, kWarps8, 8>;         // merge_store's, tile-major rows
  float* pool = reinterpret_cast<float*>(ring);   // the merge buffers, after the key loop
  float* part_m = pool + Lay::kM;
  float* part_l = pool + Lay::kL;

  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, c = lane % 4;   // the lane's row and column quad of a fragment
  int k_lo, k_hi;
  key_range(lengths[b], S, k_lo, k_hi);
  const int nt = (k_hi - k_lo + KT - 1) / KT;
  const int8_t* kb = k + b * k_sb + h * k_sh;
  const int8_t* vb = v + b * v_sb + h * v_sh;
  const float* kscale = sc.k + b * sc.k_sb + h * sc.k_sh;
  const float* vscale = sc.v + b * sc.v_sb + h * sc.v_sh;

  const T* qb = q + b * q_sb + h * q_sh;
  for (int idx = tid; idx < kMaxQpk * CH; idx += kThreads8) {
    const int r = idx / CH, col = (idx % CH) * 8;
    cp_async16(qs + r * RS + col, r < qpk ? qb + r * q_sg + col : qb, r < qpk ? 16 : 0);
  }
  // key tile i -> stage i % kStages8; keys at or past k_hi are zero-filled
  // (int8 0 and scale 0)
  const auto load_tile = [&](int i) {
    const int key0 = k_lo + i * KT;
    int8_t* ks = ring + (i % kStages8) * 2 * KT * R8;
    int8_t* vs = ks + KT * R8;
    for (int idx = tid; idx < KT * (D / 16); idx += kThreads8) {
      const int r = idx / (D / 16), col = (idx % (D / 16)) * 16;
      const bool ok = key0 + r < k_hi;
      cp_async16(ks + r * R8 + col, ok ? kb + (key0 + r) * k_ss + col : kb, ok ? 16 : 0);
      cp_async16(vs + r * R8 + col, ok ? vb + (key0 + r) * v_ss + col : vb, ok ? 16 : 0);
    }
    float* ss = scl + (i % kStages8) * 2 * KT;   // [K, V][KT]
    for (int r = tid; r < 2 * KT; r += kThreads8) {
      const int key = key0 + r % KT;
      const bool ok = key < k_hi;
      const float* src = r < KT ? kscale + key * sc.k_ss : vscale + key * sc.v_ss;
      cp_async4(ss + r, ok ? src : kscale, ok ? 4 : 0);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages8 - 1; ++i) {
    if (i < nt) load_tile(i);
    cp_async_commit();
  }

  unsigned qf[D / 16][4];   // q's A fragments, d permuted as the K fragments
  float acc[CV][4];         // tile n, column col: d = col CV + n
#pragma unroll
  for (int t = 0; t < CV; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};   // rows g, g + 8

  for (int t = 0; t < nt; ++t) {
    cp_async_wait<kStages8 - 2>();   // tile t (and q) have landed ...
    __syncthreads();                 // ... for every thread, and tile t - 1 is consumed
    if (t == 0) {
      // mma kk's k-slots (2c, 2c + 1 | 2c + 8, 2c + 9) are d = c CK + 4 kk + (0, 1 | 2, 3)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint2 lo = *reinterpret_cast<const uint2*>(qs + g * RS + c * CK + 4 * kk);
        const uint2 hi = *reinterpret_cast<const uint2*>(qs + (g + 8) * RS + c * CK + 4 * kk);
        qf[kk][0] = lo.x, qf[kk][1] = hi.x, qf[kk][2] = lo.y, qf[kk][3] = hi.y;
      }
    }
    if (t + kStages8 - 1 < nt) load_tile(t + kStages8 - 1);
    cp_async_commit();
    const int8_t* kt = ring + (t % kStages8) * 2 * KT * R8 + KW * warp * R8;   // this warp's keys
    const int8_t* vt = kt + KT * R8;
    const float* kst = scl + (t % kStages8) * 2 * KT + KW * warp;
    const float* vst = kst + KT;
    const int kw0 = k_lo + t * KT + KW * warp;
    if (kw0 >= k_hi) continue;   // warp-uniform: none of this warp's keys is valid

    // scores of the warp's KW keys, 8 a tile j: element (j, e) is key
    // kw0 + 8 j + 2 c + e % 2, row g + 8 (e / 2)
    float s[KW / 8][4];
#pragma unroll
    for (int j = 0; j < KW / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      unsigned w[CK / 4];
      load_bytes<CK>(kt + (8 * j + g) * R8 + c * CK, w);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const unsigned u = w[kk] ^ 0x80808080u;
        mma_bf16(s[j], qf[kk], pack_exact(i8_float(u, 0), i8_float(u, 1)),
                 pack_exact(i8_float(u, 2), i8_float(u, 3)));
      }
    }
    const bool tail = kw0 + KW > k_hi;
#pragma unroll
    for (int j = 0; j < KW / 8; ++j) {
      const float2 ks2 = *reinterpret_cast<const float2*>(kst + 8 * j + 2 * c);
      const float f[2] = {bf16_round(ks2.x) * scale_log2, bf16_round(ks2.y) * scale_log2};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= f[e & 1];
        if (tail && kw0 + 8 * j + 2 * c + (e & 1) >= k_hi) s[j][e] = kNegInf;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < KW / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[hh], mx);
      const float m_use = m_new == kNegInf ? 0.f : m_new;
      const float alpha = exp2f(m_i[hh] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KW / 8; ++j)
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
      for (int j = 0; j < CV; ++j) {
        acc[j][2 * hh] *= alpha;
        acc[j][2 * hh + 1] *= alpha;
      }
    }
    // P V, 16 keys an mma: p v_scale rounded into the A fragment (k-slot
    // 2c + e | 2c + 8 + e is key 16 u + 2c + e | 16 u + 8 + 2c + e)
#pragma unroll
    for (int u = 0; u < KW / 16; ++u) {
      const float2 v0 = *reinterpret_cast<const float2*>(vst + 16 * u + 2 * c);
      const float2 v1 = *reinterpret_cast<const float2*>(vst + 16 * u + 8 + 2 * c);
      const float f0 = bf16_round(v0.x), f1 = bf16_round(v0.y);
      const float f2 = bf16_round(v1.x), f3 = bf16_round(v1.y);
      const float(&s0)[4] = s[2 * u];
      const float(&s1)[4] = s[2 * u + 1];
      const unsigned a[4] = {pack_bf16(s0[0] * f0, s0[1] * f1), pack_bf16(s0[2] * f0, s0[3] * f1),
                             pack_bf16(s1[0] * f2, s1[1] * f3), pack_bf16(s1[2] * f2, s1[3] * f3)};
      // keys 2c, 2c + 1, 2c + 8, 2c + 9 of the 16, bytes [g CV, (g + 1) CV)
      unsigned r[4][(CV + 3) / 4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        load_bytes<CV>(vt + (16 * u + 2 * c + (i & 1) + 8 * (i >> 1)) * R8 + g * CV, r[i]);
#pragma unroll
        for (int x = 0; x < (CV + 3) / 4; ++x) r[i][x] ^= 0x80808080u;
      }
#pragma unroll
      for (int n = 0; n < CV; ++n) {
        const int x = n / 4;
        const unsigned sel = n % 4;
        mma_bf16(acc[n], a, pack_exact(i8_float(r[0][x], sel), i8_float(r[1][x], sel)),
                 pack_exact(i8_float(r[2][x], sel), i8_float(r[3][x], sel)));
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the ring, which now takes the partials
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = g + 8 * hh;
    if (row >= qpk) continue;   // padding rows: the merge reads rows < qpk
    if (c == 0) {
      part_m[warp * kMaxQpk + row] = m_i[hh];
      part_l[warp * kMaxQpk + row] = l_i[hh];
    }
    // tile-major (merge_store's kTiles): a lane's two columns of a tile are
    // adjacent, one 8-byte store, and the 8-float row padding puts the
    // rows of a store on different banks (a d-major unpadded row would put
    // all 32 lanes of a store on one bank)
    float* pa = pool + (warp * kMaxQpk + row) * Lay::kRow + 2 * c;
#pragma unroll
    for (int n = 0; n < CV; ++n)
      *reinterpret_cast<float2*>(pa + 8 * n) = make_float2(acc[n][2 * hh], acc[n][2 * hh + 1]);
  }
  __syncthreads();
  merge_store<T, D, kWarps8, CV>(pool, qpk, b, h, out + b * o_sb + h * o_sh, o_sg, lse);
}

template <typename T, int D, bool Q8>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* out,
           int B, int Hkv, int qpk, int S, int splits, const long long* st, const Scales& sc,
           float* lse, cudaStream_t stream) {
  using KV = std::conditional_t<Q8, int8_t, T>;
  // the int8 cache in bf16 takes the tensor-core route that never widens a tile
  constexpr bool kQ8TC = Q8 && std::is_same_v<T, __nv_bfloat16>;
  constexpr auto kernel = [] {
    if constexpr (kQ8TC) return decode_q8_bf16<D>;
    else return decode_kernel<T, D, Q8>;
  }();
  constexpr size_t smem = kQ8TC ? smem8_bytes<D>() : smem_bytes<T, D, Q8>();
  cudaError_t err = allow_smem_once<kernel>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, Hkv, B);
  cfg.blockDim = dim3(kQ8TC ? kThreads8 : kThreads);
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
                           1.4426950408889634f / sqrtf(static_cast<float>(D)), sc, lse);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the launch's dynamic shared memory and the blocks of it an SM holds
template <typename T, int D, bool Q8>
int resources(int* smem, int* blocks) {
  constexpr bool kQ8TC = Q8 && std::is_same_v<T, __nv_bfloat16>;
  constexpr auto kernel = [] {
    if constexpr (kQ8TC) return decode_q8_bf16<D>;
    else return decode_kernel<T, D, Q8>;
  }();
  *smem = static_cast<int>(kQ8TC ? smem8_bytes<D>() : smem_bytes<T, D, Q8>());
  cudaError_t err = allow_smem_once<kernel>(*smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                       kQ8TC ? kThreads8 : kThreads, *smem);
}

template <typename T, bool Q8>
int dispatch(int d, const void* q, const void* k, const void* v, const int* lengths, void* out,
             int B, int Hkv, int qpk, int S, int splits, const long long* st, const Scales& sc,
             float* lse, cudaStream_t stream) {
#define HAM_DECODE_CASE(D_) \
  case D_:                 \
    return launch<T, D_, Q8>(q, k, v, lengths, out, B, Hkv, qpk, S, splits, st, sc, lse, stream);
  switch (d) {
    HAM_DECODE_CASE(32)
    HAM_DECODE_CASE(64)
    HAM_DECODE_CASE(80)
    HAM_DECODE_CASE(128)
    HAM_DECODE_CASE(192)
    default: return kUnsupported;
  }
#undef HAM_DECODE_CASE
}

template <bool Q8>
int run(const void* q, const void* k, const void* v, const void* lengths, void* out, int B,
        int Hkv, int qpk, int S, int d, int dtype, int splits, const long long* st,
        const Scales& sc, void* lse, int device, void* stream) {
  if (qpk < 1 || qpk > kMaxQpk) return kUnsupported;
  if (splits != 1 && splits != 2 && splits != 4 && splits != kMaxSplits) return kUnsupported;
  if (B == 0 || Hkv == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int* len = static_cast<const int*>(lengths);
  auto s = static_cast<cudaStream_t>(stream);
  auto ls = static_cast<float*>(lse);
  switch (dtype) {
    case kF32:
      return dispatch<float, Q8>(d, q, k, v, len, out, B, Hkv, qpk, S, splits, st, sc, ls, s);
    case kBF16:
      return dispatch<__nv_bfloat16, Q8>(d, q, k, v, len, out, B, Hkv, qpk, S, splits, st, sc,
                                         ls, s);
    default: return kUnsupported;
  }
}

}  // namespace
}  // namespace ham

// q (B, Hkv, qpk, d), k/v (B, Hkv, S, d), out (B, Hkv, qpk, d): element
// strides of the three outer dims (the last dim is contiguous); lengths (B,)
// int32 on the device; splits in {1, 2, 4, 8} blocks (one cluster) per
// (sequence, kv head); lse null, or float32 (B, Hkv, qpk) contiguous for
// each row's log-sum-exp.  Returns 0 or the launch error.
extern "C" int ham_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths, void* out,
    int B, int Hkv, int qpk, int S, int d, int dtype, int splits,
    long long q_sb, long long q_sh, long long q_sg,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_sg,
    void* lse, int device, void* stream) {
  const long long st[12] = {q_sb, q_sh, q_sg, k_sb, k_sh, k_ss,
                            v_sb, v_sh, v_ss, o_sb, o_sh, o_sg};
  return ham::run<false>(q, k, v, lengths, out, B, Hkv, qpk, S, d, dtype, splits, st,
                         ham::Scales{}, lse, device, stream);
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
    void* lse, int device, void* stream) {
  const long long st[12] = {q_sb, q_sh, q_sg, k_sb, k_sh, k_ss,
                            v_sb, v_sh, v_ss, o_sb, o_sh, o_sg};
  const ham::Scales sc{static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                       ks_sb, ks_sh, ks_ss, vs_sb, vs_sh, vs_ss};
  return ham::run<true>(q, k, v, lengths, out, B, Hkv, qpk, S, d, dtype, splits, st, sc,
                        lse, device, stream);
}

// The int8 variant's resources at head_dim d and dtype on `device`: dynamic
// shared memory a block (bytes) and blocks an SM holds.  Returns 0 or the
// error.
extern "C" int ham_decode_attention_q8_resources(int d, int dtype, int* smem, int* blocks,
                                                 int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
#define HAM_DECODE_CASE(D_)                                                   \
  case D_:                                                                     \
    return dtype == ham::kBF16 ? ham::resources<__nv_bfloat16, D_, true>(smem, blocks) \
                               : ham::resources<float, D_, true>(smem, blocks);
  switch (d) {
    HAM_DECODE_CASE(32)
    HAM_DECODE_CASE(64)
    HAM_DECODE_CASE(80)
    HAM_DECODE_CASE(128)
    HAM_DECODE_CASE(192)
    default: return ham::kUnsupported;
  }
#undef HAM_DECODE_CASE
}
