"""The design of the int8-cache decode kernel's bf16 route
(``decode_q8_bf16`` in ``repro_torch/kernels/csrc/decode_attention.cu``),
held on the CPU.

The kernel runs only on the card, so this file models its data path step by
step in numpy, as the lanes run it:

* the int8 -> bf16 conversion in registers (``x ^ 0x80`` under the exponent
  of 2^23, less 2^23 + 128, the float's high half) is exact for all 256
  values;
* the fragment maps: in Q K^T lane (g, c) reads bytes [c D/4, (c + 1) D/4)
  of key g, one 4-byte word an mma, and q's A fragments are read in the same
  permutation of d; in P V lane (g, c) reads bytes [g D/8, (g + 1) D/8) of
  keys 2c, 2c + 1, 2c + 8, 2c + 9, byte t feeding output tile t.  Each map
  is built lane by lane from ``common.cuh``'s fragment layouts and covers
  every (key, d) of a tile once; the products they form are Q K^T and P V;
* the whole kernel (256-key ring stages, 32 keys for each of 8 warps,
  per-warp online softmax, k_scale on the score columns, v_scale on p
  before p's bf16 rounding, the warp and cluster merges) against
  ``decode_attention_q8_plain``
  within ``chip_smoke.py``'s ``TOL["bfloat16"]`` (2e-2), at phase 3's
  ragged lengths and split counts, and against the reference's ``kv_quant``
  attention (``repro/models/layers.py:293-301``: dequantize to bf16, then
  ``gqa_scores_softmax_value``) at ``tests/test_torch_kv_quant.py``'s shapes.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels.decode_attention import decode_attention_q8_plain
from repro_torch.models.layers import _quantize_kv

TOL_BF16 = 2e-2   # chip_smoke.py TOL["bfloat16"]: the kernel against its plain version
KEYS, WARPS = 256, 8          # kKeys8, kWarps8
KW = KEYS // WARPS            # keys a warp takes of each stage
ALIGN, MAX_QPK = 64, 16       # kAlign, kMaxQpk
NEG = -0.7 * float(np.finfo(np.float32).max)


def bf16(x):
    """Round float32 to bf16 (nearest even) and back, as __float2bfloat16_rn."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16().float().numpy()


def i8_float(words, sel):
    """``i8_float``: byte ``sel`` of each biased word under 2^23's exponent,
    less 2^23 + 128, as float32."""
    u = (words >> np.uint32(8 * sel)) & np.uint32(0xFF)
    return (np.uint32(0x4B000000) | u).view(np.float32) - np.float32(8388736.0)


def pack_exact_halves(f):
    """``pack_exact``: the float's high half, read back as a bf16 value."""
    return ((f.view(np.uint32) >> np.uint32(16)) << np.uint32(16)).view(np.float32)


def convert(x8):
    """int8 array (last dim a multiple of 4) -> float32 bf16 values, through
    the kernel's word arithmetic: each 4-byte word XOR 0x80808080, then
    byte by byte."""
    words = np.ascontiguousarray(x8).view(np.uint32) ^ np.uint32(0x80808080)
    out = np.stack([pack_exact_halves(i8_float(words, s)) for s in range(4)], axis=-1)
    return out.reshape(x8.shape)


def test_int8_to_bf16_in_registers_is_exact():
    x = np.arange(-128, 128, dtype=np.int8)
    got = convert(x)
    np.testing.assert_array_equal(got, x.astype(np.float32))
    assert np.array_equal(got, bf16(x.astype(np.float32)))   # every int8 is a bf16 value


# -- fragment maps, built lane by lane from common.cuh's layouts -------------
# A (16 x 16): a0 (row g, cols 2c, 2c+1), a1 (row g+8), a2 (row g, cols 2c+8,
# 2c+9), a3 (row g+8, cols 2c+8, 2c+9); B (16 x 8): b0 (rows 2c, 2c+1 of col
# g), b1 (rows 2c+8, 2c+9); C (16 x 8): c0, c1 (row g, cols 2c, 2c+1), c2, c3
# (row g+8).  A register's low half is its first element.

def _lanes():
    return [(lane // 4, lane % 4) for lane in range(32)]


@functools.lru_cache(maxsize=None)
def qk_maps(D):
    """For each mma kk of Q K^T: A's (row, col) -> (q row, d) and B's (row,
    col) -> (key of the 8, d), from what each lane loads: q's two uint2 at
    d = c D/4 + 4 kk and key g's word kk of bytes [c D/4, (c + 1) D/4)."""
    CK = D // 4
    maps = []
    for kk in range(D // 16):
        a = np.full((16, 16, 2), -1)
        b = np.full((16, 8, 2), -1)
        for g, c in _lanes():
            d0 = c * CK + 4 * kk
            for e in range(2):
                a[g, 2 * c + e] = (g, d0 + e)                # a0: lo.x
                a[g + 8, 2 * c + e] = (g + 8, d0 + e)        # a1: hi.x
                a[g, 2 * c + 8 + e] = (g, d0 + 2 + e)        # a2: lo.y
                a[g + 8, 2 * c + 8 + e] = (g + 8, d0 + 2 + e)  # a3: hi.y
                b[2 * c + e, g] = (g, d0 + e)                # b0: bytes 0, 1
                b[2 * c + 8 + e, g] = (g, d0 + 2 + e)        # b1: bytes 2, 3
        maps.append((a, b))
    return maps


@functools.lru_cache(maxsize=None)
def pv_maps(D):
    """P V, one mma per output tile n: A's (row, col) -> (row, key of the
    16) from the score fragments, B's (row, col) -> (key of the 16, d) from
    byte n of each lane's bytes [g D/8, (g + 1) D/8) of keys 2c, 2c + 1,
    2c + 8, 2c + 9, and C's column col -> d = col D/8 + n."""
    CV = D // 8
    a = np.full((16, 16, 2), -1)
    for g, c in _lanes():   # s tiles 2u (keys 0-7) and 2u + 1 (keys 8-15), C layout
        for e in range(2):
            a[g, 2 * c + e] = (g, 2 * c + e)
            a[g + 8, 2 * c + e] = (g + 8, 2 * c + e)
            a[g, 2 * c + 8 + e] = (g, 8 + 2 * c + e)
            a[g + 8, 2 * c + 8 + e] = (g + 8, 8 + 2 * c + e)
    maps = []
    for n in range(CV):
        b = np.full((16, 8, 2), -1)
        for g, c in _lanes():
            for i in range(4):
                key = 2 * c + (i & 1) + 8 * (i >> 1)
                b[2 * c + (i & 1) + 8 * (i >> 1), g] = (key, g * CV + n)
        maps.append((a, b, np.arange(8) * CV + n))
    return maps


@pytest.mark.parametrize("D", [32, 64, 80, 128, 192])
def test_fragment_maps_cover_each_element_once(D):
    seen = np.zeros((8, D), int)
    for a, b in qk_maps(D):
        assert (a >= 0).all() and (b >= 0).all()
        # the A and B elements an mma pairs carry the same d (it is contracted)
        for col in range(8):
            for r in range(16):
                assert a[r, :, 1].tolist() == b[:, col, 1].tolist()
        np.add.at(seen, (b[..., 0].ravel(), b[..., 1].ravel()), 1)
    assert (seen == 1).all()
    seen = np.zeros((16, D), int)
    cols = []
    for a, b, dcols in pv_maps(D):
        for col in range(8):   # A's key of a k-slot is B's key of that k-slot
            assert a[0, :, 1].tolist() == b[:, col, 0].tolist()
            assert (b[:, col, 1] == dcols[col]).all()
        np.add.at(seen, (b[..., 0].ravel(), b[..., 1].ravel()), 1)
        cols.extend(dcols)
    assert (seen == 1).all() and sorted(cols) == list(range(D))


@pytest.mark.parametrize("D", [32, 64, 80, 128, 192])
def test_partials_stored_tile_major_map_back_to_d(D):
    """Each lane stores its two columns of P V tile n at positions 8 n + 2c,
    8 n + 2c + 1 of its row (one 8-byte store); ``merge_store`` writes
    position p to d = (p % 8) D/8 + p // 8, the tile's column map."""
    CV = D // 8
    written = {}
    for a, b, dcols in pv_maps(D):
        n = int(dcols[0])   # tile n's column 0 is d = n
        for g, c in _lanes():
            for e in range(2):
                written[8 * n + 2 * c + e] = int(dcols[2 * c + e])
    assert sorted(written) == list(range(D))
    assert all(d == (p % 8) * CV + p // 8 for p, d in written.items())


def mma(a_src, a_map, b_src, b_map):
    """c (16 x 8) = A @ B with A and B gathered through their maps (bf16
    operands, float32 sums)."""
    A = a_src[a_map[..., 0], a_map[..., 1]]
    B = b_src[b_map[..., 0], b_map[..., 1]]
    return A.astype(np.float32) @ B.astype(np.float32)


def block_partials(Q, k8, v8, ks, vs, k_lo, k_hi, scale_log2, D):
    """One block's warps over keys [k_lo, k_hi): per warp (m, l, acc)
    of the 16 rows, as the kernel leaves them in part_m/part_l/part_acc."""
    nt = -(-(k_hi - k_lo) // KEYS)
    out = []
    for warp in range(WARPS):
        m, l = np.full(16, NEG, np.float32), np.zeros(16, np.float32)
        acc = np.zeros((16, D), np.float32)
        for t in range(nt):
            kw0 = k_lo + t * KEYS + KW * warp
            if kw0 >= k_hi:
                continue
            keys = kw0 + np.arange(KW)
            valid = keys < k_hi
            idx = np.where(valid, keys, 0)
            # zero-filled past k_hi: int8 0 and scale 0
            xk = np.where(valid[:, None], k8[idx], 0).astype(np.int8)
            xv = np.where(valid[:, None], v8[idx], 0).astype(np.int8)
            sk, sv = np.where(valid, ks[idx], 0), np.where(valid, vs[idx], 0)
            kf, vf = convert(xk), convert(xv)
            s = np.zeros((16, KW), np.float32)
            for j in range(KW // 8):
                for a_map, b_map in qk_maps(D):
                    s[:, 8 * j:8 * j + 8] += mma(Q, a_map, kf[8 * j:8 * j + 8], b_map)
            f = (bf16(sk) * np.float32(scale_log2)).astype(np.float32)
            s = np.where(valid[None], s * f[None], np.float32(NEG)).astype(np.float32)
            mx = s.max(1)
            m_new = np.maximum(m, mx)
            m_use = np.where(m_new == NEG, 0, m_new).astype(np.float32)
            alpha = np.exp2(m - m_use).astype(np.float32)
            p = np.exp2(s - m_use[:, None]).astype(np.float32)
            l = (alpha * l + p.sum(1)).astype(np.float32)
            m = m_new
            acc *= alpha[:, None]
            pv = bf16(p * bf16(sv)[None])   # v_scale on p, then the A fragment's rounding
            for u in range(KW // 16):
                for a_map, b_map, dcols in pv_maps(D):
                    acc[:, dcols] += mma(pv[:, 16 * u:16 * u + 16], a_map,
                                         vf[16 * u:16 * u + 16], b_map)
        out.append((m, l, acc))
    return out


def merge(parts):
    """``merge_store``'s rule over (m, l, acc) triples: weights 2^(m - M)."""
    M = np.max([m for m, _, _ in parts], axis=0)
    w = [np.exp2(m - M) for m, _, _ in parts]
    L = sum(wi * l for wi, (_, l, _) in zip(w, parts))
    acc = sum(wi[:, None] * a for wi, (_, _, a) in zip(w, parts))
    return M, L, acc


def model(q, k8, v8, ks, vs, lengths, splits):
    """The kernel on (B, Hkv, qpk, d) bf16 q and (B, Hkv, S, d) int8 K/V
    with (B, Hkv, S) float32 scales: float32 (B, Hkv, qpk, d) before the
    output's bf16 rounding, then rounded."""
    B, Hkv, qpk, D = q.shape
    S = k8.shape[2]
    scale_log2 = np.float32(1.4426950408889634) / np.float32(math.sqrt(D))
    out = np.zeros(q.shape, np.float32)
    for b in range(B):
        n = min(max(int(lengths[b]), 0), S)
        chunk = -(-(-(-n // splits)) // ALIGN) * ALIGN
        for h in range(Hkv):
            Q = np.zeros((16, D), np.float32)
            Q[:qpk] = q[b, h]
            blocks = []
            for rank in range(splits):
                k_lo = min(n, rank * chunk)
                k_hi = min(n, k_lo + chunk)
                blocks.append(merge(block_partials(Q, k8[b, h], v8[b, h], ks[b, h], vs[b, h],
                                                   k_lo, k_hi, scale_log2, D)))
            _, L, acc = merge(blocks)
            out[b, h] = (acc / np.maximum(L, 1e-30)[:, None])[:qpk]
    return bf16(out)


def _case(seed, B, Hkv, qpk, S, D):
    """A cache quantized as the model quantizes it (``_quantize_kv`` of
    N(0, 1) K/V), in the kernel's (B, Hkv, S, d) layout, and a bf16 query."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, Hkv, qpk, D, generator=g).bfloat16()
    (kq, ks), (vq, vs) = (_quantize_kv(torch.randn(B, S, Hkv, D, generator=g))
                          for _ in range(2))
    t = lambda a: a.transpose(1, 2).contiguous()
    return q, t(kq), t(vq), t(ks), t(vs)


# (B, Hkv, qpk, S, d, lengths, splits): phase 3's shapes cut in S and
# heads, ragged lengths (warps and splits with no key, a stage's tail), each
# cluster size
CASES = [
    (2, 1, 6, 300, 128, [300, 129], 2),
    (3, 1, 4, 200, 128, [1, 37, 5000], 8),
    (1, 2, 1, 160, 64, [159], 1),
    (2, 1, 4, 300, 80, [1, 300], 4),
    (1, 1, 16, 96, 32, [96], 2),
    (1, 1, 3, 140, 192, [140], 1),
]


@pytest.mark.parametrize("B,Hkv,qpk,S,D,lengths,splits", CASES)
def test_model_matches_plain_within_bf16_tolerance(B, Hkv, qpk, S, D, lengths, splits):
    q, kq, vq, ks, vs = _case(B * 100 + S + D, B, Hkv, qpk, S, D)
    lens = torch.tensor(lengths, dtype=torch.int32)
    got = model(q.float().numpy(), kq.numpy(), vq.numpy(), ks[..., 0].numpy(),
                vs[..., 0].numpy(), lens.numpy(), splits)
    want = decode_attention_q8_plain(q, kq, vq, ks, vs, lens).float().numpy()
    assert np.abs(got - want).max() <= TOL_BF16
    # and the exact attention on the float64 dequantized cache (the kernel
    # rounds the dequantized values once less than the plain version)
    kd = kq.double() * ks.double()
    vd = vq.double() * vs.double()
    sc = torch.einsum("bhgd,bhsd->bhgs", q.double(), kd) / math.sqrt(D)
    valid = torch.arange(S) < lens.clamp(max=S).reshape(-1, 1, 1, 1)
    p = torch.softmax(torch.where(valid, sc, -torch.inf), -1)
    exact = torch.einsum("bhgs,bhsd->bhgd", p, vd).numpy()
    assert np.abs(got - exact).max() <= TOL_BF16


def test_wrapper_on_cpu_is_the_plain_version():
    q, kq, vq, ks, vs = _case(3, 2, 1, 4, 64, 64)
    lens = torch.tensor([64, 9], dtype=torch.int32)
    assert torch.equal(dec.decode_attention_q8(q, kq, vq, ks, vs, lens),
                       decode_attention_q8_plain(q, kq, vq, ks, vs, lens))


@pytest.mark.parametrize("qpk,hd", [(4, 32), (8, 64), (2, 32)])
def test_model_matches_reference_kv_quant_attention(qpk, hd):
    """The reference's int8 branch in bf16: ``bf16(x) * bf16(scale)``, then
    ``gqa_scores_softmax_value`` (test_torch_kv_quant.py's B 3, S 24, Hkv 2
    and lengths 1, 13, S; its bf16 case's hd 32, qpk 2)."""
    rng = np.random.default_rng(qpk + hd)
    B, S, Hkv = 3, 24, 2
    k, v = (rng.standard_normal((B, S, Hkv, hd), np.float32) for _ in range(2))
    (kq, ks), (vq, vs) = JL._quantize_kv(jnp.asarray(k)), JL._quantize_kv(jnp.asarray(v))
    q = jnp.asarray(rng.standard_normal((B, 1, Hkv * qpk, hd), np.float32), jnp.bfloat16)
    lengths = np.array([1, 13, S], np.int32)
    ck = kq.astype(jnp.bfloat16) * ks.astype(jnp.bfloat16)
    cv = vq.astype(jnp.bfloat16) * vs.astype(jnp.bfloat16)
    mask = (jnp.arange(S)[None, :] < jnp.asarray(lengths)[:, None])[:, None, None, None, :]
    want = np.asarray(JL.gqa_scores_softmax_value(q, ck, cv, mask, q_per_kv=qpk)
                      .astype(jnp.float32))
    t = lambda a: np.ascontiguousarray(np.asarray(a).transpose(0, 2, 1, 3))
    qm = np.asarray(q.astype(jnp.float32))[:, 0].reshape(B, Hkv, qpk, hd)
    got = model(qm, t(kq), t(vq), t(ks)[..., 0], t(vs)[..., 0], lengths, 1)
    assert np.abs(got.reshape(B, 1, Hkv * qpk, hd) - want).max() <= TOL_BF16
