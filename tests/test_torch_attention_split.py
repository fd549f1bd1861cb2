"""The decode-attention kernel's split of the KV cache across a thread block
cluster (``repro_torch/kernels/csrc/decode_attention.cu``), held on the CPU.

The kernel runs only on the card, so these tests pin what it relies on: the
host's split-count rule, and the algebra of split-and-merge, modelled here
in numpy float32 step by step as the kernel runs it (ranges from the
length, 4 warps a block each taking a quarter of every key tile, online
softmax in the log2 domain with the finite masked score, the warps merged,
then the blocks of the cluster) and held against the plain version and the
Pallas kernel of the JAX package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jdecode
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels.ref import NEG_INF

LOG2E = 1.4426950408889634
ALIGN = 64   # a split's range is a multiple of this many keys (kAlign)
WARPS = 4    # warps a block (kThreads / 32)
NEG = np.float32(NEG_INF)


@pytest.mark.parametrize("groups", [1, 2, 7, 8, 31, 32, 33, 63, 64, 65, 100, 127,
                                    128, 129, 200, 255, 256, 257, 1024, 4096])
def test_split_rule_gives_a_portable_cluster(groups):
    s = dec.num_splits(groups)
    assert s in dec.SPLITS and s & (s - 1) == 0 and 1 <= s <= 8
    # the fewest that reach the target, the most when none does
    assert groups * s >= dec.TARGET_BLOCKS or s == dec.SPLITS[-1]
    assert s == 1 or groups * (s // 2) < dec.TARGET_BLOCKS


@pytest.mark.parametrize("groups,want", [(64, 2), (128, 1), (256, 1), (8, 8)])
def test_split_rule_at_the_serving_shapes(groups, want):
    # internlm2-20b (B 8 x Hkv 8), olmoe-1b-7b (8 x 16), zamba2-2.7b (8 x 32),
    # one sequence of internlm2-20b
    # (measured on an H100: fewer, longer splits win once ~128 blocks run)
    assert dec.num_splits(groups) == want


def split_ranges(length, S, splits):
    """The kernel's key range [lo, hi) of each block of a cluster."""
    n = min(max(length, 0), S)
    chunk = -(-(-(-n // splits)) // ALIGN) * ALIGN
    return [(min(n, r * chunk), min(n, min(n, r * chunk) + chunk)) for r in range(splits)]


def online(m, l, acc, s, vv):
    """One warp's online-softmax update over scores ``s`` (rows x keys, log2
    domain, masked keys at NEG) and value rows ``vv``."""
    m_new = np.maximum(m, s.max(axis=1))
    m_use = np.where(m_new == NEG, np.float32(0), m_new)   # nothing seen yet: p = 0
    alpha = np.exp2(m - m_use)
    p = np.exp2(s - m_use[:, None])
    return m_new, alpha * l + p.sum(axis=1), alpha[:, None] * acc + p @ vv


def merge(ms, ls, accs):
    """Merge partial states (max, sum, acc) that share no key."""
    M = np.max(ms, axis=0)
    w = np.exp2(ms - M)
    return M, (w * ls).sum(axis=0), (w[..., None] * accs).sum(axis=0)


def block_state(q, k, v, lo, hi, tile, scale):
    """One block over keys [lo, hi): tiles of ``tile`` keys, warp w taking
    keys w * tile / 4 ... of each; returns the warps' merged state."""
    kw = tile // WARPS
    rows, d = q.shape
    m = np.full((WARPS, rows), NEG, np.float32)
    l = np.zeros((WARPS, rows), np.float32)
    acc = np.zeros((WARPS, rows, d), np.float32)
    for t0 in range(lo, hi, tile):
        for w in range(WARPS):
            k0 = t0 + w * kw
            if k0 >= hi:
                continue
            keys = np.arange(k0, k0 + kw)
            valid = keys < hi
            kk = np.where(valid[:, None], k[np.minimum(keys, len(k) - 1)], 0)
            vv = np.where(valid[:, None], v[np.minimum(keys, len(v) - 1)], 0)
            s = (q @ kk.T).astype(np.float32) * scale
            s = np.where(valid[None], s, NEG).astype(np.float32)
            m[w], l[w], acc[w] = online(m[w], l[w], acc[w], s, vv.astype(np.float32))
    return merge(m, l, acc)


def split_merge_model(q, k, v, lengths, splits, tile):
    """q (B, Hkv, qpk, d), k/v (B, Hkv, S, d) float32 -> (B, Hkv, qpk, d)."""
    B, Hkv, qpk, d = q.shape
    S = k.shape[2]
    scale = np.float32(LOG2E / np.sqrt(d))
    out = np.zeros_like(q)
    for b in range(B):
        ranges = split_ranges(int(lengths[b]), S, splits)
        for h in range(Hkv):
            states = [block_state(q[b, h], k[b, h], v[b, h], lo, hi, tile, scale)
                      for lo, hi in ranges]
            M, L, A = merge(*(np.stack(x) for x in zip(*states)))
            out[b, h] = A / np.maximum(L, np.float32(1e-30))[:, None]
    return out


def test_split_ranges_cover_the_valid_keys_once():
    for S in (100, 1024, 2048):
        for length in (1, 2, 37, 63, 64, 65, 127, 511, 1023, 2047, 2048, 5000):
            for splits in dec.SPLITS:
                ranges = split_ranges(length, S, splits)
                keys = [j for lo, hi in ranges for j in range(lo, hi)]
                assert keys == list(range(min(length, S)))
                assert all(lo % ALIGN == 0 for lo, hi in ranges if hi > lo)


@pytest.mark.parametrize("tile", [64, 32], ids=["bf16_tiles", "f32_tiles"])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_split_and_merge_matches_plain(splits, tile):
    rng = np.random.default_rng(splits * 100 + tile)
    B, Hkv, qpk, S, d = 6, 2, 3, 300, 16
    # 1, 37, just under S / splits, S - 1, S and past the end (the per-slot
    # lane that attends the whole cache): some splits get no key at all
    lengths = np.array([1, 37, S // splits - 1, S - 1, S, 5000], np.int32)
    q = rng.standard_normal((B, Hkv, qpk, d), dtype=np.float32)
    k = rng.standard_normal((B, Hkv, S, d), dtype=np.float32)
    v = rng.standard_normal((B, Hkv, S, d), dtype=np.float32)
    got = split_merge_model(q, k, v, lengths, splits, tile)
    assert np.isfinite(got).all()
    want = dec.decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), torch.from_numpy(lengths))
    np.testing.assert_allclose(got, want.numpy(), atol=2e-5, rtol=0)


@pytest.mark.parametrize("splits", [2, 8])
def test_split_and_merge_matches_pallas(splits):
    rng = np.random.default_rng(7 + splits)
    B, Hkv, qpk, S, d = 3, 2, 4, 256, 32
    lengths = np.array([1, 129, 256], np.int32)
    q = rng.standard_normal((B, Hkv, qpk, d), dtype=np.float32)
    k = rng.standard_normal((B, Hkv, S, d), dtype=np.float32)
    v = rng.standard_normal((B, Hkv, S, d), dtype=np.float32)
    got = split_merge_model(q, k, v, lengths, splits, 64)
    want = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
                   block_k=64, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=0)
