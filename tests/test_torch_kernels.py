"""The port's attention kernels (plain versions on the CPU) against the
reference's Pallas kernels in interpret mode, on the sweeps of
tests/test_kernels.py; the layout wrappers; and the cache-write / length
glue of the port's decode path against the reference model's per-slot and
synchronous decode, including lanes whose position is past the cache end.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: float32 2e-5, bfloat16 2e-2 (tests/test_kernels.py:18).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.decode_attention import decode_attention as jdecode
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import layers as JL
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(x, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _close(port, jax_out, dtype, rtol=1e-2):
    np.testing.assert_allclose(
        port.float().numpy(), np.asarray(jax_out, np.float32),
        atol=ATOL[dtype], rtol=rtol,
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("BH,BKV,S,d,causal", [
    (4, 4, 128, 64, True),
    (8, 2, 256, 64, True),
    (4, 4, 128, 128, False),
    (6, 3, 192, 32, True),
    (4, 4, 256, 128, True),   # q_per_kv = 1, d = 128: the olmoe/qwen2-moe heads
    (4, 4, 192, 80, True),    # q_per_kv = 1, d = 80: zamba2's shared attention
])
def test_flash_attention_matches_pallas(BH, BKV, S, d, causal, dtype):
    rng = np.random.default_rng(0)
    qpk = BH // BKV
    jq, tq = _pair(rng.standard_normal((BH, S, d), np.float32), dtype)
    jk, tk = _pair(rng.standard_normal((BKV, S, d), np.float32), dtype)
    jv, tv = _pair(rng.standard_normal((BKV, S, d), np.float32), dtype)
    want = jflash(jq, jk, jv, causal=causal, q_per_kv=qpk,
                  block_q=64, block_k=64, interpret=True)
    got = flash_attention(tq, tk, tv, causal=causal, q_per_kv=qpk)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hkv,qpk,S,d", [
    (2, 2, 4, 256, 64), (3, 1, 8, 128, 128), (2, 4, 1, 192, 64),
    (3, 4, 1, 192, 128),   # q_per_kv = 1, d = 128: the olmoe/qwen2-moe heads
    (3, 4, 1, 192, 80),    # q_per_kv = 1, d = 80: zamba2's shared attention
    (2, 2, 3, 128, 80),    # d = 80 with a query group
])
def test_decode_attention_matches_pallas(B, Hkv, qpk, S, d, dtype):
    rng = np.random.default_rng(1)
    jq, tq = _pair(rng.standard_normal((B, Hkv, qpk, d), np.float32), dtype)
    jk, tk = _pair(rng.standard_normal((B, Hkv, S, d), np.float32), dtype)
    jv, tv = _pair(rng.standard_normal((B, Hkv, S, d), np.float32), dtype)
    lengths = rng.integers(1, S + 1, B).astype(np.int32)
    want = jdecode(jq, jk, jv, jnp.asarray(lengths), block_k=64, interpret=True)
    got = decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    _close(got, want, dtype, rtol=1e-3)


def test_layout_wrappers_match_reference_ops():
    """ops.*_bhsd in the model layout (B, S, heads, d), the decode one
    reading the cache through a strided view."""
    rng = np.random.default_rng(2)
    B, S, H, Hkv, hd = 2, 64, 8, 2, 32
    jq, tq = _pair(rng.standard_normal((B, S, H, hd), np.float32), "float32")
    jk, tk = _pair(rng.standard_normal((B, S, Hkv, hd), np.float32), "float32")
    jv, tv = _pair(rng.standard_normal((B, S, Hkv, hd), np.float32), "float32")
    _close(ops.flash_attention_bhsd(tq, tk, tv, causal=True),
           jops.flash_attention_bhsd(jq, jk, jv, causal=True, interpret=True),
           "float32")
    lengths = np.array([1, 40], np.int32)
    _close(ops.decode_attention_bhsd(tq[:, :1], tk, tv, torch.from_numpy(lengths)),
           jops.decode_attention_bhsd(jq[:, :1], jk, jv, jnp.asarray(lengths),
                                      interpret=True),
           "float32", rtol=1e-3)
    # and both equal the reference model's einsum path (test_kernels.py:121)
    mask = JL.causal_mask(S, S)
    _close(L.gqa_scores_softmax_value(tq, tk, tv, L.causal_mask(S, S), q_per_kv=H // Hkv),
           JL.gqa_scores_softmax_value(jq, jk, jv, mask, q_per_kv=H // Hkv), "float32")


def test_reference_oracles_match():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((6, 48, 32), np.float32)
    kv = rng.standard_normal((3, 48, 32), np.float32)
    from repro.kernels import ref as jref

    for causal in (True, False):
        _close(ref.attention_ref(torch.from_numpy(q), torch.from_numpy(kv),
                                 torch.from_numpy(kv), causal=causal, q_per_kv=2),
               jref.attention_ref(q, kv, kv, causal=causal, q_per_kv=2), "float32")


def _attn_setup(seed, B, S, H, Hkv, hd, d):
    rng = np.random.default_rng(seed)
    spec = JL.AttnParamsSpec(d_model=d, num_heads=H, num_kv_heads=Hkv, head_dim=hd)
    p = {
        "wq": rng.standard_normal((d, H, hd), np.float32) / np.sqrt(d),
        "wk": rng.standard_normal((d, Hkv, hd), np.float32) / np.sqrt(d),
        "wv": rng.standard_normal((d, Hkv, hd), np.float32) / np.sqrt(d),
        "wo": rng.standard_normal((H, hd, d), np.float32) / np.sqrt(H * hd),
    }
    cache = {n: rng.standard_normal((B, S, Hkv, hd), np.float32) for n in ("k", "v")}
    x = rng.standard_normal((B, 1, d), np.float32)
    return spec, p, cache, x


def _both_attention(spec, p, cache, x, positions, cache_pos):
    y_j, c_j = JL.attention_apply(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        spec=spec, dtype=jnp.float32, rope_theta=10_000.0,
        positions=jnp.asarray(positions), cache={k: jnp.asarray(v) for k, v in cache.items()},
        cache_pos=jnp.asarray(cache_pos),
    )
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    y_t, c_t = L.attention_apply(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        dtype=torch.float32, rope_theta=10_000.0,
        positions=torch.from_numpy(np.asarray(positions)), cache=tcache,
        cache_pos=torch.from_numpy(np.asarray(cache_pos)),
    )
    assert c_t is tcache  # written in place
    return (y_t, c_t), (y_j, c_j)


def test_per_slot_decode_glue_matches_reference():
    """length = min(pos + 1, S) against the reference's per-slot mask, and
    its scatter that drops a lane's write once pos >= S."""
    B, S, H, Hkv, hd, d = 4, 16, 4, 2, 8, 32
    spec, p, cache, x = _attn_setup(4, B, S, H, Hkv, hd, d)
    pos = np.array([0, 7, 15, 19], np.int32)   # last lane is past the cache end
    (y_t, c_t), (y_j, c_j) = _both_attention(spec, p, cache, x, pos[:, None], pos)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5, rtol=1e-5)
    for n in ("k", "v"):
        np.testing.assert_allclose(c_t[n].numpy(), np.asarray(c_j[n]), atol=1e-6)
        np.testing.assert_array_equal(c_t[n][3].numpy(), cache[n][3])  # dropped write


@pytest.mark.parametrize("pos", [5, 15, 21])
def test_synchronous_decode_glue_matches_reference(pos):
    """Scalar position: the reference's dynamic_update_slice clamps its
    start to S - 1, and a position >= S attends the whole cache."""
    B, S, H, Hkv, hd, d = 2, 16, 4, 2, 8, 32
    spec, p, cache, x = _attn_setup(5, B, S, H, Hkv, hd, d)
    (y_t, c_t), (y_j, c_j) = _both_attention(
        spec, p, cache, x, np.array([pos], np.int32), np.int32(pos))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5, rtol=1e-5)
    for n in ("k", "v"):
        np.testing.assert_allclose(c_t[n].numpy(), np.asarray(c_j[n]), atol=1e-6)
