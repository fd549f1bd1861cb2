"""The int8 ``kv_quant`` KV cache in the port against the reference:
``_quantize_kv`` bit for bit (int8 values and float32 scales), the plain
int8 decode against the reference's dequantize-then-attend path (per slot,
synchronous, a lane past the cache end), reduced internlm2-20b with
``kv_quant`` decoded step by step from position 0 (logits 1e-4, every
cache leaf), ``cache_from_numpy`` keeping the int8 and float32 leaves, and
the serving engine's refusal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.kernels.decode_attention import decode_attention as jdecode
from repro.models import layers as JL
from repro.models.api import build_model as jax_build
from repro_torch.configs import get_reduced
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention_q8
from repro_torch.models import layers as L
from repro_torch.models.api import build_model
from repro_torch.models.convert import cache_from_numpy, params_from_numpy
from repro_torch.serve.engine import ServingEngine

ARCH = "internlm2-20b"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("shape", [(2, 1, 4, 16), (3, 5, 2, 64), (1, 7, 8, 128)])
def test_quantize_kv_bit_for_bit(shape):
    """Random rows plus rows whose scaled values sit exactly on .5 (round
    half to even on both sides) and an all-zero row (the 1e-8 floor)."""
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape, np.float32) * rng.uniform(0.01, 10, shape[:-1] + (1,))
    x = x.astype(np.float32)
    ties = np.zeros(shape[-1], np.float32)
    ties[:6] = [127.0, 2.5, -3.5, 0.5, -0.5, 126.5]
    x[0, 0, 0] = ties
    x[-1, -1, -1] = 0.0
    qj, sj = JL._quantize_kv(jnp.asarray(x))
    qt, st = L._quantize_kv(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert list(qt[0, 0, 0, :6]) == [127, 2, -4, 0, 0, 126]


def _q8_cache(rng, B, S, Hkv, hd):
    k, v = (rng.standard_normal((B, S, Hkv, hd), np.float32) for _ in range(2))
    (kq, ks), (vq, vs) = JL._quantize_kv(jnp.asarray(k)), JL._quantize_kv(jnp.asarray(v))
    return {"k": np.array(kq), "v": np.array(vq), "k_scale": np.array(ks),
            "v_scale": np.array(vs)}


@pytest.mark.parametrize("qpk,hd", [(1, 16), (4, 32), (8, 64)])
def test_plain_q8_decode_matches_dequantized_reference(qpk, hd):
    """The plain int8 decode against the reference's dequantize-then-attend
    (``layers.py:293-301``) and against the Pallas decode kernel
    (interpret mode) over the reference's dequantized cache."""
    rng = np.random.default_rng(qpk + hd)
    B, S, Hkv = 3, 24, 2
    c = _q8_cache(rng, B, S, Hkv, hd)
    q = rng.standard_normal((B, 1, Hkv * qpk, hd), np.float32)
    lengths = np.array([1, 13, S], np.int32)
    ck = jnp.asarray(c["k"]).astype(jnp.float32) * jnp.asarray(c["k_scale"])
    cv = jnp.asarray(c["v"]).astype(jnp.float32) * jnp.asarray(c["v_scale"])
    mask = (jnp.arange(S)[None, :] < jnp.asarray(lengths)[:, None])[:, None, None, None, :]
    want = JL.gqa_scores_softmax_value(jnp.asarray(q), ck, cv, mask, q_per_kv=qpk)
    got = ops.decode_attention_q8_bhsd(torch.from_numpy(q),
                                       *(torch.from_numpy(c[n]) for n in
                                         ("k", "v", "k_scale", "v_scale")),
                                       torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    pallas = jdecode(jnp.asarray(q[:, 0].reshape(B, Hkv, qpk, hd)), ck.transpose(0, 2, 1, 3),
                     cv.transpose(0, 2, 1, 3), jnp.asarray(lengths), block_k=8,
                     interpret=True)
    np.testing.assert_allclose(got.numpy()[:, 0].reshape(B, Hkv, qpk, hd), np.asarray(pallas),
                               atol=2e-5, rtol=2e-5)


def test_q8_wrapper_takes_bf16_queries_as_the_reference_dequantizes():
    """bf16 q: K/V dequantize to bf16 as ``bf16(x) * bf16(scale)``."""
    rng = np.random.default_rng(9)
    B, S, Hkv, qpk, hd = 2, 16, 2, 2, 32
    c = {n: torch.from_numpy(a) for n, a in _q8_cache(rng, B, S, Hkv, hd).items()}
    q = torch.from_numpy(rng.standard_normal((B, Hkv, qpk, hd), np.float32)).bfloat16()
    lengths = torch.tensor([5, 16], dtype=torch.int32)
    t = lambda a: a.transpose(1, 2)
    got = decode_attention_q8(q, t(c["k"]), t(c["v"]), t(c["k_scale"]), t(c["v_scale"]),
                              lengths)
    k = (c["k"].bfloat16() * c["k_scale"].bfloat16()).float()
    v = (c["v"].bfloat16() * c["v_scale"].bfloat16()).float()
    want = torch.from_numpy(np.asarray(jdecode(
        jnp.asarray(q.float().numpy()), jnp.asarray(t(k).numpy()), jnp.asarray(t(v).numpy()),
        jnp.asarray(lengths.numpy()), block_k=8, interpret=True)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=2e-2)


SPEC = JL.AttnParamsSpec(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8)


@pytest.mark.parametrize("pos", [np.array([0, 7, 15, 19], np.int32), np.int32(6),
                                 np.int32(21)], ids=["per_slot", "scalar", "scalar_past_end"])
def test_int8_attention_glue_matches_reference(pos):
    """attention_apply over an int8 cache: the new token quantized and
    written in place (a per-slot lane past the end drops its write, a
    scalar write clamps to the last slot), keys j <= pos attended."""
    rng = np.random.default_rng(11)
    B, S = 4, 16
    p = {"wq": rng.standard_normal((32, 4, 8), np.float32) / np.sqrt(32),
         "wk": rng.standard_normal((32, 2, 8), np.float32) / np.sqrt(32),
         "wv": rng.standard_normal((32, 2, 8), np.float32) / np.sqrt(32),
         "wo": rng.standard_normal((4, 8, 32), np.float32) / np.sqrt(32)}
    cache = _q8_cache(rng, B, S, 2, 8)
    x = rng.standard_normal((B, 1, 32), np.float32)
    positions = pos[:, None] if pos.ndim else np.asarray([pos])
    yj, cj = JL.attention_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                spec=SPEC, dtype=jnp.float32, rope_theta=10_000.0,
                                positions=jnp.asarray(positions), window=4,
                                cache={k: jnp.asarray(v) for k, v in cache.items()},
                                cache_pos=jnp.asarray(pos))
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    yt, ct = L.attention_apply({k: torch.from_numpy(v) for k, v in p.items()},
                               torch.from_numpy(x), dtype=torch.float32, rope_theta=10_000.0,
                               positions=torch.from_numpy(positions), window=4, cache=tcache,
                               cache_pos=torch.as_tensor(pos))
    assert ct is tcache
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5, rtol=1e-5)
    for n in ("k", "v"):   # the projections differ by rounding: the scales within it
        np.testing.assert_array_equal(tcache[n].numpy(), np.asarray(cj[n]))
    for n in ("k_scale", "v_scale"):
        np.testing.assert_allclose(tcache[n].numpy(), np.asarray(cj[n]), rtol=1e-5, atol=1e-9)


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jax_reduced(ARCH), kv_quant=True)
    cfg = dataclasses.replace(get_reduced(ARCH), kv_quant=True)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    return jm, jp, build_model(cfg, device="cpu"), params_from_numpy(_np(jp), cfg, "cpu")


@pytest.mark.parametrize("mode", ["synchronous", "per_slot"])
def test_decode_from_position_zero_matches_reference(pair, mode):
    """As ``tests/test_models.py::test_kv_quant_decode_close_to_fp`` drives
    the reference: step by step from position 0, past the cache end."""
    jm, jp, m, p = pair
    rng = np.random.default_rng(0)
    B, S = 2, 10
    jcache = jm.init_cache(B, S)
    tcache = m.init_cache(B, S)
    for n in ("k", "v", "k_scale", "v_scale"):
        assert tcache[n].dtype == {"k": torch.int8, "v": torch.int8}.get(n, torch.float32)
        assert tuple(tcache[n].shape) == jcache[n].shape
    pos = np.array(0) if mode == "synchronous" else np.array([0, 2])
    for _ in range(S + 2):
        step = rng.integers(0, m.cfg.vocab_size, (B, 1))
        jl, jcache = jm.decode_step(jp, jcache, {"tokens": jnp.asarray(step),
                                                 "pos": jnp.asarray(pos, jnp.int32)})
        tl, out = m.decode_step(p, tcache, {"tokens": torch.from_numpy(step),
                                            "pos": torch.as_tensor(pos)})
        assert out is tcache
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
        np.testing.assert_array_equal(tcache["k"].numpy(), np.asarray(jcache["k"]))
        np.testing.assert_array_equal(tcache["v"].numpy(), np.asarray(jcache["v"]))
        for n in ("k_scale", "v_scale"):
            np.testing.assert_allclose(tcache[n].numpy(), np.asarray(jcache[n]), rtol=1e-5,
                                       atol=1e-9)
        pos = pos + 1


def test_cache_from_numpy_keeps_int8_and_float32(pair):
    jm, _, m, _ = pair
    jc = jm.init_cache(2, 8)
    for dtype in (None, torch.bfloat16):
        tc = cache_from_numpy(_np(jc), m.cfg, "cpu", dtype=dtype)
        assert tc["k"].dtype == tc["v"].dtype == torch.int8
        assert tc["k_scale"].dtype == tc["v_scale"].dtype == torch.float32


def test_engine_refuses_kv_quant(pair):
    """The reference engine's tree_map over the cache and the prefill cache
    fails on the scale leaves; the port refuses the model up front."""
    _, _, m, p = pair
    with pytest.raises(ValueError, match="kv_quant"):
        ServingEngine(m, p, num_slots=2, max_len=16, device="cpu")
