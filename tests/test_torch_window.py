"""Sliding-window attention over ring caches in the port against the
reference: the plain windowed flash against the reference model's
``causal_mask(window=)`` attention (fp32 2e-5), windowed prefill and ring
decode through ``attention_apply`` (per slot and synchronous, across the
wrap), reduced zamba2-2.7b with a window shorter than the prompt and
with decode across the wrap (logits 1e-4, every cache leaf), the dense
``lm_forward``/``lm_decode_step`` with ``window``, and the port's engine
token-identical to the reference's on windowed zamba2, refusing a prompt
longer than the ring."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.api import build_model as jax_build
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JServingEngine
from repro_torch.configs import get_reduced
from repro_torch.kernels.flash_attention import flash_attention_heads_plain
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.api import build_model
from repro_torch.models.convert import cache_from_numpy, params_from_numpy
from repro_torch.serve.engine import Request, ServingEngine

ATOL = 1e-4
WINDOW = 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(port, ref, atol=ATOL, rtol=1e-4):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=atol, rtol=rtol)


def _close_tree(port, ref, atol=ATOL):
    for a, b in zip(jax.tree_util.tree_leaves(port), jax.tree_util.tree_leaves(_np(ref))):
        assert tuple(a.shape) == b.shape
        _close(a, b, atol)


# -- the plain windowed flash ----------------------------------------------------


@pytest.mark.parametrize("S,window,qpk", [(16, 1, 1), (16, 5, 2), (37, 8, 4), (64, 64, 1),
                                          (20, 100, 2)])
def test_plain_windowed_flash_matches_reference_mask(S, window, qpk):
    """flash_attention_heads_plain(window=) against the reference model's
    attention under ``causal_mask(t, s, window=)``; a window >= S is the
    causal mask."""
    rng = np.random.default_rng(S + window)
    B, Hkv, d = 2, 2, 16
    q = rng.standard_normal((B, S, Hkv * qpk, d), np.float32)
    k = rng.standard_normal((B, S, Hkv, d), np.float32)
    v = rng.standard_normal((B, S, Hkv, d), np.float32)
    want = JL.gqa_scores_softmax_value(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       JL.causal_mask(S, S, window=window), q_per_kv=qpk)
    t = lambda a: torch.from_numpy(a).transpose(1, 2)
    got = flash_attention_heads_plain(t(q), t(k), t(v), causal=True, window=window)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_plain_windowed_flash_matches_chunked_reference():
    """Against the reference's q-chunked path with ``causal_skip`` (each
    chunk's key range starts at its window)."""
    rng = np.random.default_rng(3)
    B, S, Hkv, qpk, d, window = 1, 64, 2, 2, 16, 10
    q = rng.standard_normal((B, S, Hkv * qpk, d), np.float32)
    k = rng.standard_normal((B, S, Hkv, d), np.float32)
    v = rng.standard_normal((B, S, Hkv, d), np.float32)
    want = JL.chunked_causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       q_per_kv=qpk, window=window, chunk=16,
                                       causal_skip=True)
    t = lambda a: torch.from_numpy(a).transpose(1, 2)
    got = flash_attention_heads_plain(t(q), t(k), t(v), causal=True, window=window)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


# -- attention_apply: windowed prefill, ring decode -----------------------------------


def _attn_params(rng, d, H, Hkv, hd):
    return {
        "wq": rng.standard_normal((d, H, hd), np.float32) / np.sqrt(d),
        "wk": rng.standard_normal((d, Hkv, hd), np.float32) / np.sqrt(d),
        "wv": rng.standard_normal((d, Hkv, hd), np.float32) / np.sqrt(d),
        "wo": rng.standard_normal((H, hd, d), np.float32) / np.sqrt(H * hd),
    }


SPEC = JL.AttnParamsSpec(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8)


@pytest.mark.parametrize("causal", [True, False])
def test_windowed_prefill_matches_reference(causal):
    """The window applies only to a causal mask, as in the reference."""
    rng = np.random.default_rng(7)
    p = _attn_params(rng, 32, 4, 2, 8)
    x = rng.standard_normal((2, 21, 32), np.float32)
    pos = np.arange(21, dtype=np.int32)
    yj, cj = JL.attention_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                spec=SPEC, dtype=jnp.float32, rope_theta=10_000.0,
                                positions=jnp.asarray(pos), causal=causal, window=WINDOW)
    yt, ct = L.attention_apply({k: torch.from_numpy(v) for k, v in p.items()},
                               torch.from_numpy(x), dtype=torch.float32, rope_theta=10_000.0,
                               positions=torch.from_numpy(pos), causal=causal, window=WINDOW)
    _close(yt, yj, 1e-5, 1e-5)
    _close_tree(ct, cj, 1e-6)


@pytest.mark.parametrize("mode", ["per_slot", "synchronous"])
@pytest.mark.parametrize("S,window", [(8, 8), (8, 12)])
def test_ring_decode_matches_reference(mode, S, window):
    """Steps across the wrap of a ring of S = min(max_len, window) slots
    (window >= S, as the reference's caches are built): every lane writes
    at pos % S, none is dropped or clamped, and the output equals the
    reference's slot-position mask."""
    rng = np.random.default_rng(S + window)
    p = _attn_params(rng, 32, 4, 2, 8)
    B = 3
    cache = {n: rng.standard_normal((B, S, 2, 8), np.float32) for n in ("k", "v")}
    jcache = {n: jnp.asarray(c) for n, c in cache.items()}
    tcache = {n: torch.from_numpy(c.copy()) for n, c in cache.items()}
    pos = np.array([3, 7, 13], np.int32) if mode == "per_slot" else np.int32(5)
    for _ in range(6):
        x = rng.standard_normal((B, 1, 32), np.float32)
        positions = pos[:, None] if mode == "per_slot" else np.asarray([pos])
        yj, jcache = JL.attention_apply(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), spec=SPEC,
            dtype=jnp.float32, rope_theta=10_000.0, positions=jnp.asarray(positions),
            window=window, cache=jcache, cache_pos=jnp.asarray(pos))
        yt, out = L.attention_apply(
            {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
            dtype=torch.float32, rope_theta=10_000.0, positions=torch.from_numpy(positions),
            window=window, cache=tcache, cache_pos=torch.as_tensor(pos))
        assert out is tcache
        _close(yt, yj, 1e-5, 1e-5)
        _close_tree(tcache, jcache, 1e-6)
        pos = pos + 1


# -- reduced zamba2 with a window ----------------------------------------------------


@pytest.fixture(scope="module")
def zamba():
    """Reduced zamba2-2.7b with ``attn_window`` = WINDOW, on the reference's
    own parameters."""
    jcfg = jax_reduced("zamba2-2.7b")
    jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm, attn_window=WINDOW))
    cfg = get_reduced("zamba2-2.7b")
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, attn_window=WINDOW))
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = build_model(cfg, device="cpu")
    return jm, jp, m, params_from_numpy(_np(jp), cfg, "cpu")


def test_zamba2_window_shorter_than_prompt_forward(zamba):
    jm, jp, m, p = zamba
    tokens = np.random.default_rng(0).integers(0, m.cfg.vocab_size, (2, 3 * WINDOW + 5))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens)})
    tl, tc = m.prefill(p, {"tokens": torch.from_numpy(tokens)})
    _close(tl, jl)
    _close_tree(tc, jc)


@pytest.mark.parametrize("mode", ["per_slot", "synchronous"])
def test_zamba2_decode_across_the_wrap(zamba, mode):
    """A prefill shorter than the window into the ring, then decode steps
    past it: logits and every cache leaf against the reference each step."""
    jm, jp, m, p = zamba
    rng = np.random.default_rng(1)
    B, T, max_len = 2, 5, 32
    jcache = jm.init_cache(B, max_len)
    assert jcache["attn_kv"]["k"].shape[2] == WINDOW
    tokens = rng.integers(0, m.cfg.vocab_size, (B, T))
    _, pre = jm.prefill(jp, {"tokens": jnp.asarray(tokens)})
    jcache = jax.tree_util.tree_map(
        lambda full, part: jax.lax.dynamic_update_slice(full, part.astype(full.dtype),
                                                        (0,) * full.ndim), jcache, pre)
    tcache = cache_from_numpy(_np(jcache), m.cfg, "cpu")
    pos = np.array(T) if mode == "synchronous" else np.array([T, T - 2])
    for _ in range(2 * WINDOW):
        step = rng.integers(0, m.cfg.vocab_size, (B, 1))
        jl, jcache = jm.decode_step(jp, jcache, {"tokens": jnp.asarray(step),
                                                 "pos": jnp.asarray(pos, jnp.int32)})
        tl, out = m.decode_step(p, tcache, {"tokens": torch.from_numpy(step),
                                            "pos": torch.as_tensor(pos)})
        assert out is tcache
        _close(tl, jl)
        _close_tree(tcache, jcache)
        pos = pos + 1


def test_zamba2_init_cache_window_argument(zamba):
    """``init_cache(bs, ml, window=)`` overrides the config's window, as in
    the reference; max_len below the window keeps max_len slots."""
    jm, _, m, _ = zamba
    for ml, window in ((32, None), (32, 4), (5, None)):
        jc = jm.init_cache(2, ml, window=window)
        tc = m.init_cache(2, ml, window=window)
        for a, b in zip(jax.tree_util.tree_leaves(tc), jax.tree_util.tree_leaves(jc)):
            assert tuple(a.shape) == b.shape


# -- the dense transformer with window= ------------------------------------------------


@pytest.fixture(scope="module")
def dense():
    jcfg, cfg = jax_reduced("internlm2-20b"), get_reduced("internlm2-20b")
    jp = jax_build(jcfg).init(jax.random.PRNGKey(4))
    return jcfg, jp, cfg, params_from_numpy(_np(jp), cfg, "cpu")


def test_lm_forward_window(dense):
    jcfg, jp, cfg, p = dense
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 19))
    jl, jc, _ = JT.lm_forward(jp, {"tokens": jnp.asarray(tokens)}, jcfg, window=WINDOW,
                              return_cache=True)
    tl, tc = T.lm_forward(p, {"tokens": torch.from_numpy(tokens)}, cfg, window=WINDOW,
                          return_cache=True)
    _close(tl, jl)
    _close_tree(tc, jc)


@pytest.mark.parametrize("mode", ["per_slot", "synchronous"])
def test_lm_decode_step_window(dense, mode):
    """Decode from position 0 through two wraps of a windowed ring cache."""
    jcfg, jp, cfg, p = dense
    rng = np.random.default_rng(5)
    B = 2
    jcache = JT.lm_init_cache(jcfg, B, 64, window=WINDOW)
    tcache = T.lm_init_cache(cfg, B, 64, window=WINDOW, device="cpu")
    assert tuple(tcache["k"].shape) == jcache["k"].shape and jcache["k"].shape[2] == WINDOW
    pos = np.array(0) if mode == "synchronous" else np.array([0, 3])
    for _ in range(2 * WINDOW + 3):
        step = rng.integers(0, cfg.vocab_size, (B, 1))
        jl, jcache = JT.lm_decode_step(jp, jcache, {"tokens": jnp.asarray(step),
                                                    "pos": jnp.asarray(pos, jnp.int32)},
                                       jcfg, window=WINDOW)
        tl, _ = T.lm_decode_step(p, tcache, {"tokens": torch.from_numpy(step),
                                             "pos": torch.as_tensor(pos)}, cfg, window=WINDOW)
        _close(tl, jl)
        pos = pos + 1
    _close_tree(tcache, jcache)


# -- the serving engine -------------------------------------------------------------


def _reqs(specs, cls):
    return [cls(prompt=(np.arange(n) * 5 + 3 * i) % 128, max_new_tokens=k)
            for i, (n, k) in enumerate(specs)]


@pytest.mark.parametrize("num_slots,specs", [
    (2, [(6, 12), (WINDOW, 9), (3, 14)]),      # budgets past the ring, a full-ring prompt
    (3, [(2, 2 * WINDOW), (7, 5), (4, 11), (5, 3)]),
])
def test_engine_token_identical_to_reference(zamba, num_slots, specs):
    """Continuous batching over the ring: each slot's positions cross the
    window at its own step, and lanes admitted later reuse a wrapped lane."""
    jm, jp, m, p = zamba
    max_len = 4 * WINDOW
    ref = JServingEngine(jm, jp, num_slots=num_slots, max_len=max_len)
    eng = ServingEngine(m, p, num_slots=num_slots, max_len=max_len, device="cpu")
    assert eng.payload["cache"]["attn_kv"]["k"].shape[2] == WINDOW
    assert eng.run(_reqs(specs, Request)) == ref.run(_reqs(specs, JRequest))


def test_engine_step_many_matches_steps_across_the_wrap(zamba):
    jm, jp, m, p = zamba
    outs = []
    for block in (1, 7):
        eng = ServingEngine(m, p, num_slots=2, max_len=4 * WINDOW, device="cpu")
        for slot, r in enumerate(_reqs([(5, 15), (WINDOW, 12)], Request)):
            r.rid = slot
            eng.admit(r, slot)
        while any(r is not None for r in eng.slot_req):
            eng.step_many(block) if block > 1 else eng.step()
        outs.append(eng.outputs)
    assert outs[0] == outs[1]


def test_engine_refuses_prompt_longer_than_the_ring(zamba):
    """The reference's dynamic_update_slice of a prompt longer than the
    ring fails; the port raises a ValueError naming the ring size and
    leaves the slot free."""
    _, _, m, p = zamba
    eng = ServingEngine(m, p, num_slots=2, max_len=4 * WINDOW, device="cpu")
    before = [t.clone() for t in jax.tree_util.tree_leaves(eng.payload["cache"])]
    with pytest.raises(ValueError, match=f"ring of {WINDOW} positions"):
        eng.admit(Request(prompt=np.arange(WINDOW + 1) % 128, max_new_tokens=2, rid=0), 0)
    assert eng.free_slots() == [0, 1]
    for a, b in zip(jax.tree_util.tree_leaves(eng.payload["cache"]), before):
        assert torch.equal(a, b)
