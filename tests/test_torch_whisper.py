"""Whisper (the ``audio`` family) in the port against the reference, on the
reference's own parameters of reduced whisper-large-v3: ``layernorm`` and
``sinusoids``, the encoder, prefill logits and both caches (self and cross)
within 1e-4, decode steps after prefill (synchronous and per slot) against
``whisper_decode_step``, the static cross cache read in place, and the
port's own seeded init building the reference's tree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import layers as JL
from repro.models import whisper as JW
from repro.models.api import build_model as jax_build
from repro_torch.configs import get_reduced
from repro_torch.models import layers as L
from repro_torch.models import whisper as W
from repro_torch.models.api import build_model
from repro_torch.models.convert import cache_from_numpy, params_from_numpy
from repro_torch.serve.engine import ServingEngine

ARCH = "whisper-large-v3"
ATOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=atol, rtol=1e-4)


def _close_tree(port, ref, atol=ATOL):
    for a, b in zip(jax.tree_util.tree_leaves(port), jax.tree_util.tree_leaves(_np(ref))):
        assert tuple(a.shape) == b.shape
        _close(a, b, atol)


@pytest.fixture(scope="module")
def pair():
    jm = jax_build(jax_reduced(ARCH))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_reduced(ARCH)
    return jm, jp, build_model(cfg, device="cpu"), params_from_numpy(_np(jp), cfg, "cpu")


def _batch(cfg, B, T, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, T)),
            "frames": rng.standard_normal((B, cfg.encdec.encoder_frames, cfg.d_model),
                                          np.float32)}


@pytest.mark.parametrize("shape", [(3, 40), (2, 5, 1280)])
def test_layernorm_matches_reference(shape):
    rng = np.random.default_rng(len(shape))
    d = shape[-1]
    p = {"scale": rng.standard_normal(d, np.float32), "bias": rng.standard_normal(d, np.float32)}
    x = (rng.standard_normal(shape, np.float32) * 3 + 1).astype(np.float32)
    want = JL.layernorm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = L.layernorm({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("length,channels", [(16, 40), (1500, 1280)])
def test_sinusoids_equal_reference(length, channels):
    np.testing.assert_array_equal(W.sinusoids(length, channels).numpy(),
                                  np.asarray(JW.sinusoids(length, channels)))


def test_params_carry_across(pair):
    jm, jp, m, p = pair
    flat, _ = jax.tree_util.tree_flatten_with_path(_np(jp))
    for path, leaf in flat:
        node = p
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), leaf)


def test_port_init_builds_reference_tree(pair):
    jm, _, m, _ = pair
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    p = m.init(seed=3)
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    for path, leaf in flat:
        node = p
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32
    assert sum(1 for _ in jax.tree_util.tree_leaves(p)) == len(flat)
    assert torch.equal(p["dec_layers"]["ln_cross"]["bias"], torch.zeros_like(
        p["dec_layers"]["ln_cross"]["bias"]))


def test_encode_matches_reference(pair):
    jm, jp, m, p = pair
    b = _batch(m.cfg, 2, 3, 0)
    want = JW.encode(jp, jnp.asarray(b["frames"]), jax_reduced(ARCH))
    got = W.encode(p, torch.from_numpy(b["frames"]), m.cfg)
    _close(got, want)


@pytest.mark.parametrize("T", [1, 6])
def test_prefill_logits_and_both_caches(pair, T):
    """Cross attention in prefill is non-causal with Sq = T != Skv = frames."""
    jm, jp, m, p = pair
    b = _batch(m.cfg, 2, T, T)
    jl, jc = jm.prefill(jp, {k: jnp.asarray(v) for k, v in b.items()})
    tl, tc = m.prefill(p, {k: torch.from_numpy(v) for k, v in b.items()})
    _close(tl, jl)
    assert set(tc) == {"self", "cross"}
    assert tuple(tc["cross"]["k"].shape) == (m.cfg.num_layers, 2, m.cfg.encdec.encoder_frames,
                                             m.cfg.num_kv_heads, m.cfg.resolved_head_dim)
    _close_tree(tc, jc)


@pytest.mark.parametrize("mode", ["synchronous", "per_slot"])
def test_decode_after_prefill_matches_reference(pair, mode):
    """Prefill a prompt into a longer self cache with the cross cache from
    prefill, then decode: logits each step, the self cache updated in place,
    the cross cache never written."""
    jm, jp, m, p = pair
    rng = np.random.default_rng(1)
    B, T, S = 2, 4, 12
    b = _batch(m.cfg, B, T, 2)
    _, pre = jm.prefill(jp, {k: jnp.asarray(v) for k, v in b.items()})
    jcache = jm.init_cache(B, S)
    jcache["self"] = jax.tree_util.tree_map(
        lambda full, part: jax.lax.dynamic_update_slice(full, part, (0, 0, 0, 0, 0)),
        jcache["self"], pre["self"])
    jcache["cross"] = pre["cross"]
    tcache = cache_from_numpy(_np(jcache), m.cfg, "cpu")
    cross = [t.clone() for t in jax.tree_util.tree_leaves(tcache["cross"])]
    pos = np.array(T) if mode == "synchronous" else np.array([T, T - 1])
    for _ in range(5):
        step = rng.integers(0, m.cfg.vocab_size, (B, 1))
        jl, jcache = jm.decode_step(jp, jcache, {"tokens": jnp.asarray(step),
                                                 "pos": jnp.asarray(pos, jnp.int32)})
        tl, out = m.decode_step(p, tcache, {"tokens": torch.from_numpy(step),
                                            "pos": torch.as_tensor(pos)})
        assert out is tcache
        _close(tl, jl)
        pos = pos + 1
    _close_tree(tcache, jcache)
    for a, b in zip(jax.tree_util.tree_leaves(tcache["cross"]), cross):
        assert torch.equal(a, b)


def test_decode_from_empty_self_cache_matches_forward(pair):
    """As ``tests/test_models.py::test_decode_matches_full_forward`` holds
    the reference: decoding the prompt token by token reproduces the
    forward's logits."""
    jm, jp, m, p = pair
    B, T = 2, 6
    b = _batch(m.cfg, B, T, 3)
    full = m.forward(p, {k: torch.from_numpy(v) for k, v in b.items()})
    _, pre = m.prefill(p, {"tokens": torch.from_numpy(b["tokens"][:, :1]),
                           "frames": torch.from_numpy(b["frames"])})
    cache = m.init_cache(B, T)
    cache["cross"] = pre["cross"]
    for t in range(T):
        lg, cache = m.decode_step(p, cache, {"tokens": torch.from_numpy(b["tokens"][:, t:t + 1]),
                                             "pos": torch.tensor(t)})
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t].numpy(), atol=ATOL, rtol=1e-4)


def test_engine_refuses_audio(pair):
    _, _, m, p = pair
    with pytest.raises(ValueError, match="token prompts only"):
        ServingEngine(m, p, num_slots=2, max_len=16, device="cpu")
