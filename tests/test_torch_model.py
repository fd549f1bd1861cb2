"""The port's dense and MoE models against the reference, on the
reference's own parameters: ``params_from_numpy`` of JAX ``lm_init`` params
for the reduced llama3-405b, internlm2-20b, olmoe-1b-7b and qwen2-moe-a2.7b
configs; logits for prefill, synchronous decode and per-slot decode (atol
1e-4, float32), and the caches each returns."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models.api import build_model as jax_build
from repro_torch.configs import get_reduced
from repro_torch.models.api import build_model
from repro_torch.models.convert import cache_from_numpy, params_from_numpy

ARCHS = ["llama3-405b", "internlm2-20b", "olmoe-1b-7b", "qwen2-moe-a2.7b"]
ATOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    jm = jax_build(jax_reduced(request.param))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_reduced(request.param)
    m = build_model(cfg, device="cpu")
    return jm, jp, m, params_from_numpy(_np(jp), cfg, "cpu")


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=atol, rtol=1e-4)


def test_params_carry_across(pair):
    jm, jp, m, p = pair
    flat, _ = jax.tree_util.tree_flatten_with_path(_np(jp))
    for path, leaf in flat:
        node = p
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), leaf)


def test_prefill_logits_and_cache(pair):
    jm, jp, m, p = pair
    tokens = np.random.default_rng(0).integers(0, m.cfg.vocab_size, (2, 11))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens)})
    tl, tc = m.prefill(p, {"tokens": torch.from_numpy(tokens)})
    _close(tl, jl)
    for n in ("k", "v"):
        assert tuple(tc[n].shape) == jc[n].shape
        _close(tc[n], jc[n])


def test_long_prefill_matches_chunked_reference(pair):
    """A prompt above ``attn_chunk`` (1024) takes the reference's scan over
    q-chunks; the port computes the same math in one attention call."""
    jm, jp, m, p = pair
    assert m.cfg.attn_chunk == 1024
    tokens = np.random.default_rng(2).integers(0, m.cfg.vocab_size, (1, 2048))
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(tokens)})
    tl, _ = m.prefill(p, {"tokens": torch.from_numpy(tokens)})
    _close(tl, jl)


@pytest.mark.parametrize("mode", ["synchronous", "per_slot"])
def test_decode_logits_and_cache(pair, mode):
    """Prefill into a longer cache, then three decode steps; per-slot lanes
    sit at different positions."""
    jm, jp, m, p = pair
    rng = np.random.default_rng(1)
    B, T, S = 2, 6, 16
    tokens = rng.integers(0, m.cfg.vocab_size, (B, T))
    _, jc0 = jm.prefill(jp, {"tokens": jnp.asarray(tokens)})
    jcache = jax.tree_util.tree_map(
        lambda full, part: jax.lax.dynamic_update_slice(full, part, (0, 0, 0, 0, 0)),
        jm.init_cache(B, S), jc0)
    tcache = cache_from_numpy(_np(jcache), m.cfg, "cpu")
    pos = np.array(T) if mode == "synchronous" else np.array([T, T - 2])
    for _ in range(3):
        step = rng.integers(0, m.cfg.vocab_size, (B, 1))
        jl, jcache = jm.decode_step(jp, jcache, {"tokens": jnp.asarray(step),
                                                 "pos": jnp.asarray(pos, jnp.int32)})
        tl, out_cache = m.decode_step(p, tcache, {"tokens": torch.from_numpy(step),
                                                  "pos": torch.as_tensor(pos)})
        assert out_cache is tcache and tl.shape == (B, 1, m.cfg.vocab_size)
        _close(tl, jl)
        pos = pos + 1
    for n in ("k", "v"):
        _close(tcache[n], jcache[n])


def test_port_init_shapes_and_dtypes():
    """The port's own seeded init builds the reference's param tree."""
    cfg = get_reduced("internlm2-20b")
    jshapes = jax.eval_shape(jax_build(jax_reduced("internlm2-20b")).init,
                             jax.random.PRNGKey(0))
    p = build_model(cfg, device="cpu").init(seed=3)
    flat, _ = jax.tree_util.tree_flatten_with_path(jshapes)
    for path, leaf in flat:
        node = p
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape
    assert torch.equal(p["layers"]["attn"]["wq"],
                       build_model(cfg, device="cpu").init(seed=3)["layers"]["attn"]["wq"])
