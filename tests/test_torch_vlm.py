"""The ``vlm`` family (internvl2-76b) in the port against the reference, on
the reference's own parameters of the reduced config: the vision prefix
(``patch_proj`` of the patch embeddings before the token embeddings),
prefill logits and caches within 1e-4, then decode after the prefix
(synchronous and per slot), the port's own seeded init building the
reference's tree, and the serving engine's refusal."""

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
from repro_torch.serve.engine import ServingEngine

ARCH = "internvl2-76b"
ATOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=atol, rtol=1e-4)


@pytest.fixture(scope="module")
def pair():
    jm = jax_build(jax_reduced(ARCH))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_reduced(ARCH)
    return jm, jp, build_model(cfg, device="cpu"), params_from_numpy(_np(jp), cfg, "cpu")


def _batch(cfg, B, T, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, T)),
            "patch_embeds": rng.standard_normal((B, cfg.vlm.num_patches, cfg.d_model),
                                                np.float32)}


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


@pytest.mark.parametrize("T", [1, 9])
def test_prefill_logits_and_caches(pair, T):
    jm, jp, m, p = pair
    b = _batch(m.cfg, 2, T, T)
    jl, jc = jm.prefill(jp, {k: jnp.asarray(v) for k, v in b.items()})
    tl, tc = m.prefill(p, {k: torch.from_numpy(v) for k, v in b.items()})
    assert tl.shape == (2, m.cfg.vlm.num_patches + T, m.cfg.vocab_size)
    _close(tl, jl)
    for n in ("k", "v"):
        assert tuple(tc[n].shape) == jc[n].shape
        _close(tc[n], jc[n])


@pytest.mark.parametrize("mode", ["synchronous", "per_slot"])
def test_decode_after_the_prefix_matches_reference(pair, mode):
    """Prefill patches + prompt into a longer cache, then decode text tokens
    at positions after the prefix."""
    jm, jp, m, p = pair
    rng = np.random.default_rng(1)
    B, T, S = 2, 5, 20
    n = m.cfg.vlm.num_patches + T
    b = _batch(m.cfg, B, T, 4)
    _, pre = jm.prefill(jp, {k: jnp.asarray(v) for k, v in b.items()})
    jcache = jax.tree_util.tree_map(
        lambda full, part: jax.lax.dynamic_update_slice(full, part, (0, 0, 0, 0, 0)),
        jm.init_cache(B, S), pre)
    tcache = cache_from_numpy(_np(jcache), m.cfg, "cpu")
    pos = np.array(n) if mode == "synchronous" else np.array([n, n - 3])
    for _ in range(4):
        step = rng.integers(0, m.cfg.vocab_size, (B, 1))
        jl, jcache = jm.decode_step(jp, jcache, {"tokens": jnp.asarray(step),
                                                 "pos": jnp.asarray(pos, jnp.int32)})
        tl, out = m.decode_step(p, tcache, {"tokens": torch.from_numpy(step),
                                            "pos": torch.as_tensor(pos)})
        assert out is tcache
        _close(tl, jl)
        pos = pos + 1
    for name in ("k", "v"):
        _close(tcache[name], jcache[name])


def test_engine_refuses_vlm(pair):
    _, _, m, p = pair
    with pytest.raises(ValueError, match="token prompts only"):
        ServingEngine(m, p, num_slots=2, max_len=16, device="cpu")
