"""The port's recurrent models at their published depth against the
reference, on the CPU: reduced xlstm-1.3b at 48 layers (its 3 + 1 groups
twelve times) and reduced zamba2-2.7b at 54 Mamba2 blocks with the shared
block every 6, as published, on the reference's own parameters: prefill
logits and every cache leaf, then a greedy transcript (8 steps, each side
decoding the reference's greedy tokens, so every step's logits compare).

Tolerances (float32):
* zamba2-2.7b: 1e-4 / rtol 1e-4, as ``tests/test_torch_mamba2.py`` holds
  the 4-layer model;
* xlstm-1.3b: float32 error grows with depth (at 48 layers the port's and
  the reference's logits each lie ~3.5e-4 from a float64 run of the port),
  so 1e-4 tests rounding, not the port.  The witness, as
  ``tests/test_torch_sharded.py``'s xLSTM float32 case: every logit and
  cache leaf within 2x the port's float32 distance to its own float64 run
  on the same inputs (and never above 1e-2);
* greedy tokens: the port's equals the reference's at every step whose
  reference top-2 margin exceeds the tolerance in force.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models.api import build_model as jax_build
from repro_torch.configs import get_reduced
from repro_torch.models.api import build_model, tree_map
from repro_torch.models.convert import params_from_numpy

B, T, STEPS = 2, 16, 8
ATOL = 1e-4          # zamba2-2.7b, as at 4 layers
WITNESS = 2.0        # xlstm-1.3b: x the port's float32 distance to float64
CEILING = 1e-2       # xlstm-1.3b: and never above (chip_smoke.py XLSTM_LOGIT_ATOL)


def published_depth(cfg):
    """The reduced config at the published depth: 48 xLSTM layers; 54
    Mamba2 blocks with the shared block every 6."""
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, num_layers=54,
                                   ssm=dataclasses.replace(cfg.ssm, attn_every=6))
    return dataclasses.replace(cfg, num_layers=48)


@pytest.fixture(scope="module", params=["xlstm-1.3b", "zamba2-2.7b"])
def run(request):
    """Both packages' prefill and teacher-forced greedy steps, and the
    port's float64 run on the same tokens: logits per call and the final
    cache of each."""
    arch = request.param
    jcfg, cfg = published_depth(jax_reduced(arch)), published_depth(get_reduced(arch))
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    sides = {"port": (build_model(cfg, device="cpu"), p),
             "port64": (build_model(dataclasses.replace(cfg, param_dtype="float64",
                                                        dtype="float64"), device="cpu"),
                        tree_map(torch.Tensor.double, p))}
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, T))
    hybrid = cfg.family == "hybrid"

    # the reference first: its greedy tokens drive every side
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(tokens)})
    if hybrid:   # the prefill's K/V into a cache with room for the steps
        full = jm.init_cache(B, T + STEPS)
        jcache = {"mamba": jcache["mamba"],
                  "attn_kv": {n: full["attn_kv"][n].at[:, :, :T].set(jcache["attn_kv"][n])
                              for n in ("k", "v")}}
    out = {"ref": [np.asarray(jl, np.float64)]}
    greedy = []
    for i in range(STEPS):
        greedy.append(out["ref"][-1][:, -1].argmax(-1))
        jl, jcache = jm.decode_step(jp, jcache, {"tokens": jnp.asarray(greedy[i][:, None]),
                                                 "pos": jnp.asarray(T + i, jnp.int32)})
        out["ref"].append(np.asarray(jl, np.float64))
    caches = {"ref": [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(jcache)]}
    for name, (model, params) in sides.items():
        lg, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)})
        if hybrid:
            part, cache = cache, model.init_cache(B, T + STEPS)
            for i in range(2):
                cache["mamba"][i].copy_(part["mamba"][i])
            for n in ("k", "v"):
                cache["attn_kv"][n][:, :, :T] = part["attn_kv"][n]
        out[name] = [lg.double().numpy()]
        for i in range(STEPS):
            lg, _ = model.decode_step(params, cache, {
                "tokens": torch.from_numpy(greedy[i][:, None]), "pos": torch.tensor(T + i)})
            out[name].append(lg.double().numpy())
        caches[name] = [x.double().numpy() for x in jax.tree_util.tree_leaves(cache)]
    return arch, out, caches


def _limits(arch, port, port64, ref):
    """The elementwise limit |port - ref| is held to (see the module's
    docstring)."""
    if arch == "zamba2-2.7b":
        return ATOL + 1e-4 * np.abs(ref)
    return min(WITNESS * np.abs(port - port64).max(), CEILING)


def test_logits_at_depth(run):
    arch, out, _ = run
    assert len(out["port"]) == STEPS + 1
    for i, (got, want, f64) in enumerate(zip(out["port"], out["ref"], out["port64"])):
        assert got.shape == want.shape
        assert (np.abs(got - want) <= _limits(arch, got, f64, want)).all(), (
            f"{arch} call {i}: |port - ref| {np.abs(got - want).max():.3g}, port's float32 "
            f"distance to float64 {np.abs(got - f64).max():.3g}")


def test_cache_leaves_at_depth(run):
    arch, _, caches = run
    assert len(caches["port"]) == len(caches["ref"])
    for j, (got, want, f64) in enumerate(zip(caches["port"], caches["ref"], caches["port64"])):
        assert got.shape == want.shape
        assert (np.abs(got - want) <= _limits(arch, got, f64, want)).all(), (
            f"{arch} cache leaf {j}: |port - ref| {np.abs(got - want).max():.3g}")


def test_greedy_transcript_at_depth(run):
    """The port's greedy token at each call's last position is the
    reference's wherever the reference's top-2 margin exceeds the
    tolerance."""
    arch, out, _ = run
    for i, (got, want, f64) in enumerate(zip(out["port"], out["ref"], out["port64"])):
        top2 = np.sort(want[:, -1], axis=-1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        tol = np.max(_limits(arch, got, f64, want))
        same = got[:, -1].argmax(-1) == want[:, -1].argmax(-1)
        assert (same | (margin <= tol)).all(), f"{arch} call {i}: margins {margin}"
