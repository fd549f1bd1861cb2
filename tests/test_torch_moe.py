"""The port's MoE slice against the reference, on the CPU.

* the grouped-matmul kernel's plain version against the Pallas kernel in
  interpret mode (the sweep of tests/test_kernels.py, atol 2e-3, rtol 1e-3
  in float32; bfloat16 outputs within one rounding, atol 2e-2, rtol 1e-2),
  and a shape whose dims the blocks do not divide;
* ``ops.grouped_matmul``'s group fold against a per-group einsum;
* ``moe_apply`` (y and the aux loss, atol 1e-4, float32) against
  ``repro.models.moe.moe_apply`` in the dropless decode regime, with
  capacity drops, with G > 1 groups, and with qwen2-moe's shared experts;
* param conversion and the port's seeded init against the reference tree;
* greedy serving on reduced olmoe, token-identical to the reference engine.

Inputs are made with numpy from a seed and handed to both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.kernels import ref as jref
from repro.kernels.grouped_matmul import grouped_matmul as jgmm
from repro.models import moe as JM
from repro.models.api import build_model as jax_build
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JServingEngine
from repro_torch.configs import get_reduced
from repro_torch.kernels import grouped_matmul as gmm
from repro_torch.kernels import ops
from repro_torch.models import moe as M
from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.engine import Request, ServingEngine

MOE_ARCHS = ["olmoe-1b-7b", "qwen2-moe-a2.7b"]
GMM_TOL = {"float32": dict(atol=2e-3, rtol=1e-3),    # tests/test_kernels.py:116
           "bfloat16": dict(atol=2e-2, rtol=1e-2)}   # one bf16 rounding of O(1) outputs
MOE_ATOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- the grouped-matmul kernel -----------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,d,f", [
    (1, 16, 32, 16), (2, 48, 64, 64), (3, 16, 64, 64), (4, 48, 32, 16),
    (3, 20, 48, 24),   # C and f not multiples of the 16-blocks
])
def test_grouped_matmul_matches_pallas(E, C, d, f, dtype):
    rng = np.random.default_rng(E * 7 + C)
    x = rng.standard_normal((E, C, d), np.float32)
    w = rng.standard_normal((E, d, f), np.float32) / np.sqrt(d)
    want = jgmm(jnp.asarray(x, dtype), jnp.asarray(w, dtype),
                block_c=16, block_f=16, block_d=16, interpret=True)
    tdt = getattr(torch, dtype)
    got = gmm.grouped_matmul(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (E, C, f)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **GMM_TOL[dtype])


def test_grouped_matmul_ragged_depth_matches_reference_oracle():
    """d = 40 is no multiple of a 16-block; the Pallas kernel in interpret
    mode reads its padded tail (NaN), so the reference's own oracle holds
    this case."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 5, 40), np.float32)
    w = rng.standard_normal((3, 40, 24), np.float32) / np.sqrt(40)
    got = gmm.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.grouped_matmul_ref(x, w)),
                               **GMM_TOL["float32"])


def test_ops_grouped_matmul_folds_groups():
    """(G, E, C, d) with G = 3: the group dim folds into the capacity dim."""
    rng = np.random.default_rng(12)
    G, E, C, d, f = 3, 4, 5, 16, 24
    x = rng.standard_normal((G, E, C, d), np.float32)
    w = rng.standard_normal((E, d, f), np.float32)
    got = ops.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert tuple(got.shape) == (G, E, C, f)
    want = np.stack([np.einsum("ecd,edf->ecf", x[g], w) for g in range(G)])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)
    one = ops.grouped_matmul(torch.from_numpy(x[:1]), torch.from_numpy(w))
    np.testing.assert_allclose(one.numpy(), want[:1], atol=1e-4, rtol=1e-5)


# -- the MoE layer ---------------------------------------------------------------


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_pair(request):
    """One layer's reference MoE params (shared-expert gate made non-zero so
    it is exercised) as jax arrays and as port tensors."""
    arch = request.param
    cfg = get_reduced(arch)
    tree = _np(JM.moe_init(jax.random.PRNGKey(0), cfg.d_model, jax_reduced(arch).moe,
                           jnp.float32))
    if "shared" in tree:
        tree["shared"]["gate"] = np.random.default_rng(5).standard_normal(
            tree["shared"]["gate"].shape).astype(np.float32)
    return arch, cfg, jax.tree_util.tree_map(jnp.asarray, tree), params_from_numpy(
        tree, cfg, "cpu")


def _dropped_pairs(p, x, cfg, tokens_per_group):
    """Pairs past their expert's capacity, from the port's own routing."""
    B, T, _ = x.shape
    G, _, C = M.capacity(B * T, cfg.moe, tokens_per_group)
    _, _, top_e, _ = M.route(x, p["router"], cfg.moe, tokens_per_group)
    counts = torch.nn.functional.one_hot(top_e.reshape(G, -1), cfg.moe.num_experts).sum(1)
    return int((counts - C).clamp(min=0).sum())


@pytest.mark.parametrize("B,T,tokens_per_group,drops", [
    (8, 1, 4096, False),    # decode: 8 slots, one group of 8, C = Tg (dropless)
    (1, 300, 4096, True),   # a 300-token prompt: Tg > 256, capacity drops
    (4, 300, 300, True),    # G = 4 groups of 300, with drops
    (2, 300, 150, False),   # G = 4 groups of 150: dropless per group
])
def test_moe_apply_matches_reference(moe_pair, B, T, tokens_per_group, drops):
    arch, cfg, jp, tp = moe_pair
    rng = np.random.default_rng(B * 1000 + T)
    # a shared component makes the tokens prefer the same experts, so the
    # capacity-bound cases do overflow
    x = (0.5 * rng.standard_normal((B, T, cfg.d_model))
         + rng.standard_normal(cfg.d_model)).astype(np.float32)
    yj, aj = JM.moe_apply(jp, jnp.asarray(x), jax_reduced(arch).moe, jnp.float32,
                          tokens_per_group=tokens_per_group)
    yt, at = M.moe_apply(tp, torch.from_numpy(x), cfg.moe, torch.float32,
                         tokens_per_group=tokens_per_group)
    assert yt.shape == (B, T, cfg.d_model) and yt.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=MOE_ATOL, rtol=1e-4)
    np.testing.assert_allclose(at.item(), float(aj), atol=MOE_ATOL)
    assert (_dropped_pairs(tp, torch.from_numpy(x), cfg, tokens_per_group) > 0) == drops


@pytest.mark.parametrize("N,tokens_per_group,G,Tg", [
    (8, 4096, 1, 8), (1024, 4096, 1, 1024), (1200, 300, 4, 300), (600, 150, 4, 150),
    (7, 2, 1, 7), (12, 5, 2, 6),
])
def test_group_count_and_capacity_match_reference(N, tokens_per_group, G, Tg):
    cfg = get_reduced("olmoe-1b-7b").moe
    assert M._group_count(N, tokens_per_group) == JM._group_count(N, tokens_per_group) == G
    g, tg, C = M.capacity(N, cfg, tokens_per_group)
    assert (g, tg) == (G, Tg)
    want = Tg if Tg <= 256 else int(np.ceil(Tg * cfg.top_k / cfg.num_experts
                                            * cfg.capacity_factor))
    assert C == want


def test_moe_apply_bf16_keeps_float32_routing(moe_pair):
    """A bfloat16 layer routes in float32 through its float32 router (the
    same experts and weights as the float32 layer on the same inputs) and
    returns bfloat16 close to the float32 layer."""
    arch, cfg, _, tp = moe_pair
    tree16 = {k: (v if k == "router" else
                  ({kk: vv.to(torch.bfloat16) for kk, vv in v.items()}
                   if isinstance(v, dict) else v.to(torch.bfloat16)))
              for k, v in tp.items()}
    x16 = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (8, 1, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    y16, a16 = M.moe_apply(tree16, x16, cfg.moe, torch.bfloat16)
    y32, a32 = M.moe_apply(tp, x16.float(), cfg.moe, torch.float32)
    assert y16.dtype == torch.bfloat16 and tree16["router"].dtype == torch.float32
    assert a16.dtype == torch.float32 and a16.item() == a32.item()
    np.testing.assert_allclose(y16.float().numpy(), y32.numpy(), atol=0.1, rtol=0.05)


# -- params ------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_from_numpy_keeps_router_float32(arch):
    cfg = get_reduced(arch)
    tree = _np(jax_build(jax_reduced(arch)).init(jax.random.PRNGKey(0)))
    p = params_from_numpy(tree, cfg, "cpu", dtype=torch.bfloat16)
    moe = p["layers"]["moe"]
    assert moe["router"].dtype == torch.float32
    np.testing.assert_array_equal(moe["router"].numpy(), tree["layers"]["moe"]["router"])
    assert moe["w_gate"].dtype == torch.bfloat16
    assert p["layers"]["attn"]["wq"].dtype == torch.bfloat16
    if "shared" in moe:
        assert moe["shared"]["gate"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_port_init_builds_reference_moe_tree(arch, param_dtype):
    """The port's seeded init: the reference's paths and shapes
    (``jax.eval_shape``), layer-stacked, the router float32 and every other
    leaf in ``param_dtype``.  (The reference's own bf16 init turns the
    leaves it scales by a numpy float64 into float32, so only its router's
    dtype is compared.)"""
    jcfg = dataclasses.replace(jax_reduced(arch), param_dtype=param_dtype)
    jshapes = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_reduced(arch), param_dtype=param_dtype)
    p = build_model(cfg, device="cpu").init(seed=3)
    flat, _ = jax.tree_util.tree_flatten_with_path(jshapes)
    n_leaves = 0
    for path, leaf in flat:
        node = p
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape, path
        n_leaves += 1
    assert n_leaves == sum(1 for _ in _leaves(p))
    assert p["layers"]["moe"]["router"].dtype == torch.float32
    assert str(jshapes["layers"]["moe"]["router"].dtype) == "float32"
    others = [t for t in _leaves(p) if t is not p["layers"]["moe"]["router"]]
    assert all(t.dtype == getattr(torch, param_dtype) for t in others)
    # layers are drawn one by one, and the seed fixes them
    w = p["layers"]["moe"]["w_gate"]
    assert not torch.equal(w[0], w[1])
    assert torch.equal(w, build_model(cfg, device="cpu").init(seed=3)["layers"]["moe"]["w_gate"])
    # the reference's scales: router and gate/up 1/sqrt(d), down 1/sqrt(f)
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    assert abs(w.float().std().item() * np.sqrt(d) - 1) < 0.1
    wd = p["layers"]["moe"]["w_down"].float()
    assert abs(wd.std().item() * np.sqrt(f) - 1) < 0.1


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# -- serving -----------------------------------------------------------------------


def _reqs(specs, cls):
    return [cls(prompt=np.arange(n)[::-1] % 128 if i % 2 else (np.arange(n) * 7) % 128,
                max_new_tokens=m) for i, (n, m) in enumerate(specs)]


@pytest.mark.parametrize("num_slots,specs", [
    (2, [(4, 3), (9, 6), (2, 4), (5, 2)]),
    (3, [(1, 5), (12, 3), (7, 7), (3, 4), (6, 4)]),
])
def test_olmoe_serving_token_identical_to_reference(num_slots, specs):
    jm = jax_build(jax_reduced("olmoe-1b-7b"))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_reduced("olmoe-1b-7b")
    m = build_model(cfg, device="cpu")
    eng = ServingEngine(m, params_from_numpy(_np(jp), cfg, "cpu"), num_slots=num_slots,
                        max_len=32, device="cpu")
    out = eng.run(_reqs(specs, Request))
    ref = JServingEngine(jm, jp, num_slots=num_slots, max_len=32).run(_reqs(specs, JRequest))
    assert out == ref
    assert {r: len(v) for r, v in out.items()} == {
        i: max(n, 2) for i, (_, n) in enumerate(specs)}
