"""The port's sharding rules, plans and dry-run against the reference's.

* the five rule cases of ``tests/test_sharding.py``, twinned;
* for every arch x cell and both production meshes, the port's
  ``Sharder.spec`` of every param (expert stacks included) and cache leaf
  equals the reference's ``PartitionSpec`` (the reference reads only
  ``mesh.shape`` and ``mesh.axis_names``, so a stand-in mesh serves both);
* ``plans`` equal the reference's; no multi-axis spec entry runs against
  the mesh's axis order (DTensor splits in mesh order);
* the dry-run's twin in a fresh interpreter: reduced internlm2-20b
  ``train`` at (32, 8) on a fake (4, 2) mesh counts flops, the data-parallel
  gradient sync's collective bytes and one layer-site repeat per layer,
  with argument bytes equal to ``tree_shard_bytes``; the kernel wrappers
  raise for a layout that splits a dim they reduce over;
* a train step's counted matmul flops equal a hand count, attention's
  products and a full remat's recompute included;
* the roofline's H100 arithmetic and ``DeviceHandlerTable.lower``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import pytest
import torch

from repro.launch import plans as ref_plans
from repro.models.api import build_model as jax_build
from repro.models.config import ShardingPlan as RefPlan
from repro.models.moe import expert_specs as ref_expert_specs
from repro.models.sharding import Sharder as RefSharder
from repro_torch.configs import ARCH_IDS
from repro_torch.core.device_table import DeviceHandlerTable
from repro_torch.core.errors import RegistryError
from repro_torch.launch import plans
from repro_torch.launch import roofline as R
from repro_torch.models.api import build_model
from repro_torch.models.config import SHAPE_CELLS, ShardingPlan, shape_cell
from repro_torch.models.moe import expert_specs
from repro_torch.models.sharding import PartitionSpec, Sharder, mesh_axes, spec_axes
from repro_torch.optim.adamw import tree_leaves


class _FakeMesh:
    """Only what both packages' ``Sharder.spec`` read."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)
        self.mesh_dim_names = tuple(shape)


MESHES = {"pod16x16": {"data": 16, "model": 16},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _sharder(**plan_kw):
    return Sharder(_FakeMesh({"data": 16, "model": 16}),
                   ShardingPlan(batch_axes=("pod", "data"), **plan_kw))


# -- the rule cases of tests/test_sharding.py --------------------------------------


RULE_CASES = {
    # 20 heads don't divide the 16-way model axis -> replicate; 48 do
    "divisibility_fallback": lambda: (
        _sharder().spec((2560, 20, 128), [None, "model", None])[1] is None
        and _sharder().spec((6144, 48, 128), [None, "model", None])[1] == "model"),
    "axis_used_once_per_spec": lambda: (
        tuple(_sharder().spec((4096, 4096), ["model", "model"])) == ("model", None)),
    "candidate_order_first_fit": lambda: (
        tuple(_sharder(fsdp=True, fsdp_axes=("data",)).spec((1024, 512), [["fsdp"], "model"]))
        == ("data", "model")
        and tuple(_sharder(fsdp=True, fsdp_axes=("data",)).spec((1023, 512),
                                                                [["fsdp"], "model"]))
        == (None, "model")),
    "missing_mesh_axes_ignored": lambda: (
        Sharder(_FakeMesh({"data": 4, "model": 2}), ShardingPlan(batch_axes=("pod", "data")))
        .spec((8, 16), ["batch", "model"])[0] == "data"),
    "seq_shard_gating": lambda: (
        _sharder(seq_shard=True).spec((16, 4096, 512), ["batch", "seq", None])[1] == "model"
        and _sharder(seq_shard=False).spec((16, 4096, 512), ["batch", "seq", None])[1] is None),
}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_rule_cases_twin_the_reference(case):
    assert RULE_CASES[case]()


def test_constrain_refuses_a_plain_tensor():
    with pytest.raises(TypeError, match="DTensor"):
        _sharder().constrain(torch.zeros(4, 4), ["batch", None])


def test_placements_refuse_a_tuple_against_the_mesh_order():
    sh = Sharder(_FakeMesh({"pod": 2, "data": 16, "model": 16}), ShardingPlan())
    assert sh.spec((64, 8), [[("data", "pod")], None])[0] == ("data", "pod")
    with pytest.raises(ValueError, match="axis order"):
        sh.spec_placements(PartitionSpec(("data", "pod"), None))
    assert [str(p) for p in sh.spec_placements(PartitionSpec(("pod", "data"), "model"))] == \
        ["S(0)", "S(0)", "S(1)"]


# -- every leaf's spec equals the reference's ----------------------------------------


def _ref_flat(tree):
    return [(jax.tree_util.keystr(p), tuple(leaf.shape))
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _cases():
    return [(a, c.name) for a in ARCH_IDS for c in SHAPE_CELLS]


@pytest.mark.parametrize("arch,cell", _cases())
def test_every_param_and_cache_spec_equals_the_reference(arch, cell):
    c = shape_cell(cell)
    cfg, jcfg = plans.tuned_config(arch, c), ref_plans.tuned_config(arch, c)
    m, jm = build_model(cfg, device="meta"), jax_build(jcfg)
    window = cfg.ssm.attn_window if cfg.ssm is not None else None
    jparams = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    jcache = jax.eval_shape(lambda: jm.init_cache(c.global_batch, c.seq_len, window=window))
    from repro_torch.models.counting import _shapes_for

    params = _shapes_for(cfg)
    cache = m.init_cache(c.global_batch, c.seq_len, window=window)
    assert [s for _, s in _ref_flat(jparams)] == [tuple(t.shape) for t in tree_leaves(params)]
    assert [s for _, s in _ref_flat(jcache)] == [tuple(t.shape) for t in tree_leaves(cache)]
    for mesh_name, shape in MESHES.items():
        mesh = _FakeMesh(shape)
        multi = "pod" in shape
        plan = plans.plan_for(arch, c, multi_pod=multi)
        ref = RefSharder(mesh, ref_plans.plan_for(arch, c, multi_pod=multi))
        sh = Sharder(mesh, plan)
        for tree, jtree, rules, jrules in (
                (params, jparams, m.param_rules(), jm.param_rules()),
                (cache, jcache, m.cache_rules(), jm.cache_rules())):
            got = _specs_in_order(sh, tree, rules)
            want = _specs_in_order_ref(ref, jtree, jrules)
            assert got == want, (mesh_name, arch, cell)
            for spec in got:
                sh.spec_placements(spec)   # no tuple against the mesh order
                for entry in spec:
                    axes = spec_axes(entry)
                    idx = [mesh_axes(mesh).index(a) for a in axes]
                    assert idx == sorted(idx), (spec, mesh_name)


def _specs_in_order(sharder, tree, rules):
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _specs_in_order(sharder, tree[k], rules[k])]
    if isinstance(tree, (tuple, list)):
        return [s for t, r in zip(tree, rules) for s in _specs_in_order(sharder, t, r)]
    return [tuple(sharder.spec(tuple(tree.shape), rules))]


def _specs_in_order_ref(sharder, tree, rules):
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _specs_in_order_ref(sharder, tree[k], rules[k])]
    if isinstance(tree, (tuple, list)):
        return [s for t, r in zip(tree, rules) for s in _specs_in_order_ref(sharder, t, r)]
    return [tuple(sharder.spec(tree.shape, rules))]


@pytest.mark.parametrize("ep", [True, False], ids=["ep", "tp_in_expert"])
def test_expert_specs_equal_the_reference(ep):
    from repro.models.config import MoEConfig as RefMoE
    from repro_torch.models.config import MoEConfig

    kw = dict(num_experts=64, top_k=8, d_ff_expert=1024, expert_parallel=ep)
    assert expert_specs(None, MoEConfig(**kw)) == ref_expert_specs(None, RefMoE(**kw))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plans_equal_the_reference(arch):
    for c in SHAPE_CELLS:
        for multi in (False, True):
            assert dataclasses.asdict(plans.plan_for(arch, c, multi_pod=multi)) == \
                dataclasses.asdict(ref_plans.plan_for(arch, c, multi_pod=multi))
        assert dataclasses.asdict(plans.tuned_config(arch, c)) == \
            dataclasses.asdict(ref_plans.tuned_config(arch, c))
    assert plans.opt_state_dtype(arch) == ref_plans.opt_state_dtype(arch)
    assert dataclasses.asdict(ShardingPlan()) == dataclasses.asdict(RefPlan())


# -- roofline and device table -----------------------------------------------------


def test_roofline_terms_on_the_h100():
    from repro_torch.launch.op_analysis import OpCost

    cost = OpCost(flops=989e12, hbm_bytes=1e12, collective_bytes=45e9,
                  collective_by_op={"all-reduce": 45e9})
    r = R.build_report("a", "train_4k", "m", 4, cost, model_flops=2 * 989e12,
                       memory_stats={}, analytic_bytes=3.35e12)
    assert r.t_compute == pytest.approx(1.0) and r.t_memory == pytest.approx(1.0)
    assert r.t_collective == pytest.approx(0.1) and r.t_bound == pytest.approx(1.0)
    assert r.useful_ratio == pytest.approx(0.5)
    assert r.roofline_fraction == pytest.approx(0.5)
    assert r.hbm_bytes_op_ub == 1e12 and "H100" in r.card
    assert (R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW, R.HBM_BYTES) == (989e12, 3.35e12, 450e9, 80e9)
    d = r.to_dict()
    assert d["bottleneck"] in ("compute", "memory") and d["t_bound"] == pytest.approx(1.0)


def test_analytic_memory_counts_the_shards():
    cfg = plans.tuned_config("internlm2-20b", shape_cell("decode_32k"))
    mesh = _FakeMesh({"data": 16, "model": 16})
    plan = plans.plan_for("internlm2-20b", shape_cell("decode_32k"))
    b = R.analytic_memory_bytes(cfg, shape_cell("decode_32k"), mesh, plan,
                                param_bytes=100, opt_bytes=0, cache_bytes=10)
    # decode: params + cache + the logits of 8 local sequences, vocab over 16
    assert b == 110 + 8 * 1 * (cfg.vocab_size / 16) * 4


def test_device_table_lower_gives_specs_and_costs():
    table = DeviceHandlerTable()
    table.register("a/mm", lambda p: {"y": p["x"] @ p["w"]})
    table.register("b/copy", lambda p: {"y": p["x"][:, :16] * 2})
    low = table.lower({"x": ((8, 32), torch.float32), "w": ((32, 16), torch.float32)},
                      key_spec=((), torch.int32))
    assert low.result_spec[1] == [((8, 16), torch.float32)]
    assert low.branch_costs["a/mm"].flops == 2 * 8 * 32 * 16
    assert low.cost is low.branch_costs["a/mm"]
    bad = DeviceHandlerTable()
    bad.register("a", lambda p: {"y": p["x"]})
    bad.register("b", lambda p: {"y": p["x"].double()})
    with pytest.raises(RegistryError):
        bad.lower({"x": ((2, 2), torch.float32)})


# -- the dry-run's twin in a fresh interpreter ----------------------------------------


_SMALL_DRYRUN = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {src!r})
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_mesh
    from repro_torch.launch.op_analysis import analyze
    from repro_torch.launch.roofline import tree_shard_bytes
    from repro_torch.models.api import build_model
    from repro_torch.models.config import ShapeCell, ShardingPlan
    from repro_torch.models.sharding import Sharder

    fake_world(8)
    cfg = get_reduced("internlm2-20b")
    cell = ShapeCell("small_train", "train", 32, 8)
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    sharder = Sharder(mesh, ShardingPlan(batch_axes=("pod", "data")))
    model = build_model(cfg, device="meta")
    args, donate = dryrun.shardings_for(model, sharder, cell, "float32")
    arg_bytes = tree_shard_bytes(args)
    step = dryrun.step_for(model, sharder, cell, "float32")
    _, cost = analyze(step, *args)
    reps = cost.repeats("layer_apply")

    def local(t):
        return t.to_local() if hasattr(t, "to_local") else t

    def raises(fn):
        try:
            fn()
        except NotImplementedError as e:
            return str(e)
        return None

    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    def dt(shape, pl):
        return distribute_tensor(torch.empty(shape, device="meta"), mesh, pl,
                                 src_data_rank=None)
    q = dt((8, 16, 4, 32), [Replicate(), Shard(3)])
    kv = dt((8, 16, 2, 32), [Replicate(), Replicate()])
    x = dt((1, 4, 8, 32), [Replicate(), Replicate()])
    w = dt((4, 32, 16), [Shard(1), Replicate()])
    print(json.dumps({{
        "flops": cost.flops,
        "coll": cost.collective_bytes,
        "coll_by_op": cost.collective_by_op,
        "loops": cost.loops,
        "repeats": sorted(set(reps.values())),
        "not_per_layer": [k for k, v in reps.items() if v % cfg.num_layers],
        "arg_bytes": arg_bytes,
        "arg_bytes_by_leaf": sum(local(t).numel() * local(t).element_size()
                                 for a in args for t in torch.utils._pytree.tree_leaves(a)),
        "local_param_shape": list(args[0]["layers"]["mlp"]["w_up"].to_local().shape),
        "flash_head_dim_split": raises(lambda: ops.flash_attention_bhsd(q, kv, kv)),
        "gmm_contraction_split": raises(lambda: ops.grouped_matmul(x, w)),
    }}))
""")


@pytest.fixture(scope="module")
def small_dryrun():
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
    out = subprocess.run([sys.executable, "-c", _SMALL_DRYRUN.format(src=src)],
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_small_mesh_dryrun_counts_flops_and_the_gradient_sync(small_dryrun):
    assert small_dryrun["flops"] > 0
    assert small_dryrun["coll"] > 0      # the data-parallel gradient sync appears
    assert small_dryrun["coll_by_op"]


def test_small_mesh_dryrun_repeats_each_layer_site_per_layer(small_dryrun):
    layers = 2   # reduced internlm2-20b, no remat: one forward call per layer
    assert small_dryrun["loops"] == [["layer_apply", layers]]
    assert layers in small_dryrun["repeats"]
    # every layer site repeats once a layer, but the RoPE frequencies' copy
    # to the device, which is cached after the first layer
    assert small_dryrun["not_per_layer"] == ["layer_apply::_to_copy::[(4,)]"]


def test_small_mesh_dryrun_argument_bytes_are_the_shards(small_dryrun):
    assert small_dryrun["arg_bytes"] == small_dryrun["arg_bytes_by_leaf"] > 0
    # w_up (L, d 64, f 128): f over the 2-way model axis
    assert small_dryrun["local_param_shape"] == [2, 64, 64]


@pytest.mark.parametrize("case,kernel", [("flash_head_dim_split", "flash_attention"),
                                         ("gmm_contraction_split", "grouped_matmul")])
def test_kernel_wrappers_refuse_a_split_reduced_dim(small_dryrun, case, kernel):
    assert small_dryrun[case] is not None and small_dryrun[case].startswith(kernel)


_HAND_COUNT = textwrap.dedent("""
    import dataclasses, json, sys
    sys.path.insert(0, {src!r})
    from repro_torch.configs import get_reduced
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_mesh
    from repro_torch.launch.op_analysis import analyze, matmul_flops
    from repro_torch.models.api import build_model
    from repro_torch.models.config import ShapeCell, ShardingPlan
    from repro_torch.models.sharding import Sharder

    fake_world(1)
    sharder = Sharder(make_mesh((1, 1), ("data", "model"), device="cpu"), ShardingPlan())
    cell = ShapeCell("small_train", "train", 32, 8)
    out = {{}}
    for remat in ("none", "full"):
        cfg = dataclasses.replace(get_reduced("internlm2-20b"), remat=remat)
        model = build_model(cfg, device="meta")
        args, _ = dryrun.shardings_for(model, sharder, cell, "float32")
        _, cost = analyze(dryrun.step_for(model, sharder, cell, "float32"), *args)
        bmm = sum(f for _, f, d in cost.sites if d.split("::")[1] == "bmm")
        out[remat] = {{"matmul": matmul_flops(cost), "bmm": bmm}}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def hand_count():
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
    out = subprocess.run([sys.executable, "-c", _HAND_COUNT.format(src=src)],
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("remat", ["none", "full"])
def test_dryrun_train_flops_equal_a_hand_count(hand_count, remat):
    """A train step's counted matmul flops on a 1 x 1 fake mesh, against a
    hand count: 2 flops a weight a token forward, 4 backward, 2 more for a
    full remat's recompute (which stops before the MLP's down projection,
    whose output the backward does not need: torch's checkpoint stops
    early), 6 for the untied head; the plain attention's QK^T and PV
    products, 4 B S^2 H hd a pass, over the forward, the recompute and the
    backward's two passes."""
    from repro_torch.configs import get_reduced

    cfg = get_reduced("internlm2-20b")
    S, B = 32, 8
    T, d, f, V = B * S, cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    hd = cfg.head_dim or d // H
    assert cfg.mlp == "swiglu" and not cfg.tie_embeddings and not cfg.qkv_bias
    weights = d * H * hd + 2 * d * Hkv * hd + H * hd * d + 3 * d * f
    per_pass = 4 * B * S * S * H * hd
    full = remat == "full"
    linear = cfg.num_layers * (6 * weights * T + full * (2 * weights * T - 2 * T * f * d))
    attention = cfg.num_layers * (3 + full) * per_pass
    got = hand_count[remat]
    assert got["bmm"] == attention
    assert got["matmul"] == linear + attention + 6 * V * d * T


_ONE_RANK = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {src!r})
    import numpy as np
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import make_mesh, single_rank_world
    from repro_torch.launch.plans import plan_for
    from repro_torch.models.api import batch_rules, build_model
    from repro_torch.models.config import ShapeCell
    from repro_torch.models.sharding import Sharder
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.step import value_and_grad

    single_rank_world("cpu")
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    cfg = get_reduced("internlm2-20b")
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    rng = np.random.default_rng(5)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))).long()
    batch = {{"tokens": tok, "labels": torch.roll(tok, -1, dims=1)}}
    loss, _, grads = value_and_grad(model, params, batch)
    sh = Sharder(mesh, plan_for("internlm2-20b", ShapeCell("t", "train", 16, 4)))
    sloss, _, sgrads = value_and_grad(
        model, sh.distribute(params, model.param_rules()),
        {{k: sh.distribute(v, batch_rules(k)) for k, v in batch.items()}}, sh)
    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
    print(json.dumps({{
        "loss_equal": bool(torch.equal(full(sloss), loss)),
        "grads": len(tree_leaves(grads)),
        "grads_equal": sum(bool(torch.equal(full(g), r))
                           for g, r in zip(tree_leaves(sgrads), tree_leaves(grads))),
    }}))
""")


def test_one_rank_mesh_train_step_is_the_unsharded_one_bit_for_bit():
    """On a 1 x 1 gloo mesh under the train plan (vocab over the one-rank
    model axis), the sharded step runs the vocab-parallel cross-entropy and
    gives the unsharded step's loss and every gradient bit for bit."""
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
    out = subprocess.run([sys.executable, "-c", _ONE_RANK.format(src=src)],
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["loss_equal"]
    assert got["grads_equal"] == got["grads"] > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_lse_equals_the_logsumexp_of_the_scores(dtype):
    """The decode wrappers' ``lse=`` output (what a sequence-split cache's
    shards merge by), on the CPU's plain path, against ``jax.nn.logsumexp``
    of the scaled, masked scores; the attention output is unchanged."""
    import numpy as np

    from repro_torch.kernels import ops

    rng = np.random.default_rng(3)
    B, S, Hkv, qpk, d = 3, 40, 2, 4, 32
    dt = getattr(torch, dtype)
    q = torch.from_numpy(rng.standard_normal((B, 1, Hkv * qpk, d), np.float32)).to(dt)
    k = torch.from_numpy(rng.standard_normal((B, S, Hkv, d), np.float32)).to(dt)
    v = torch.from_numpy(rng.standard_normal((B, S, Hkv, d), np.float32)).to(dt)
    lengths = torch.tensor([1, 17, 40], dtype=torch.int32)
    lse = torch.empty((B, Hkv * qpk), dtype=torch.float32)
    out = ops.decode_attention_bhsd(q, k, v, lengths, lse=lse)
    assert torch.equal(out, ops.decode_attention_bhsd(q, k, v, lengths))
    qn, kn = q.float().numpy()[:, 0], k.float().numpy()
    kk = np.repeat(kn, qpk, axis=2)                                  # (B, S, H, d)
    s = np.einsum("bhd,bshd->bhs", qn, kk) / np.sqrt(d)
    s = np.where(np.arange(S)[None, None] < lengths.numpy()[:, None, None], s, -np.inf)
    want = np.asarray(jax.nn.logsumexp(s, axis=-1))
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)
