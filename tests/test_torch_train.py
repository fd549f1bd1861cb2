"""The port's training substrate against the reference's, on the CPU.

* port twins of every case of ``tests/test_train.py`` (loss decreases,
  checkpoint restart, compressed step, EF compression, the wire round trip
  of ``CompressedTensor``, heartbeat, straggler, elastic fleet, the trainer
  over HAM, data determinism, store GC), and an async checkpoint that
  in-place optimizer steps after ``save`` must not change;
* for every reduced config, ``Model.loss`` and the gradient of every param
  leaf against ``jax.value_and_grad`` of the reference's loss on the same
  params (``params_from_numpy``) and batch, float32;
* one AdamW step against ``repro.optim.adamw.update``; a 5-step ``Trainer``
  run from the same params and batches against the reference ``Trainer``;
* ``count_params``/``count_active_params`` for all ten full configs;
* checkpoints restored across packages, both ways; batches bit for bit.

Tolerances (float32): loss 1e-5 relative; a gradient leaf within
2e-4 x its largest magnitude (+1e-7), since autograd and XLA sum the
same products in other orders and a leaf's small entries carry the
absolute error of its large ones; AdamW params 1e-6 absolute (one step of
at most lr 1e-3 apart from float32 rounding of the moments); per-step
trainer losses 1e-4 relative (five steps compound the gradients'
reassociation).
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.store import CheckpointStore as RefStore
from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticTokens as RefTokens
from repro.data.pipeline import batch_for_model as ref_batch_for_model
from repro.models.api import build_model as jax_build
from repro.models.counting import count_active_params as ref_active
from repro.models.counting import count_params as ref_count
from repro.optim import adamw as ref_adamw
from repro.train.loop import Trainer as RefTrainer
from repro_torch.ckpt.store import CheckpointStore
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.core.closure import f2f
from repro_torch.core.errors import KeyMapMismatchError
from repro_torch.core.registry import HandlerRegistry
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, as_tensors, batch_for_model
from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.counting import count_active_params, count_params
from repro_torch.offload.api import OffloadDomain
from repro_torch.offload.runtime import register_internal_handlers
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves
from repro_torch.optim.compression import (
    CompressedTensor,
    ef_compress_tree,
    ef_decompress_tree,
    ef_init,
)
from repro_torch.train.ft import ElasticFleet, HeartbeatMonitor, StragglerDetector
from repro_torch.train.loop import Trainer
from repro_torch.train.step import build_compressed_train_step, build_eval_step, value_and_grad

GRAD_RTOL = 2e-4
LOSS_RTOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


# -- twins of tests/test_train.py ----------------------------------------------


def test_loss_decreases(tmp_path):
    cfg = get_reduced("internlm2-20b")
    tr = Trainer(cfg, adamw.AdamWConfig(lr=1e-3, warmup_steps=5),
                 global_batch=8, seq_len=32, device="cpu")
    tr.init()
    first = tr.run_steps(3)["loss"]
    later = tr.run_steps(15)["loss"]
    assert later < first


def test_checkpoint_restart_bit_exact(tmp_path):
    cfg = get_reduced("qwen1.5-4b")
    kw = dict(ckpt_dir=str(tmp_path), ckpt_every=4, global_batch=4, seq_len=16, device="cpu")
    a = Trainer(cfg, adamw.AdamWConfig(lr=1e-3), **kw)
    a.init()
    a.run_steps(6)
    a.checkpoint(blocking=True)
    b = Trainer(cfg, adamw.AdamWConfig(lr=1e-3), **kw)
    assert b.maybe_restore() and b.step == a.step
    ma, mb = a.run_steps(3), b.run_steps(3)
    assert ma["loss"] == pytest.approx(mb["loss"], abs=1e-6)


def test_compressed_train_step_converges():
    cfg = get_reduced("llama3-405b")
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    opt = adamw.init(params)
    residual = ef_init(params)
    step = build_compressed_train_step(model, adamw.AdamWConfig(lr=1e-3, warmup_steps=5))
    src = SyntheticTokens(DataConfig(cfg.vocab_size, 32, 8))
    losses = []
    for i in range(12):
        params, opt, residual, m = step(params, opt, residual, as_tensors(src.batch(i), "cpu"))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses


def test_ef_compression_error_feedback():
    g = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal((64,)).astype(np.float32))}
    res = ef_init(g)
    q, res = ef_compress_tree(g, res)
    deq = ef_decompress_tree(q)
    # the residual captures the quantisation error exactly
    np.testing.assert_allclose((deq["w"] + res["w"]).numpy(), g["w"].numpy(), atol=1e-6)


def test_compressed_tensor_wire_roundtrip():
    x = np.random.default_rng(1).standard_normal((32, 8)).astype(np.float32)
    ct = CompressedTensor.compress(x)
    out = CompressedTensor.decode(ct.encode())
    np.testing.assert_allclose(out.decompress(), x, atol=ct.scale)
    assert len(ct.encode()) < x.nbytes / 3  # ~4x smaller


def _domain(n=3):
    reg = HandlerRegistry()
    register_internal_handlers(reg)
    reg.init()
    return OffloadDomain.local(n, registry=reg)


def test_heartbeat_detects_dead_node():
    dom = _domain(3)
    failures = []
    mon = HeartbeatMonitor(dom, [1, 2], interval=0.05, timeout=0.4,
                           on_failure=failures.append).start()
    try:
        time.sleep(0.3)
        assert mon.alive() == [1, 2]
        dom._local_workers[0].stop()  # kill node 1's event loop
        deadline = time.monotonic() + 5
        while not failures and time.monotonic() < deadline:
            time.sleep(0.05)
        assert failures == [1]
        assert mon.alive() == [2]
    finally:
        mon.stop()
        dom.shutdown()


def test_straggler_detection():
    det = StragglerDetector(factor=1.5)
    for _ in range(8):
        det.record(0, 0.10)
        det.record(1, 0.11)
        det.record(2, 0.45)
    assert det.stragglers() == [2]


def test_elastic_fleet_reshard_and_admit():
    dom = _domain(4)
    try:
        fleet = ElasticFleet(dom, [1, 2, 3])
        assert fleet.shard_of(2) == (1, 3)
        assert fleet.remove(2) == {1: (0, 2), 3: (1, 2)}
        fleet.admit(2, dom.registry.table.digest.hex())
        assert fleet.shard_of(2) == (1, 3)
        with pytest.raises(KeyMapMismatchError):
            fleet.admit(5, "00" * 32)
    finally:
        dom.shutdown()


def test_trainer_controllable_over_ham():
    """The paper's mechanism driving training: run/metrics/step as RPCs."""
    reg = HandlerRegistry()
    register_internal_handlers(reg)
    cfg = get_reduced("olmoe-1b-7b")
    tr = Trainer(cfg, adamw.AdamWConfig(lr=1e-3), global_batch=4, seq_len=16, device="cpu")
    tr.register_handlers(reg)
    reg.init()
    dom = OffloadDomain.local(2, registry=reg)
    try:
        out = dom.sync(1, f2f("train/run_steps", 3, registry=reg), timeout=120)
        assert out["step"] == 3
        m = dom.sync(1, f2f("train/metrics", registry=reg))
        assert m["step"] == 3 and "loss" in m
        assert dom.sync(1, f2f("train/step", registry=reg)) == 3
    finally:
        dom.shutdown()


def test_data_pipeline_determinism_and_sharding():
    cfg = DataConfig(vocab_size=101, seq_len=16, global_batch=8, seed=3)
    a = SyntheticTokens(cfg, shard=0, num_shards=2)
    b = SyntheticTokens(cfg, shard=1, num_shards=2)
    a2 = SyntheticTokens(cfg, shard=0, num_shards=2)
    np.testing.assert_array_equal(a.batch(5)["tokens"], a2.batch(5)["tokens"])
    assert not np.array_equal(a.batch(5)["tokens"], b.batch(5)["tokens"])
    assert a.batch(5)["tokens"].shape == (4, 16)
    ba = a.batch(7)
    assert ba["tokens"].shape == ba["labels"].shape


def test_ckpt_store_gc_and_manifest(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    tree = {"a": torch.arange(5), "b": {"c": torch.ones((2, 2))}}
    for s in (1, 2, 3):
        store.save(s, tree, meta={"arch": "t"}, blocking=True)
    assert store.list_steps() == [2, 3]  # gc kept the last 2
    man = store.manifest(3)
    assert man["arch"] == "t" and man["step"] == 3
    out = store.restore(3, tree)
    assert torch.equal(out["a"], tree["a"]) and torch.equal(out["b"]["c"], tree["b"]["c"])


def _hold_writer(monkeypatch):
    """Make the store's writer thread wait at its first ``np.save`` until the
    returned event is set, so a test can change the tree mid-save."""
    import repro_torch.ckpt.store as store_mod

    release, save = threading.Event(), np.save

    def held_save(*args, **kw):
        assert release.wait(30), "the test never released the writer"
        return save(*args, **kw)

    monkeypatch.setattr(store_mod.np, "save", held_save)
    return release


def test_async_save_keeps_the_values_at_save_time(tmp_path, monkeypatch):
    store = CheckpointStore(str(tmp_path))
    tree = {"w": torch.arange(6, dtype=torch.float32), "m": torch.ones(3, dtype=torch.bfloat16),
            "n": np.arange(4.0)}
    before = {k: v.clone() if isinstance(v, torch.Tensor) else v.copy() for k, v in tree.items()}
    release = _hold_writer(monkeypatch)
    store.save(1, tree)
    with torch.no_grad():   # what adamw.update does to params and moments
        tree["w"].mul_(-3.0)
        tree["m"].add_(5.0)
    tree["n"] *= -2.0
    release.set()
    store.wait()
    out = store.restore(1, tree)
    for k in ("w", "m"):
        assert torch.equal(out[k], before[k])
    np.testing.assert_array_equal(out["n"], before["n"])


def test_trainer_async_checkpoint_is_the_step_it_names(tmp_path, monkeypatch):
    """``run_steps`` saves step 4 on the writer thread and steps on; the
    checkpoint must hold step 4's params and moments, not later ones."""
    cfg = get_reduced("qwen1.5-4b")
    kw = dict(global_batch=2, seq_len=16, device="cpu")
    ref = Trainer(cfg, adamw.AdamWConfig(lr=1e-3), **kw)
    ref.init()
    ref.run_steps(4)
    a = Trainer(cfg, adamw.AdamWConfig(lr=1e-3), ckpt_dir=str(tmp_path), ckpt_every=4, **kw)
    a.init()
    release = _hold_writer(monkeypatch)
    a.run_steps(6)   # the save of step 4 is held while steps 5 and 6 run
    release.set()
    a.store.wait()
    got = a.store.restore(4, {"params": a.params, "opt": a.opt_state})
    want = {"params": ref.params, "opt": ref.opt_state}
    assert len(tree_leaves(got)) == len(tree_leaves(want))
    for x, y in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(x, y)


# -- the port held to the reference ----------------------------------------------


def _batch(cfg, B=2, S=16, step=0):
    src = SyntheticTokens(DataConfig(cfg.vocab_size, S, B, seed=1))
    return batch_for_model(src, cfg, step)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_every_gradient_match_the_reference(arch):
    jcfg, cfg = jax_reduced(arch), get_reduced(arch)
    jm, m = jax_build(jcfg), build_model(cfg, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    p = params_from_numpy(_np(jp), cfg, "cpu")
    nb = _batch(cfg)
    (jloss, jmet), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in nb.items()})
    loss, met, grads = value_and_grad(m, p, as_tensors(nb, "cpu"))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(met["aux"]), float(jmet["aux"]), rtol=1e-4, atol=1e-7)
    flat, _ = jax.tree_util.tree_flatten_with_path(_np(jgrads))
    assert len(flat) == len(tree_leaves(grads))
    for path, ref in flat:
        got = _leaf(grads, path).numpy()
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(got, ref, rtol=0, atol=GRAD_RTOL * scale + 1e-7,
                                   err_msg=jax.tree_util.keystr(path))
        if scale > 0:
            assert np.abs(got).max() > 0, jax.tree_util.keystr(path)


@pytest.mark.parametrize("arch", ["internvl2-76b", "olmoe-1b-7b"])
def test_lm_loss_matches_the_reference(arch):
    """``transformer.lm_loss``: the vision prefix's labels masked, the MoE
    aux term added, against the reference's ``lm_loss``."""
    from repro.models import transformer as JT
    from repro_torch.models import transformer as T

    jcfg, cfg = jax_reduced(arch), get_reduced(arch)
    jp = jax_build(jcfg).init(jax.random.PRNGKey(1))
    nb = _batch(cfg, step=2)
    jloss, jmet = JT.lm_loss(jp, {k: jnp.asarray(v) for k, v in nb.items()}, jcfg)
    loss, met = T.lm_loss(params_from_numpy(_np(jp), cfg, "cpu"), as_tensors(nb, "cpu"), cfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(met["ce"]), float(jmet["ce"]), rtol=LOSS_RTOL)


def test_eval_step_records_no_graph():
    cfg = get_reduced("internlm2-20b")
    m = build_model(cfg, device="cpu")
    p = m.init(0)
    for leaf in tree_leaves(p):
        leaf.requires_grad_(True)
    out = build_eval_step(m)(p, as_tensors(_batch(cfg), "cpu"))
    assert not out["loss"].requires_grad and np.isfinite(float(out["loss"]))


def test_adamw_step_matches_the_reference():
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 2)}}
    mk = lambda s: rng.standard_normal(s).astype(np.float32)
    params = jax.tree_util.tree_map(mk, shapes, is_leaf=lambda x: isinstance(x, tuple))
    grads = jax.tree_util.tree_map(mk, shapes, is_leaf=lambda x: isinstance(x, tuple))
    cfg = dict(lr=1e-3, warmup_steps=2, grad_clip=1.0)
    jp, jo = params, ref_adamw.init(params)
    tp = jax.tree_util.tree_map(torch.from_numpy, params)
    tg = jax.tree_util.tree_map(torch.from_numpy, grads)
    to = adamw.init(tp)
    for _ in range(3):
        jp, jo, jmet = ref_adamw.update(ref_adamw.AdamWConfig(**cfg), jp, jo, grads)
        tp, to, tmet = adamw.update(adamw.AdamWConfig(**cfg), tp, to, tg)
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]), rtol=1e-7)
    assert int(to["step"]) == int(jo["step"]) == 3
    flat, _ = jax.tree_util.tree_flatten_with_path(_np(jp))
    for path, ref in flat:
        np.testing.assert_allclose(_leaf(tp, path).numpy(), ref, atol=1e-6)
    for name in ("mu", "nu"):
        flat, _ = jax.tree_util.tree_flatten_with_path(_np(jo[name]))
        for path, ref in flat:
            np.testing.assert_allclose(_leaf(to[name], path).numpy(), ref, rtol=1e-5,
                                       atol=1e-9)


@pytest.mark.parametrize("arch", ["internlm2-20b", "olmoe-1b-7b"])
def test_trainer_losses_match_the_reference(arch):
    kw = dict(global_batch=4, seq_len=16, data_seed=2)
    opt = dict(lr=1e-3, warmup_steps=2)
    ref = RefTrainer(jax_reduced(arch), ref_adamw.AdamWConfig(**opt), **kw)
    ref.init(0)
    tr = Trainer(get_reduced(arch), adamw.AdamWConfig(**opt), device="cpu", **kw)
    tr.params = params_from_numpy(_np(ref.params), tr.cfg, "cpu")
    tr.opt_state = adamw.init(tr.params)
    ref.run_steps(5)
    tr.run_steps(5)
    want = [h["loss"] for h in ref.metrics_history]
    got = [h["loss"] for h in tr.metrics_history]
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_equal_the_reference(arch):
    jcfg, cfg = jax_config(arch), get_config(arch)
    assert count_params(cfg) == ref_count(jcfg) == cfg.param_count()
    assert count_active_params(cfg) == ref_active(jcfg) == cfg.active_param_count()


def _train_tree(arch, seed=0):
    jm = jax_build(jax_reduced(arch))
    jp = jm.init(jax.random.PRNGKey(seed))
    return {"params": jp, "opt": ref_adamw.init(jp)}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_restores_across_packages(tmp_path, writer):
    arch = "olmoe-1b-7b"
    cfg = get_reduced(arch)
    jtree = _train_tree(arch)
    jtree["opt"]["step"] = jnp.asarray(7, jnp.int32)
    ttree = {"params": params_from_numpy(_np(jtree["params"]), cfg, "cpu"),
             "opt": {"mu": params_from_numpy(_np(jtree["opt"]["mu"]), cfg, "cpu"),
                     "nu": params_from_numpy(_np(jtree["opt"]["nu"]), cfg, "cpu"),
                     "step": torch.tensor(7, dtype=torch.int32)}}
    if writer == "reference":
        RefStore(str(tmp_path)).save(3, jtree, meta={"arch": arch}, blocking=True)
        template = {"params": build_model(cfg, device="cpu").init(5),
                    "opt": adamw.init(ttree["params"])}
        out = CheckpointStore(str(tmp_path)).restore(3, template)
        assert int(out["opt"]["step"]) == 7 and out["opt"]["step"].dtype == torch.int32
        flat, _ = jax.tree_util.tree_flatten_with_path(_np(jtree))
        for path, ref in flat:
            np.testing.assert_array_equal(_leaf(out, path).numpy(), ref)
    else:
        CheckpointStore(str(tmp_path)).save(3, ttree, meta={"arch": arch}, blocking=True)
        template = _train_tree(arch, seed=5)
        out = RefStore(str(tmp_path)).restore(3, template)
        assert int(out["opt"]["step"]) == 7
        flat, _ = jax.tree_util.tree_flatten_with_path(out)
        for path, got in flat:
            np.testing.assert_array_equal(np.asarray(got), _leaf(ttree, path).numpy())
    assert (CheckpointStore(str(tmp_path)).manifest(3)["leaves"]
            == RefStore(str(tmp_path)).manifest(3)["leaves"])


def test_manifest_leaf_paths_equal_the_reference(tmp_path):
    arch = "internlm2-20b"
    jtree = _train_tree(arch)
    cfg = get_reduced(arch)
    tp = build_model(cfg, device="cpu").init(0)
    RefStore(str(tmp_path / "ref")).save(1, jtree, blocking=True)
    CheckpointStore(str(tmp_path / "port")).save(1, {"params": tp, "opt": adamw.init(tp)},
                                                 blocking=True)
    ref = RefStore(str(tmp_path / "ref")).manifest(1)["leaves"]
    port = CheckpointStore(str(tmp_path / "port")).manifest(1)["leaves"]
    assert [(e["path"], e["shape"], e["dtype"]) for e in port] == \
        [(e["path"], e["shape"], e["dtype"]) for e in ref]


@pytest.mark.parametrize("arch", ["internvl2-76b", "whisper-large-v3", "olmoe-1b-7b"])
def test_batches_equal_the_reference_bit_for_bit(arch):
    for shard in (0, 1):
        ours = batch_for_model(SyntheticTokens(DataConfig(97, 12, 4, seed=5), shard, 2),
                               get_reduced(arch), 3)
        ref = ref_batch_for_model(RefTokens(RefDataConfig(97, 12, 4, seed=5), shard, 2),
                                  jax_reduced(arch), 3)
        assert ours.keys() == ref.keys()
        for k in ours:
            assert ours[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(ours[k], ref[k])


def test_ef_compression_matches_the_reference():
    from repro.optim.compression import ef_compress_tree as ref_ef

    rng = np.random.default_rng(3)
    g = {"w": rng.standard_normal((33,)).astype(np.float32),
         "b": {"x": rng.standard_normal((4, 5)).astype(np.float32)}}
    r = {"w": rng.standard_normal((33,)).astype(np.float32) * 0.01,
         "b": {"x": rng.standard_normal((4, 5)).astype(np.float32) * 0.01}}
    jq, jr = ref_ef(g, r)
    tq, tr = ef_compress_tree(jax.tree_util.tree_map(torch.from_numpy, g),
                              jax.tree_util.tree_map(torch.from_numpy, r))
    for path, ref in jax.tree_util.tree_flatten_with_path(_np(jr))[0]:
        np.testing.assert_allclose(_leaf(tr, path).numpy(), ref, atol=1e-7)
    for name in ("w",):
        np.testing.assert_array_equal(tq[name][0].numpy(), np.asarray(jq[name][0]))
        np.testing.assert_allclose(float(tq[name][1]), float(jq[name][1]), rtol=1e-7)


def test_trainer_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(get_reduced("internlm2-20b"))
