"""The port's sharded path with real numerics: 4 gloo processes on a (2, 2)
("data", "model") mesh against the unsharded port, within 1e-5.

* reduced internlm2-20b: the loss and every gradient of one train step
  under the train plan (FSDP over data, heads and vocab over model); the
  prefill logits and 4 greedy decode steps over a KV cache whose
  *sequence* is split over the model axis (kv heads 2 do not divide the
  rules' 16-way axis), so every step merges the shards' attention by their
  rows' log-sum-exp;
* reduced olmoe-1b-7b: prefill + decode logits with the experts split over
  the model axis (EP) and with their ``f`` split (TP-in-expert, whose down
  projection sums partial products across ranks);
* reduced zamba2-2.7b: one step's loss.

The losses are also held against ``repro``'s within 1e-4.  The workers are
this file run as a script, each a fresh interpreter that imports neither
JAX nor ``repro``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

TOL = 1e-5
WORLD = 4


def _gap(a, b) -> float:
    """max |a - b| over max(|b|, 1e-6)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-6))


# -- the worker (one rank) ----------------------------------------------------------


def _worker(rank: int, data_dir: str, out_path: str) -> None:
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.plans import plan_for
    from repro_torch.models.api import batch_rules, build_model
    from repro_torch.models.config import ShapeCell
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.sharding import Sharder
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.step import value_and_grad

    torch.manual_seed(0)
    # a file rendezvous: no port to race other processes for
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(data_dir, 'rdv')}",
                            rank=rank, world_size=WORLD)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    train, serve = ShapeCell("t", "train", 16, 4), ShapeCell("d", "decode", 32, 4)
    out = {}

    def load(arch, cfg):
        z = np.load(os.path.join(data_dir, f"{arch}.npz"))
        flat = {k: z[k] for k in z.files if k.startswith("p/")}
        tree: dict = {}
        for key, arr in flat.items():
            node = tree
            parts = key[2:].split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = arr
        return params_from_numpy(tree, cfg, "cpu"), torch.from_numpy(z["tokens"])

    def full(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def train_case(arch, grads_too):
        cfg = get_reduced(arch)
        m = build_model(cfg, device="cpu")
        p, tok = load(arch, cfg)
        batch = {"tokens": tok, "labels": torch.roll(tok, -1, dims=1)}
        loss, _, grads = value_and_grad(m, p, batch)
        sh = Sharder(mesh, plan_for(arch, train))
        dp = sh.distribute(p, m.param_rules())
        db = {k: sh.distribute(v, batch_rules(k)) for k, v in batch.items()}
        sloss, _, sgrads = value_and_grad(m, dp, db, sh)
        res = {"loss": float(loss), "sharded_loss": float(sloss)}
        if grads_too:
            res["grad_gap"] = max(_gap(full(g).detach().numpy(), r.detach().numpy())
                                  for g, r in zip(tree_leaves(sgrads), tree_leaves(grads)))
            res["grads"] = len(tree_leaves(grads))
        return res

    def decode_case(arch, cfg, steps):
        m = build_model(cfg, device="cpu")
        p, tok = load(arch, cfg)
        S = tok.shape[1]
        sh = Sharder(mesh, plan_for(arch, serve))
        dp = sh.distribute(p, m.param_rules())
        res = {"logit_gap": 0.0, "tokens_equal": True}
        with torch.no_grad():
            logits, cache = m.prefill(p, {"tokens": tok})
            slogits, _ = m.prefill(dp, {"tokens": sh.distribute(tok, ["batch", None])},
                                   sharder=sh)
            res["logit_gap"] = _gap(full(slogits).numpy(), logits.numpy())
            big = m.init_cache(tok.shape[0], serve.seq_len)
            for n in big:
                big[n][:, :, :S] = cache[n]
            ref_cache = {n: v.clone() for n, v in big.items()}
            dcache = sh.distribute(big, m.cache_rules())
            # the stacked cache is (L, B, S, Hkv, hd)
            dims = {1: "batch", 2: "seq", 3: "heads"}
            res["cache_split"] = [dims.get(pl.dim, "none") if pl.is_shard() else "none"
                                  for pl in dcache["k"].placements]
            nxt = logits[:, -1].argmax(-1, keepdim=True)
            for i in range(steps):
                pos = torch.tensor(S + i)
                lg, ref_cache = m.decode_step(p, ref_cache, {"tokens": nxt, "pos": pos})
                slg, dcache = m.decode_step(
                    dp, dcache, {"tokens": sh.distribute(nxt, ["batch", None]), "pos": pos},
                    sharder=sh)
                slg = full(slg)
                res["logit_gap"] = max(res["logit_gap"], _gap(slg.numpy(), lg.numpy()))
                res["tokens_equal"] &= bool((slg.argmax(-1) == lg.argmax(-1)).all())
                nxt = lg[:, -1].argmax(-1, keepdim=True)
            res["cache_gap"] = max(_gap(full(dcache[n]).numpy(), ref_cache[n].numpy())
                                   for n in ref_cache)
        return res

    t0 = time.perf_counter()
    out["internlm2-20b"] = train_case("internlm2-20b", True)
    out["internlm2-20b"].update(decode_case("internlm2-20b", get_reduced("internlm2-20b"), 4))
    olmoe = get_reduced("olmoe-1b-7b")
    out["olmoe-ep"] = decode_case("olmoe-1b-7b", olmoe, 2)
    tp = dataclasses.replace(olmoe, moe=dataclasses.replace(olmoe.moe, expert_parallel=False))
    out["olmoe-tp"] = decode_case("olmoe-1b-7b", tp, 2)
    out["zamba2-2.7b"] = train_case("zamba2-2.7b", False)
    out["seconds"] = time.perf_counter() - t0
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()


# -- the test ------------------------------------------------------------------------


def _write_inputs(data_dir):
    """Each arch's reduced reference params (numpy) and a token batch, and
    the reference's loss on them."""
    import jax

    from repro.configs import get_reduced as jax_reduced
    from repro.models.api import build_model as jax_build

    losses = {}
    rng = np.random.default_rng(0)
    for i, arch in enumerate(("internlm2-20b", "olmoe-1b-7b", "zamba2-2.7b")):
        jcfg = jax_reduced(arch)
        jm = jax_build(jcfg)
        jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(i)))
        tokens = rng.integers(0, jcfg.vocab_size, (4, 16), dtype=np.int32)
        flat = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
            flat["p/" + "/".join(str(k.key) for k in path)] = leaf
        np.savez(os.path.join(data_dir, f"{arch}.npz"), tokens=tokens, **flat)
        batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
        losses[arch] = float(jm.loss(jp, batch)[0])
    return losses


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One run of the 4 ranks: (their results, the reference's losses)."""
    tmp = tmp_path_factory.mktemp("sharded")
    ref_losses = _write_inputs(str(tmp))
    out = tmp / "out.json"
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = {**os.environ, "PYTHONPATH": os.path.abspath(src), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(tmp), str(out)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(log[-3000:] for log in logs)
    return json.loads(out.read_text()), ref_losses


def test_train_step_loss_and_every_gradient(run):
    lm = run[0]["internlm2-20b"]
    assert abs(lm["sharded_loss"] - lm["loss"]) <= TOL * abs(lm["loss"])
    assert lm["grads"] == 12 and lm["grad_gap"] <= TOL, lm


def test_prefill_and_decode_over_a_sequence_split_cache(run):
    lm = run[0]["internlm2-20b"]
    # the cache's sequence is split over the model axis: each step merged
    # the shards by their rows' log-sum-exp
    assert lm["cache_split"] == ["batch", "seq"]
    assert lm["logit_gap"] <= TOL and lm["tokens_equal"] and lm["cache_gap"] <= TOL, lm


@pytest.mark.parametrize("case", ["olmoe-ep", "olmoe-tp"])
def test_moe_decode_with_experts_or_their_width_split(run, case):
    res = run[0][case]
    assert res["logit_gap"] <= TOL and res["tokens_equal"] and res["cache_gap"] <= TOL, res


def test_zamba2_loss(run):
    z = run[0]["zamba2-2.7b"]
    assert abs(z["sharded_loss"] - z["loss"]) <= TOL * abs(z["loss"])


@pytest.mark.parametrize("arch", ["internlm2-20b", "zamba2-2.7b"])
def test_sharded_loss_matches_the_reference(run, arch):
    res, ref = run
    assert abs(res[arch]["sharded_loss"] - ref[arch]) <= 1e-4 * abs(ref[arch])


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
