"""The plain reference against ``repro_torch`` at tiny sizes on the CPU:
the same weights through the program's model (its kernels' plain
versions) and through the reference give the same logits, a run of each
driver in float32 reads no gap (a served mixture of experts on the
program's routing too), and a configuration brings its own reference
module and program fields without an edit here."""

import pytest
import torch

from portbench import common, program, testing
from portbench.reference import decoder


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_reference_logits_equal_the_programs(moe):
    from repro_torch.models.api import build_model

    conf = testing.tiny_conf(moe=moe)
    model = build_model(program.model_config(conf), device="cpu")
    params = decoder.make_weights(conf, 2**35 + 1, "cpu", torch.float32)
    tokens = torch.randint(0, conf["vocab_size"], (3, 33), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = model.forward(params, {"tokens": tokens.int()})
    want = decoder.logits(conf, 2**35 + 1, list(tokens), "cpu", torch.float32)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_weights_are_remade_slice_by_slice():
    conf = testing.tiny_conf(moe=True)
    tree = decoder.make_weights(conf, 99, "cpu", torch.bfloat16)
    again = decoder.make_slice(conf, 99, ("layers", "moe", "w_down"), 1, "cpu", torch.bfloat16)
    assert torch.equal(tree["layers"]["moe"]["w_down"][1], again)
    assert tree["layers"]["moe"]["router"].dtype == torch.float32
    other = decoder.make_weights(conf, 100, "cpu", torch.bfloat16)
    assert not torch.equal(tree["head"]["w"], other["head"]["w"])


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_training_reference_follows_the_program(moe):
    conf = testing.tiny_conf(moe=moe, train=True)
    # the dense cell compares no first gradient itself: ask for it here
    limits = None if moe else dict(common.limits("internlm2-20b.train-4k"), grad_diff=1e-5)
    cell = "olmoe-1b-7b.train-4k" if moe else "internlm2-20b.train-4k"
    res = testing.run_cpu(conf, testing.tiny_mix("train"), cell, limits=limits, seconds=0.5)
    assert res["correct"]
    r = res["extra"]["readings"]
    names = ["loss_gap", "grad_gap", "change_gap", "grad_diff_least", "grad_diff"]
    if moe:
        # the forward pass and the backward's recomputation route each layer
        assert res["extra"]["route_calls"] == [4] * 3
        names.append("route_gap")
    for name in names:
        assert r[name] < 1e-5, (name, r[name])


def test_serving_reference_follows_the_program():
    res = testing.run_cpu(testing.tiny_conf(), testing.tiny_mix("poisson"),
                          "internlm2-20b.chat-batch", seconds=1.5)
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["logit_gap"]["value"] < 1e-4
    assert res["checks"]["compared_requests"]["value"] >= 2
    e = res["extra"]
    assert 0 < e["ttft_ms_p95"] < 1e5 and 0 < e["tpot_ms_p95"] < 1e5


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_traced_runs_read_their_slices(kind):
    conf = testing.tiny_conf(moe=kind == "train", train=kind == "train")
    cell = "internlm2-20b.chat-batch" if kind == "serve" else "olmoe-1b-7b.train-4k"
    res = testing.run_cpu(conf, testing.tiny_mix(kind), cell, trace=True,
                          seconds=2.0 if kind == "serve" else 1.0)
    assert res["correct"] and res["window_s"] > 0
    idle = "device_idle.batch" if kind == "serve" else "device_idle.train"
    assert res["metrics"][idle]["value"] == 100.0   # no device on the CPU
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def _served_moe(capacity_factor):
    conf = testing.tiny_conf(moe=True)
    conf["capacity_factor"] = capacity_factor
    return conf


def test_a_served_mixture_of_experts_follows_the_programs_routing():
    conf = _served_moe(8 / 2)   # E / k: no (token, choice) pair can be dropped
    cell = "olmoe-1b-7b.chat-batch"
    res = testing.run_cpu(conf, testing.tiny_mix("serve"), cell, control=True)
    assert res["correct"] and res["failed"] == 0
    c, e = res["checks"], res["extra"]
    limits = common.limits(cell)
    assert list(c) == [*limits, "malformed_requests", "compared_requests", "lost_requests"]
    r = e["readings"]
    assert r["logit_gap"] < 1e-4 and r["route_gap"] < 1e-5
    assert c["compared_requests"]["value"] >= 4
    assert e["own_routing"]["logit_gap"] >= 0.0
    print("tiny served MoE:", r, "own routing:", e["own_routing"], "control:", e["control"])
    assert any(e["control"][name] > limit for name, limit in limits.items())


def test_a_served_mixture_that_can_drop_pairs_is_refused():
    with pytest.raises(ValueError, match="capacity_factor 1.25"):
        testing.run_cpu(_served_moe(1.25), testing.tiny_mix("serve"),
                        "olmoe-1b-7b.chat-batch")


def _digest(root):
    import hashlib

    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_a_configuration_brings_its_own_reference_and_program_fields(tmp_path, kind):
    import json

    ref_path = tmp_path / "own_reference.py"
    ref_path.write_text((common.HERE / "reference" / "decoder.py").read_text() + '''

CALLS = []
_plain_logits, _plain_train = logits, train


def logits(*args, **kwargs):
    CALLS.append("logits")
    return _plain_logits(*args, **kwargs)


def train(*args, **kwargs):
    CALLS.append("train")
    return _plain_train(*args, **kwargs)
''')
    conf = testing.tiny_conf(moe=True, train=kind == "train")
    conf.update(name="own", capacity_factor=4.0, reference=str(ref_path),
                program={"remat": "none", "moe": {"expert_parallel": False}})
    (tmp_path / "own.json").write_text(json.dumps(conf))
    conf = json.loads((tmp_path / "own.json").read_text())
    cfg = program.model_config(conf)
    assert cfg.remat == "none" and cfg.moe.expert_parallel is False
    before = _digest(common.HERE)
    cell = "olmoe-1b-7b.chat-batch" if kind == "serve" else "olmoe-1b-7b.train-4k"
    res = testing.run_cpu(conf, testing.tiny_mix(kind), cell,
                          seconds=2.0 if kind == "serve" else 0.5)
    assert res["correct"]
    own = common.reference(conf)
    assert own.__file__ == str(ref_path)
    assert own.CALLS == (["logits"] if kind == "serve" else ["train"])
    if kind == "train":
        # no recomputation (``remat`` "none"): each step routes each layer once
        assert res["extra"]["route_calls"] == [2] * 3
    assert _digest(common.HERE) == before


def test_no_decode_loop_outlives_a_served_run():
    import threading

    res = testing.run_cpu(_served_moe(8 / 2), testing.tiny_mix("serve"), "olmoe-1b-7b.chat-batch")
    assert res["correct"]
    assert not [t.name for t in threading.enumerate() if t.name.startswith("ham-decode-loop")]


def test_waiting_for_a_decode_loop_that_ends_late():
    import threading
    import time
    import types

    from portbench import adapter

    late, stuck = (types.SimpleNamespace(_thread=threading.Thread(target=time.sleep, args=(s,)))
                   for s in (0.3, 3.0))
    late._thread.start()
    stuck._thread.start()
    adapter.wait_ended([late])
    assert not late._thread.is_alive()
    with pytest.raises(RuntimeError, match="still runs"):
        adapter.wait_ended([stuck], timeout=0.1)
    stuck._thread.join()
