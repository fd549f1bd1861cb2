"""The plain reference against ``repro_torch`` at tiny sizes on the CPU:
the same weights through the program's model (its kernels' plain
versions) and through the reference give the same logits, and a run of
each driver in float32 reads no gap."""

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
    res = testing.run_cpu(conf, testing.tiny_mix("train"), limits=limits, seconds=0.5)
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
    res = testing.run_cpu(testing.tiny_conf(), testing.tiny_mix("poisson"), seconds=1.5)
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["logit_gap"]["value"] < 1e-4
    assert res["checks"]["compared_requests"]["value"] >= 2
    e = res["extra"]
    assert 0 < e["ttft_ms_p95"] < 1e5 and 0 < e["tpot_ms_p95"] < 1e5


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_traced_runs_read_their_slices(kind):
    conf = testing.tiny_conf(moe=kind == "train", train=kind == "train")
    res = testing.run_cpu(conf, testing.tiny_mix(kind), trace=True,
                          seconds=2.0 if kind == "serve" else 1.0)
    assert res["correct"] and res["window_s"] > 0
    idle = "device_idle.batch" if kind == "serve" else "device_idle.train"
    assert res["metrics"][idle]["value"] == 100.0   # no device on the CPU
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
