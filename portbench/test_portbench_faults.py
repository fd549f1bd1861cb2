"""``correct`` fails where it must: the control (the reference with float8
matrix products in the program's place) and each fault a cell can have,
planted under a run of the drivers at a tiny size on the CPU, read beyond
the cells' own limits."""

import pytest
import torch

from portbench import common, testing


def test_serving_control_reads_beyond_the_limit():
    res = testing.run_cpu(testing.tiny_conf(dtype="bfloat16"), testing.tiny_mix("serve"),
                          "internlm2-20b.chat-batch", control=True)
    limit = common.limits("internlm2-20b.chat-batch")["logit_gap"]
    assert res["extra"]["control"]["logit_gap"] > limit


def test_training_control_reads_beyond_a_limit():
    res = testing.run_cpu(testing.tiny_conf(moe=True, train=True), testing.tiny_mix("train"),
                          "olmoe-1b-7b.train-4k", seconds=0.3, control=True)
    lim = common.limits("olmoe-1b-7b.train-4k")
    assert any(res["extra"]["control"][k] > lim[k] for k in lim)


def test_a_token_altered_where_it_is_produced(monkeypatch):
    from repro_torch.serve import engine

    emit = engine.ServingEngine._emit

    def altered(self, toks, active):
        toks = (toks + 1) % self.model.cfg.vocab_size
        return emit(self, toks, active)

    monkeypatch.setattr(engine.ServingEngine, "_emit", altered)
    res = testing.run_cpu(testing.tiny_conf(dtype="bfloat16"), testing.tiny_mix("serve"),
                          "internlm2-20b.chat-batch")
    assert not res["correct"]


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    from repro_torch.optim import adamw

    def unchanged(cfg, params, opt_state, grads):
        zero = torch.zeros(())
        return params, opt_state, {"grad_norm": zero, "lr": zero}

    monkeypatch.setattr(adamw, "update", unchanged)
    res = testing.run_cpu(testing.tiny_conf(moe=True, train=True), testing.tiny_mix("train"),
                          "olmoe-1b-7b.train-4k", seconds=0.3)
    assert not res["correct"]
    assert res["extra"]["readings"]["change_gap"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(monkeypatch):
    from repro_torch.models import layers

    ce = layers.cross_entropy

    def half(logits, labels, **kw):
        n = max(1, logits.shape[0] // 2)
        return ce(logits[:n], labels[:n], **kw)

    monkeypatch.setattr(layers, "cross_entropy", half)
    res = testing.run_cpu(testing.tiny_conf(moe=True, train=True), testing.tiny_mix("train"),
                          "olmoe-1b-7b.train-4k", seconds=0.3)
    assert not res["correct"]


def test_the_grouped_matmuls_weight_gradient_scaled():
    with testing.grouped_matmul_dw_scaled(2.0):
        res = testing.run_cpu(testing.tiny_conf(moe=True, train=True),
                              testing.tiny_mix("train"), "olmoe-1b-7b.train-4k",
                              seconds=0.3)
    assert not res["correct"]
    assert res["extra"]["readings"]["grad_diff"] > 0.5


def test_experts_altered_where_they_are_chosen(monkeypatch):
    from repro_torch.models import moe

    route = moe._route_groups

    def shifted(xf, router, cfg):
        probs, top_w, top_e = route(xf, router, cfg)
        return probs, top_w, (top_e + 1) % cfg.num_experts

    monkeypatch.setattr(moe, "_route_groups", shifted)
    res = testing.run_cpu(testing.tiny_conf(moe=True, train=True), testing.tiny_mix("train"),
                          "olmoe-1b-7b.train-4k", seconds=0.3)
    assert not res["correct"]
    assert res["checks"]["route_gap"]["value"] > res["checks"]["route_gap"]["limit"]


def _served_moe():
    conf = testing.tiny_conf(moe=True)
    conf["capacity_factor"] = 4.0   # E / k: dropless, as a served mixture must be
    return conf


def test_a_served_mixtures_token_altered_where_it_is_produced(monkeypatch):
    from repro_torch.serve import engine

    emit = engine.ServingEngine._emit

    def altered(self, toks, active):
        return emit(self, (toks + 1) % self.model.cfg.vocab_size, active)

    monkeypatch.setattr(engine.ServingEngine, "_emit", altered)
    res = testing.run_cpu(_served_moe(), testing.tiny_mix("serve"), "olmoe-1b-7b.chat-batch")
    assert not res["correct"]
    c = res["checks"]["logit_gap_mean"]
    assert c["value"] > c["limit"]


def test_served_experts_altered_where_they_are_chosen(monkeypatch):
    from repro_torch.models import moe

    route = moe._route_groups

    def shifted(xf, router, cfg):
        probs, top_w, top_e = route(xf, router, cfg)
        return probs, top_w, (top_e + 1) % cfg.num_experts

    monkeypatch.setattr(moe, "_route_groups", shifted)
    res = testing.run_cpu(_served_moe(), testing.tiny_mix("serve"), "olmoe-1b-7b.chat-batch")
    assert not res["correct"]
    assert res["checks"]["route_gap"]["value"] > res["checks"]["route_gap"]["limit"]
