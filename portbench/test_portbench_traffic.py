"""The traffic generator: the same seed gives the same work, every seed
the same sizes in another order, and rows that never repeat."""

import numpy as np
import pytest

from portbench import traffic

BIG = 2**33 + 12345


@pytest.mark.parametrize("name", ["chat-batch", "chat-batch-deep", "chat-r80"])
def test_serving_traffic_repeats_by_seed(name):
    mix = traffic.load(name)
    a = traffic.serve_requests(mix, 92544, BIG, 30.0)
    b = traffic.serve_requests(mix, 92544, BIG, 30.0)
    assert len(a) == len(b) > 50
    for x, y in zip(a, b):
        assert x["rid"] == y["rid"] and x["max_new"] == y["max_new"] and x["due"] == y["due"]
        assert np.array_equal(x["prompt"], y["prompt"])


@pytest.mark.parametrize("name", ["chat-batch", "chat-batch-deep", "chat-r80"])
def test_seeds_share_lengths_in_another_order(name):
    mix = traffic.load(name)
    a = traffic.serve_requests(mix, 92544, 1, 30.0)
    b = traffic.serve_requests(mix, 92544, BIG, 30.0)
    pa = sorted(len(r["prompt"]) for r in a)
    pb = sorted(len(r["prompt"]) for r in b)
    assert pa == pb
    assert [len(r["prompt"]) for r in a] != [len(r["prompt"]) for r in b]


def test_lengths_keep_the_wire_bound_and_the_distribution():
    mix = traffic.load("chat-batch")
    reqs = traffic.serve_requests(mix, 92544, 7, 30.0)
    p = np.array([len(r["prompt"]) for r in reqs])
    o = np.array([r["max_new"] for r in reqs])
    assert p.min() >= 64 and p.max() <= 448 and o.min() >= 8
    assert (p + o).max() <= 512
    assert abs(np.median(p) - 256) <= 2 and abs(np.median(o) - 48) <= 2
    assert all(r["due"] == 0.0 for r in reqs)
    assert all(0 <= r["prompt"].min() and r["prompt"].max() < 92544 for r in reqs)


def test_poisson_arrivals_fill_the_window_at_the_rate():
    mix = traffic.load("chat-r80")
    rate = mix["arrivals"]["rate_per_s"]
    reqs = traffic.serve_requests(mix, 92544, 3, 30.0)
    due = np.array([r["due"] for r in reqs])
    assert np.all(np.diff(due) >= 0) and due.max() < 30.0
    assert abs(len(reqs) - rate * 30.0) <= 2
    gaps = np.diff(np.concatenate([[0.0], due]))
    assert abs(gaps.mean() - 1.0 / rate) < 0.1 / rate
    assert 0.8 < gaps.std() / gaps.mean() < 1.2   # exponential gaps: cv about 1


def test_train_rows_repeat_by_seed_and_differ_by_step():
    src = traffic.TrainBatches(traffic.load("train-4k"), 50304, BIG)
    again = traffic.TrainBatches(traffic.load("train-4k"), 50304, BIG)
    b0, b1 = src.batch(0), src.batch(1)
    assert b0["tokens"].shape == (2, 4096) and b0["tokens"].dtype == np.int32
    assert np.array_equal(b0["tokens"], again.batch(0)["tokens"])
    assert np.array_equal(b0["tokens"][:, 1:], b0["labels"][:, :-1])
    assert not np.array_equal(b0["tokens"], b1["tokens"])
    assert not np.array_equal(b0["tokens"][0], b0["tokens"][1])


def test_every_stretch_of_the_queue_holds_the_whole_mix():
    mix = traffic.load("chat-batch")
    for seed in (1, BIG):
        p = np.array([len(r["prompt"]) for r in traffic.serve_requests(mix, 92544, seed, 30.0)])
        medians = [np.median(p[i:i + 64]) for i in range(0, 640, 64)]
        assert max(medians) - min(medians) < 40, medians


def test_the_deep_backlog_is_chat_batch_deeper():
    deep, mix = traffic.load("chat-batch-deep"), traffic.load("chat-batch")
    assert deep["requests"] == 4 * mix["requests"]
    assert deep["check"]["min_tokens"] > mix["check"]["min_tokens"]
    assert deep["engine"]["slots_per_worker"] == 10 * mix["engine"]["slots_per_worker"]
    # ten times the slots take longer to fill, and a loop iteration is
    # longer, so the window opens later and the traced slice starts sooner
    assert deep["fill_s"] > mix["fill_s"]
    assert deep["profile"]["blocks"] == mix["profile"]["blocks"]
    same = ("requests", "why", "check", "engine", "fill_s", "profile")
    assert {k: v for k, v in deep.items() if k not in same} == \
        {k: v for k, v in mix.items() if k not in same}
    assert {k: v for k, v in deep["engine"].items() if k != "slots_per_worker"} == \
        {k: v for k, v in mix["engine"].items() if k != "slots_per_worker"}
    reqs = traffic.serve_requests(deep, 50304, BIG, 51.0)
    p = np.array([len(r["prompt"]) for r in reqs])
    o = np.array([r["max_new"] for r in reqs])
    assert len(reqs) == 4000 and p.min() >= 64 and p.max() <= 448 and (p + o).max() <= 512
    assert abs(np.median(p) - 256) <= 2 and abs(np.median(o) - 48) <= 2
