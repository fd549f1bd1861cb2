"""The yardstick's arithmetic on hand-worked cases: percentiles, the
window's rate, time per output token, spreads, and the FLOP and byte
counts against the configurations' sizes."""

import math

import pytest

from portbench import common


def test_percentile_interpolates_between_ranks():
    xs = [float(i) for i in range(1, 21)]   # 1..20
    assert common.percentile(xs, 50) == pytest.approx(10.5)
    assert common.percentile(xs, 95) == pytest.approx(19.05)   # rank 18.05 of 0..19
    assert common.percentile([5.0], 95) == 5.0
    assert common.percentile(xs[::-1], 0) == 1.0


def test_percentile_counts_a_missing_request_as_infinitely_late():
    xs = [1.0] * 19 + [math.inf]
    assert common.percentile(xs, 90) == 1.0
    assert math.isinf(common.percentile(xs, 99))


def test_tpot():
    assert common.tpot(10.0, 10.5, 11) == pytest.approx(0.05)
    with pytest.raises(ValueError):
        common.tpot(1.0, 2.0, 1)


def test_the_window_closes_on_the_first_delivery_after_its_time():
    # blocks of 4 tokens every second from t = 0.5
    arrivals = [0.5 + i for i in range(12) for _ in range(4)]
    tokens, end = common.delivered(arrivals, 0.0, 10.0)
    assert end == 10.5 and tokens == 44
    tokens, end = common.delivered(arrivals, 0.0, 11.5)
    assert end == 11.5 and tokens == 48
    # nothing after the close: the last delivery ends it
    assert common.delivered(arrivals, 0.0, 20.0) == (48, 11.5)


def test_matmul_parameters_of_the_configurations():
    intern = common.load_json("portbench/configs/internlm2-20b.json")
    # per layer: q, o 6144^2 each, k, v 6144 x 1024 each, MLP 3 x 6144 x 16384
    layer = 2 * 6144 * 6144 + 2 * 6144 * 1024 + 3 * 6144 * 16384
    assert common.matmul_params(intern) == 48 * layer + 6144 * 92544
    # with the embedding: the published 19.86 B parameters
    total = common.matmul_params(intern) + 6144 * 92544 + 97 * 6144
    assert total / 1e9 == pytest.approx(19.86, abs=0.01)
    olmoe = common.load_json("portbench/configs/olmoe-1b-7b-4L.json")
    active = 4 * (4 * 2048 * 2048 + 8 * 3 * 2048 * 1024 + 2048 * 64) + 2048 * 50304
    assert common.matmul_params(olmoe) == active


def test_train_flops_are_six_n_plus_causal_attention():
    conf = common.load_json("portbench/configs/internlm2-20b-4L.json")
    B, S = 2, 4096
    n = common.matmul_params(conf)
    attn = 3 * 4 * 48 * 128 * B * S * (S + 1) / 2 * 4
    assert common.model_flops_train(conf, B, S) == pytest.approx(6 * n * B * S + attn)


def test_kernel_counts():
    conf = common.load_json("portbench/configs/internlm2-20b.json")
    # flash forward: 4 d a causal pair and head
    assert common.flash_flops(conf, 1, 4, False) == 4 * 48 * 128 * 10
    assert common.flash_flops(conf, 1, 4, True) == 10 * 48 * 128 * 10
    # decode: K and V of 8 heads of 128 bf16 per cached position, q and o of 48
    assert common.decode_bytes(conf, [100, 28]) == 128 * 2 * 8 * 128 * 2 + 2 * 2 * 48 * 128 * 2
    olmoe = common.load_json("portbench/configs/olmoe-1b-7b-4L.json")
    assert common.gmm_flops(olmoe, 8192, False) == 2 * 8192 * 8 * 2048 * 1024
    assert common.gmm_flops(olmoe, 8192, True) == 2 * common.gmm_flops(olmoe, 8192, False)


def test_bound_picks_the_larger_time():
    t, which = common.bound(3.35e12, 1.0)
    assert t == pytest.approx(1.0) and which == "bytes"
    t, which = common.bound(1.0, 989e12)
    assert t == pytest.approx(1.0) and which == "operations"


def test_busy_time_is_the_union_of_device_events():
    dev = [("a", 0.0, 1.0), ("b", 0.5, 1.5), ("c", 2.0, 2.25)]
    assert common.busy_seconds(dev) == pytest.approx(1.75)
    host = [("aten::mm", 1.4, 2.1), ("aten::linear", 1.0, 3.0)]
    assert common.idle_gaps(dev, host) == [["aten::mm", pytest.approx(0.5)]]


def test_a_result_line_stays_json():
    import json
    import math

    from portbench import run

    line = run.finite({"checks": {"logit_gap": {"value": math.nan, "limit": 0.3}},
                       "extra": {"ttft": [1.0, math.inf]}})
    assert json.loads(json.dumps(line, allow_nan=False)) == {
        "checks": {"logit_gap": {"value": "nan", "limit": 0.3}},
        "extra": {"ttft": [1.0, "inf"]}}
    assert not common.correct({"logit_gap": {"value": math.nan, "limit": 0.3}})
    assert not common.correct({"compared_requests": {"value": 3, "limit": 4}})
    assert common.correct({"compared_requests": {"value": 4, "limit": 4},
                           "lost_requests": {"value": 0, "limit": 0}})



def _serve_record(conf_name, launches):
    conf = common.load_json(f"portbench/configs/{conf_name}.json")
    return {"conf": conf, "counters": {"grouped_matmul": launches, "decode_attention": 0},
            "device_events": [("gmm_stream<__nv_bfloat16>", 0.0, 0.015),
                              ("decode_kernel<bf16>", 0.015, 0.02),
                              ("gmm_wgmma<0>", 0.02, 0.025)],
            "spans": {"prefill_lengths": [256], "decode_lengths": [[300] * 64, [301] * 64],
                      "decode_tokens": 128, "first_tokens": 1, "blocks": 1,
                      "train_steps": 0}}


def test_grouped_matmul_roofline_of_a_serving_slice():
    read = common.reader("grouped_matmul_roofline.batch")
    # one prefill of 256 tokens and two decode steps over 64 sequences, 16
    # layers of 3 launches: 144 launches, each bound by its bytes: all 64
    # experts' weights (64 x 2048 x 1024 x 2 B = 268,435,456) and each routed
    # row's input and output (tokens x 8 rows of (2048 + 1024) x 2 B)
    weights = 64 * 2048 * 1024 * 2
    prefill = weights + 256 * 8 * 3072 * 2          # 281,018,368 B
    step = weights + 64 * 8 * 3072 * 2              # 271,581,184 B
    assert prefill == 281_018_368 and step == 271_581_184
    # FLOPs: 2 d f a routed row, 8.59 GFLOP for the prefill: 8.7 us at peak,
    # against 83.9 us for its bytes
    assert common.gmm_flops(common.load_json("portbench/configs/olmoe-1b-7b.json"), 256,
                            False) == 2 * 2048 * 1024 * 2048
    need = 48 * (prefill + 2 * step) / 3.35e12      # 0.011809 s
    assert read(_serve_record("olmoe-1b-7b", 144)) == pytest.approx(100 * need / 0.02)


@pytest.mark.parametrize("conf_name,launches", [
    ("olmoe-1b-7b", 143),             # a launch this count does not describe
    ("internlm2-20b", 0),             # the dense served cell: no expert layer
], ids=["launches differ", "dense"])
def test_grouped_matmul_roofline_reads_nothing_it_cannot_count(conf_name, launches):
    read = common.reader("grouped_matmul_roofline.batch")
    assert read(_serve_record(conf_name, launches)) is None
    train = _serve_record(conf_name, launches)
    train["spans"].update(prefill_lengths=[], decode_lengths=[], train_steps=3)
    assert read(train) is None
