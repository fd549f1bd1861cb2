"""The per-layer metrics that read the program's own spans: the slice cut
out of the profiled spans, each reader on fixed spans and without them,
the existing readers unmoved by them, and tiny traced runs on the CPU
that report each of them."""

import copy
import math

import pytest

from portbench import common, program_spans, testing, traffic

NEW = ("admit_ms.batch", "dispatch_ms_per_step.batch", "egress_ms_per_block.batch",
       "loop_offcpu.batch", "optimizer_share.train")
MS = 1_000_000


def s(name, t0, t1, units=1, cpu=None, device=None, rid=None):
    return {"name": name, "rid": rid, "units": units, "open_ns": t0 * MS, "close_ns": t1 * MS,
            "wall_ns": (t1 - t0) * MS, "cpu_ns": None if cpu is None else cpu * MS,
            "device_ns": None if device is None else device * MS}


def serve_spans():
    """Spans kept from an older profile, a device slice of two blocks, and a
    host slice of one block after it (ms)."""
    return [
        s("engine.dispatch", 0, 5, 16, cpu=5),             # an older profile's
        s("other", 100, 101),                              # another span of the slice
        s("engine.dispatch", 100, 160, 16, cpu=48),        # the slice's first block
        s("serve.egress", 170, 174, cpu=3),
        s("other", 180, 190),
        s("serve.admit", 175, 215, rid=1),
        s("serve.admit", 215, 275, rid=2),
        s("engine.dispatch", 280, 344, 16, cpu=60),        # its second
        s("other", 276, 350),
        s("serve.egress", 351, 357, cpu=6),                # the host slice's
        s("serve.admit", 360, 500, rid=3),
        s("engine.dispatch", 500, 640, 16, cpu=130),
    ]


def train_spans():
    out = [s("train.step", 0, 10, device=9), s("train.optimizer", 7, 9, device=2)]
    for i in range(3):
        t = 100 + 20 * i
        out += [s("other", t, t + 2), s("train.optimizer", t + 12, t + 18, device=5),
                s("train.step", t, t + 19, device=20)]
    return out


def record(kind: str) -> dict:
    if kind == "serve":
        conf = common.load_json("portbench/configs/internlm2-20b.json")
        mix = traffic.load("chat-batch")
    else:
        conf = common.load_json("portbench/configs/olmoe-1b-7b-4L.json")
        mix = traffic.load("train-4k")
    counters = {name: 96 for name in ("decode_attention", "flash_attention",
                                      "flash_attention_backward", "grouped_matmul",
                                      "grouped_matmul_backward")}
    counters.update(submitted=3, oneways=1, stream_frames=2)
    return {"conf": conf, "mix": mix, "window_s": 2.0, "busy_s": 0.5,
            "device_events": [("decode_kernel<bf16>", 0.0, 0.01), ("flash_kernel", 0.02, 0.05),
                              ("bwd_dq16", 0.05, 0.08), ("gmm_wgmma", 0.1, 0.2)],
            "gap_device_events": [], "host_events": [], "counters": counters,
            "spans": {"decode_lengths": [[100, 300]] * 32, "prefill_lengths": [256, 64],
                      "decode_tokens": 64, "first_tokens": 2, "blocks": 2,
                      "train_steps": 3, "batch": 2, "seq": 4096}}


def read(metric, rec):
    return common.reader(metric)(rec)


def test_the_serving_slice_runs_from_its_first_dispatch_to_its_last():
    cut = program_spans.between(serve_spans(), "engine.dispatch", 2, after=1)
    assert [x["open_ns"] // MS for x in cut] == [100, 100, 170, 180, 175, 215, 280]
    assert program_spans.between(serve_spans(), "engine.dispatch", 5) is None
    assert program_spans.between(None, "engine.dispatch", 1) is None
    assert program_spans.between(serve_spans(), "engine.dispatch", 0) is None


def test_the_serving_readers_on_fixed_spans(monkeypatch):
    monkeypatch.setattr(program_spans, "profiled", serve_spans)
    rec = record("serve")
    assert read("admit_ms.batch", rec) == pytest.approx(50.0)          # (40 + 60) / 2
    assert read("dispatch_ms_per_step.batch", rec) == pytest.approx(124 / 32)
    assert read("egress_ms_per_block.batch", rec) == pytest.approx(4.0)
    assert read("loop_offcpu.batch", rec) == pytest.approx(100 * (1 - 111 / 128))


def test_the_optimizer_share_on_fixed_spans(monkeypatch):
    monkeypatch.setattr(program_spans, "profiled", train_spans)
    assert read("optimizer_share.train", record("train")) == pytest.approx(25.0)


@pytest.mark.parametrize("spans", [None, [], "other"], ids=["no recorder", "none kept",
                                                           "no bounding spans"])
def test_without_their_spans_the_readers_give_none(monkeypatch, spans):
    kept = [s("serve.admit", 0, 1)] if spans == "other" else spans
    monkeypatch.setattr(program_spans, "profiled", lambda: copy.deepcopy(kept))
    for metric in NEW:
        kind = "train" if metric.endswith(".train") else "serve"
        assert read(metric, record(kind)) is None, metric


def test_a_span_without_its_cpu_or_device_time_gives_none(monkeypatch):
    spans = serve_spans()
    spans[3]["cpu_ns"] = None
    monkeypatch.setattr(program_spans, "profiled", lambda: spans)
    assert read("loop_offcpu.batch", record("serve")) is None
    steps = train_spans()
    steps[-1]["device_ns"] = None            # a step not yet finished on the device
    monkeypatch.setattr(program_spans, "profiled", lambda: steps)
    assert read("optimizer_share.train", record("train")) is None


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_the_existing_readers_read_the_same_with_the_program_spans(monkeypatch, kind):
    cell = "internlm2-20b.chat-batch" if kind == "serve" else "olmoe-1b-7b.train-4k"
    old = [m["name"] for m in common.benchmark()["per_layer"]
           if m["name"] not in NEW and cell in m["workloads"]]
    rec = record(kind)
    monkeypatch.setattr(program_spans, "profiled", lambda: None)
    before = {m: read(m, rec) for m in old}
    monkeypatch.setattr(program_spans, "profiled", serve_spans if kind == "serve"
                        else train_spans)
    kept = copy.deepcopy(rec)
    for m in NEW:
        read(m, rec)
    assert rec == kept                              # the new readers change no record
    assert {m: read(m, rec) for m in old} == before
    assert sum(v is not None for v in before.values()) >= 4


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_tiny_traced_runs_report_every_new_metric(kind):
    conf = testing.tiny_conf(moe=kind == "train", train=kind == "train")
    mix = testing.tiny_mix(kind)
    # slices that cannot miss the window: a missed slice leaves its profiler
    # recording. Training profiles the window's first step, which always
    # runs; serving the first two blocks from the window's open, with
    # hundreds of requests of the backlog still to come
    if kind == "serve":
        # every request ends inside the decode block after its admission, so
        # each loop iteration of the slice admits requests
        mix["output_tokens"] = {"dist": "lognormal", "median": 3, "sigma": 0.3, "min": 2,
                                "max": 4, "max_total": 64}
        mix["profile"] = {"start_share": 0.0, "blocks": 2}
    else:
        mix["profile"] = {"after_steps": 0, "steps": 1}
    cell = "internlm2-20b.chat-batch" if kind == "serve" else "olmoe-1b-7b.train-4k"
    res = testing.run_cpu(conf, mix, cell, trace=True, seconds=2.0)
    assert res["correct"]
    want = [m for m in NEW if m.endswith(".train") == (kind == "train")]
    for m in want:
        assert math.isfinite(res["metrics"][m]["value"]), m
    if kind == "train":
        assert 0 < res["metrics"]["optimizer_share.train"]["value"] < 100
    else:
        assert res["metrics"]["admit_ms.batch"]["value"] > 0
        assert res["metrics"]["dispatch_ms_per_step.batch"]["value"] > 0
