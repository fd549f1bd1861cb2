"""The port's span recorder (``repro_torch.core.trace``): counts, units,
wall and CPU totals, merging across threads, snapshot subtraction, the
profiler range only while a profiler records, device time (CPU fallback
and event resolution without a synchronize), and the spans the serving
engine and the trainer close."""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_reduced
from repro_torch.core import trace
from repro_torch.models.api import build_model
from repro_torch.serve.engine import ClusterServingEngine, Request, ServingEngine


def delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def spin(seconds: float) -> None:
    """Run on the thread for ``seconds`` of its own CPU time."""
    end = time.thread_time() + seconds
    while time.thread_time() < end:
        pass


#: the coarsest tick of a thread's CPU clock the tests allow for (some
#: hosts count thread CPU time in 10 ms steps)
CPU_TICK_NS = 10_000_000


def test_spans_count_units_wall_and_cpu_and_nest():
    before = trace.snapshot()
    with trace.span("t.outer", 3, cpu=True):
        spin(0.03)
        with trace.span("t.inner", 2):
            time.sleep(0.05)
    with trace.span("t.inner", 5):
        pass
    d = delta(trace.snapshot(), before)
    assert d["span.t.outer.count"] == 1 and d["span.t.outer.units"] == 3
    assert d["span.t.inner.count"] == 2 and d["span.t.inner.units"] == 7
    assert d["span.t.outer.wall_ns"] >= d["span.t.inner.wall_ns"] >= 50_000_000
    # the spin ran on the thread, the sleep did not: the CPU clock's two
    # reads are at most a tick off what the thread ran
    cpu = d["span.t.outer.cpu_ns"]
    assert 30_000_000 <= cpu <= d["span.t.outer.wall_ns"] - 50_000_000 + CPU_TICK_NS
    assert "span.t.inner.cpu_ns" not in d and "span.t.inner.device_ns" not in d


def test_snapshots_subtract_key_by_key():
    with trace.span("t.sub"):
        pass
    a = trace.snapshot()
    b = trace.snapshot()
    assert set(a) <= set(b) and all(isinstance(v, int) for v in b.values())
    assert {k for k in a if k.startswith("span.t.sub.")} == {
        f"span.t.sub.{f}" for f in ("count", "units", "wall_ns", "cpu_ns", "device_ns")}
    with trace.span("t.sub", 4):
        pass
    d = delta(trace.snapshot(), b)
    assert d["span.t.sub.count"] == 1 and d["span.t.sub.units"] == 4
    assert all(k.startswith("span.t.sub.") for k in d)


def test_threads_keep_their_own_totals_and_snapshot_merges_them():
    """More threads than cores close spans, new names among them, while
    the main thread merges snapshots; a lost update would break the
    counts."""
    threads_n, spans_n = 2 * (os.cpu_count() or 4), 300
    before = trace.snapshot()
    start = threading.Barrier(threads_n + 1)

    def work(i):
        start.wait()
        for j in range(spans_n):
            with trace.span("t.threads", 2, cpu=True):
                pass
            if j % 50 == 0:
                with trace.span(f"t.threads.{i}.{j}"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(threads_n)]
        for t in threads:
            t.start()
        start.wait()
        while any(t.is_alive() for t in threads):
            trace.snapshot()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    d = delta(trace.snapshot(), before)   # after the threads have ended
    assert d["span.t.threads.count"] == threads_n * spans_n
    assert d["span.t.threads.units"] == 2 * threads_n * spans_n
    assert sum(1 for k in d if k.startswith("span.t.threads.") and k.endswith(".count")) \
        == 1 + threads_n * (spans_n // 50)


def test_no_profiler_range_while_no_profiler_records(monkeypatch):
    calls = []
    real = trace._range
    monkeypatch.setattr(trace, "_range", lambda name, rid: calls.append(name) or real(name, rid))
    n0 = len(trace.profiled())
    with trace.span("t.unprofiled", rid=3):
        pass
    assert calls == [] and len(trace.profiled()) == n0
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("t.profiled", rid=3):
            pass
    assert calls == ["t.profiled"]


def test_a_span_lands_in_the_profilers_trace_and_is_kept():
    x = torch.randn(32, 32)
    with trace.span("t.before"):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.span("t.traced", 7, cpu=True, rid=11):
                x @ x
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    assert "t.traced" in events and "t.before" not in events
    # a function-scope range: the profiler draws no device-side range for it
    assert not events["t.traced"].is_user_annotation()
    kept = [s for s in trace.profiled() if s["name"].startswith("t.traced")][-1]
    assert kept["rid"] == 11 and kept["units"] == 7 and kept["device_ns"] is None
    assert kept["close_ns"] - kept["open_ns"] == kept["wall_ns"] > 0
    assert kept["cpu_ns"] is not None
    # opened before the profiler started: not kept
    assert all(s["name"] != "t.before" for s in trace.profiled())


def test_device_spans_on_the_cpu_take_the_wall_time():
    before = trace.snapshot()
    with trace.span("t.dev_cpu", device=torch.device("cpu")):
        time.sleep(0.002)
    with trace.span("t.dev_cpu", device=torch.device("cpu")):
        pass
    d = delta(trace.snapshot(), before)
    assert d["span.t.dev_cpu.device_ns"] == d["span.t.dev_cpu.wall_ns"] >= 2_000_000
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("t.dev_cpu_kept", device=torch.device("cpu")):
            pass
    kept = [s for s in trace.profiled() if s["name"] == "t.dev_cpu_kept"][-1]
    assert kept["device_ns"] == kept["wall_ns"]


class _Event:
    """A stand-in for a CUDA timing event: done once ``done`` is set."""

    def __init__(self, t_ms, done):
        self.t_ms, self.done = t_ms, done

    def query(self):
        return self.done[0]

    def elapsed_time(self, end):
        return end.t_ms - self.t_ms


def test_device_time_is_added_once_the_events_finish():
    totals, entry, done = [1, 1, 5, 0, 0], {"device_ns": None}, [False]
    trace._pending.append((totals, _Event(1.0, done), _Event(3.5, done), entry))
    try:
        trace._resolve()          # unfinished: nothing added, nothing waited for
        assert totals[4] == 0 and entry["device_ns"] is None and len(trace._pending) == 1
        done[0] = True
        trace._resolve()
        assert totals[4] == 2_500_000 and entry["device_ns"] == 2_500_000
        assert len(trace._pending) == 0
    finally:
        trace._pending.clear()


@pytest.fixture(scope="module")
def engine():
    cfg = get_reduced("llama3-405b")
    model = build_model(cfg, device="cpu")
    return ServingEngine(model, model.init(0), num_slots=2, max_len=64, device="cpu")


def test_step_many_closes_one_dispatch_span_of_its_steps(engine):
    engine.admit(Request(prompt=np.arange(8) % 128, max_new_tokens=40, rid=1), 0)
    before = trace.snapshot()
    emitted = engine.step_many(16)
    d = delta(trace.snapshot(), before)
    assert len(emitted) == 16
    assert d["span.engine.dispatch.count"] == 1 and d["span.engine.dispatch.units"] == 16
    assert 0 < d["span.engine.dispatch.cpu_ns"]
    assert {k.split(".")[1] for k in d} == {"engine"}
    engine.evict(1)


def test_the_decode_loop_closes_an_admit_span_a_request_and_an_egress_span_a_block(engine):
    """A worker's decode loop (a thread of this process): one ``serve.admit``
    a request and one ``serve.egress`` after each block it dispatched."""
    eng = ClusterServingEngine(engine.model, engine.params, device="cpu", num_workers=1,
                               slots_per_worker=2, max_len=32, decode_block=4,
                               worker_driven=True)
    reqs = [Request(prompt=np.arange(3 + i) % 128, max_new_tokens=9, rid=i) for i in range(3)]
    before = trace.snapshot()
    try:
        out = eng.run(reqs, timeout=120)
    finally:
        eng.close()               # joins the loop: its last egress span has closed
    after = trace.snapshot()
    assert {r: len(v) for r, v in out.items()} == {0: 9, 1: 9, 2: 9}
    d = delta(after, before)
    assert d["span.serve.admit.count"] == 3 and d["span.serve.admit.wall_ns"] > 0
    blocks = d["span.engine.dispatch.count"]
    assert blocks >= 3 and d["span.engine.dispatch.units"] == 4 * blocks
    assert d["span.serve.egress.count"] >= blocks
    assert "span.serve.egress.cpu_ns" in after


def test_a_train_step_closes_a_step_and_an_optimizer_span():
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import Trainer

    cfg = get_reduced("internlm2-20b")
    tr = Trainer(cfg, AdamWConfig(), global_batch=2, seq_len=16, device="cpu")
    tr.init(0)
    before = trace.snapshot()
    tr.run_steps(2)
    d = delta(trace.snapshot(), before)
    assert d["span.train.step.count"] == 2 and d["span.train.optimizer.count"] == 2
    # on the CPU the wall stands in for device time, and the update is a part of the step
    assert d["span.train.step.device_ns"] == d["span.train.step.wall_ns"]
    assert 0 < d["span.train.optimizer.device_ns"] < d["span.train.step.device_ns"]
    assert {k.split(".")[1] for k in d} == {"train"}
