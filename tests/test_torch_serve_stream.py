"""The port's counterpart of tests/test_serve_stream.py, on the CPU.

Worker-driven streaming serve: protocol-level tests (docs/serving.md).

Covers the delivery/ordering contract of the ``_serve/stream*`` path, the
fused multi-step decode block, mode equivalence (worker-driven transcripts
token-identical to the lockstep drive), elasticity under join/leave, and
the failure-model legs: kill-mid-decode replay, cancel, and deadlines.
The kill-mid-decode case kills the worker inside a decode block, once a
request placed on it has streamed tokens and still has budget left, so the
kill always lands mid-decode (the reference kills after 12 streamed tokens,
by which time the victim may have finished and nothing replays).
"""

import time

import numpy as np
import pytest

from repro_torch.configs import get_reduced
from repro_torch.core.flags import STREAM_CANCELLED, STREAM_DONE, STREAM_EXPIRED
from repro_torch.models.api import build_model
from repro_torch.serve.engine import ClusterServingEngine, Request, ServingEngine


@pytest.fixture(scope="module")
def model_and_params():
    cfg = get_reduced("llama3-405b")
    model = build_model(cfg, device="cpu")
    return model, model.init(seed=0)


def _prompts(cfg, n, base=3):
    return [np.arange(base + i % 3) % cfg.vocab_size for i in range(n)]


def _reqs(cfg, n, max_new=8, base=3):
    return [Request(prompt=p, max_new_tokens=max_new, rid=i)
            for i, p in enumerate(_prompts(cfg, n, base))]


# -- engine: fused multi-step block ----------------------------------------


def test_step_many_matches_sequential_steps(model_and_params):
    """A fused block (k dispatches, one host transfer) emits exactly the
    tokens k sequential steps would — including a slot whose budget ends
    mid-block (its surplus lane tokens are dropped, not recorded)."""
    model, params = model_and_params
    cfg = model.cfg

    def serve(block):
        eng = ServingEngine(model, params, device="cpu", num_slots=2, max_len=32)
        eng.admit(Request(prompt=np.arange(4) % cfg.vocab_size,
                          max_new_tokens=5, rid=0), 0)
        eng.admit(Request(prompt=np.arange(6) % cfg.vocab_size,
                          max_new_tokens=11, rid=1), 1)
        while any(r is not None for r in eng.slot_req):
            if block > 1:
                eng.step_many(block)
            else:
                eng.step()
        return eng.outputs

    ref = serve(1)
    out = serve(4)
    assert out == ref
    assert {r: len(v) for r, v in out.items()} == {0: 5, 1: 11}


def test_step_early_out_when_all_slots_idle(model_and_params):
    """An empty batch never dispatches — neither via step() nor a fused
    block — but an explicit noop key still does (bubble-filler path)."""
    model, params = model_and_params
    eng = ServingEngine(model, params, device="cpu", num_slots=2, max_len=16)
    assert eng.step() == []
    assert eng.step_many(4) == []
    assert eng.steps_dispatched == 0
    eng.step(key=eng.key_noop)
    assert eng.steps_dispatched == 1


# -- cluster: mode equivalence + stream ordering ---------------------------


def test_worker_driven_token_identical_to_lockstep(model_and_params):
    """Same prompts, same seed: the worker-driven drive must produce the
    exact transcripts of the lockstep drive (greedy decode is deterministic
    and slot lanes are independent, so any divergence is a protocol bug)."""
    model, params = model_and_params
    cfg = model.cfg
    outs = {}
    for wd in (False, True):
        eng = ClusterServingEngine(model, params, device="cpu",
                                   num_workers=2,
                                   slots_per_worker=2, max_len=32,
                                   worker_driven=wd)
        try:
            outs[wd] = eng.run(_reqs(cfg, 6, max_new=9), timeout=120)
            if wd:
                # one admit RPC per request: the host never drove a step
                assert eng.sched.stats["submitted"] == 6
                # fused-oneway ordering held for every session
                assert all(ev.get("seq_ok", True)
                           for ev in eng._events.values())
        finally:
            eng.close()
    assert outs[True] == outs[False]
    assert {r: len(v) for r, v in outs[True].items()} == {
        i: 9 for i in range(6)
    }


def test_join_leave_mid_batch_token_identical(model_and_params):
    """Elastic membership mid-batch: requests served across a join and a
    drained leave still match the lockstep transcripts token for token."""
    model, params = model_and_params
    cfg = model.cfg
    eng = ClusterServingEngine(model, params, device="cpu",
                                   num_workers=1,
                               slots_per_worker=2, max_len=32)
    try:
        rids = [eng.submit_request(r, shed=False)
                for r in _reqs(cfg, 6, max_new=8)]
        new = eng.pool.add_node()  # join while the batch is decoding
        eng.wait(rids, timeout=120.0)
        eng.pool.remove_node(new, drain=True)  # leave between batches
        late = [eng.submit_request(  # rid=-1: fresh ids, no transcript reuse
            Request(prompt=p, max_new_tokens=8), shed=False)
            for p in _prompts(cfg, 2)]
        eng.wait(late, timeout=120.0)
        with eng._wd:
            got = {r: list(eng._transcripts[r]) for r in rids}
            got_late = {i: list(eng._transcripts[r])
                        for i, r in enumerate(late)}
    finally:
        eng.close()
    ref = ServingEngine(model, params, device="cpu", num_slots=2, max_len=32).run(
        _reqs(cfg, 6, max_new=8))
    assert got == ref
    ref_late = ServingEngine(model, params, device="cpu", num_slots=2, max_len=32).run(
        _reqs(cfg, 2, max_new=8))
    assert got_late == ref_late


def test_kill_mid_decode_replays_without_dup_or_loss(model_and_params):
    """Kill a worker while its loop is streaming: every request replays on
    the survivor and the final transcripts are exactly the reference — no
    duplicated, lost, or reordered tokens (seq_ok holds through the repin
    because the continuation admit offsets the stream's seq base).

    The kill is certain to land mid-decode: it fires inside the victim's
    next decode block once a request there has streamed tokens and still
    has budget left.  A thread worker's kill stops only its event loop, so
    the decode loop is stopped with it, as a crashed process loses both;
    the block is never computed and that request must replay."""
    from repro_torch.serve.handlers import _NODE_ENGINES, _NODE_LOOPS

    model, params = model_and_params
    cfg = model.cfg
    eng = ClusterServingEngine(model, params, device="cpu", num_workers=2,
                               slots_per_worker=2, max_len=64)
    killed = {}
    victim = eng.serving_nodes()[0]
    rt = eng.pool.domain._inproc[victim]
    replica, loop = _NODE_ENGINES[id(rt)], _NODE_LOOPS[id(rt)]
    step_many = replica.step_many

    def crash_mid_decode(k):
        live = [(rid, lv) for rid, lv in loop._live.items()
                if lv["seq"] >= 2 and lv["remaining"] > 0]
        if killed or not live:
            return step_many(k)
        eng.pool.kill(victim)
        loop.stop(join=False)
        rid, lv = live[0]
        killed.update(node=victim, rid=rid, streamed=lv["seq"])
        return []  # the crash takes this block with it

    replica.step_many = crash_mid_decode
    try:
        rids = [eng.submit_request(r, shed=False)
                for r in _reqs(cfg, 6, max_new=24)]
        eng.wait(rids, timeout=180.0)
        with eng._wd:
            got = {r: list(eng._transcripts[r]) for r in rids}
            events = {r: dict(eng._events[r]) for r in rids}
    finally:
        eng.close()
    assert "node" in killed, "the kill must land mid-run"
    ref = ServingEngine(model, params, device="cpu", num_slots=2, max_len=64).run(
        _reqs(cfg, 6, max_new=24))
    assert got == ref  # exact: no duplicated and no lost tokens
    assert any(ev.get("repins", 0) > 0 for ev in events.values())
    assert events[killed["rid"]].get("repins", 0) > 0  # the victim's request replayed
    assert all(ev.get("seq_ok", True) for ev in events.values())

# -- failure model: cancel + deadline --------------------------------------


def test_cancel_mid_decode_frees_slot(model_and_params):
    """Cancel a streaming request: the host keeps the partial transcript,
    the end-of-stream ack records STREAM_CANCELLED, and the freed slot
    serves a follow-up request to completion."""
    model, params = model_and_params
    cfg = model.cfg
    eng = ClusterServingEngine(model, params, device="cpu",
                                   num_workers=1,
                               slots_per_worker=1, max_len=450)
    try:
        rid = eng.submit_request(
            Request(prompt=np.arange(5) % cfg.vocab_size,
                    max_new_tokens=400), shed=False)
        deadline = time.time() + 60
        while time.time() < deadline:
            with eng._wd:
                if len(eng._transcripts.get(rid, ())) >= 4:
                    break
            time.sleep(0.002)
        assert eng.cancel(rid)
        eng.wait([rid], timeout=60.0)
        with eng._wd:
            assert eng._done[rid] == STREAM_CANCELLED
            assert 0 < len(eng._transcripts[rid]) < 400
        follow = eng.submit_request(
            Request(prompt=np.arange(4) % cfg.vocab_size,
                    max_new_tokens=3), shed=False)
        eng.wait([follow], timeout=60.0)
        with eng._wd:
            assert eng._done[follow] == STREAM_DONE
            assert len(eng._transcripts[follow]) == 3
    finally:
        eng.close()


def test_deadline_expires_mid_decode(model_and_params):
    """A request whose decode budget outlives its deadline leaves the batch
    at a block boundary with STREAM_EXPIRED and a partial transcript
    (docs/failure-model.md: abandoned requests)."""
    model, params = model_and_params
    cfg = model.cfg
    eng = ClusterServingEngine(model, params, device="cpu",
                                   num_workers=1,
                               slots_per_worker=1, max_len=450)
    try:
        rid = eng.submit_request(
            Request(prompt=np.arange(5) % cfg.vocab_size,
                    max_new_tokens=400, deadline=0.15), shed=False)
        eng.wait([rid], timeout=120.0)
        with eng._wd:
            assert eng._done[rid] == STREAM_EXPIRED
            assert 0 < len(eng._transcripts[rid]) < 400
    finally:
        eng.close()
