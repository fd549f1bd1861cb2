"""The serving engine's fixed payload and its CUDA-graph decode block, on
the CPU (reduced llama3-405b): the payload's tensors stay the same objects
through every engine operation, the rule that engages the graph, the
kernel-launch bookkeeping of a captured step, and the replay path's block
logic with a stand-in graph whose replay is one eager dispatch (the real
capture needs the card: ``chip_smoke.py`` holds graphed blocks against
eager steps there)."""

import importlib
import threading

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import get_reduced
from repro_torch.core import trace
from repro_torch.kernels import _build, decode_attention, grouped_matmul
from repro_torch.models.api import build_model
from repro_torch.serve import engine as E
from repro_torch.serve.engine import Request, ServingEngine, replays_graph

DEC = decode_attention.__name__
GMM = grouped_matmul.__name__


@pytest.fixture(scope="module")
def model():
    m = build_model(get_reduced("llama3-405b"), device="cpu")
    return m, m.init(seed=0)


def _engine(model, **kw):
    m, p = model
    return ServingEngine(m, p, num_slots=2, max_len=32, device="cpu", **kw)


def _ids(eng):
    return [id(x) for x in pytree.tree_leaves(eng.payload)]


def _admit_two(eng, temperature=0.0):
    eng.admit(Request(prompt=np.arange(4) % 128, max_new_tokens=5, rid=0,
                      temperature=temperature), 0)
    eng.admit(Request(prompt=np.arange(6) % 128, max_new_tokens=11, rid=1), 1)


# -- the payload's tensors are fixed for the engine's lifetime ---------------

_OPS = {
    "admit": lambda eng: _admit_two(eng),
    "step": lambda eng: (_admit_two(eng), eng.step()),
    "step_many": lambda eng: (_admit_two(eng), eng.step_many(4)),
    "sampled_step": lambda eng: (_admit_two(eng, temperature=0.9), eng.step(),
                                 eng.step_many(3)),
    "noop_step": lambda eng: (_admit_two(eng), eng.step(key=eng.key_noop)),
    "evict": lambda eng: (_admit_two(eng), eng.step(), eng.evict(0), eng.step_many(2)),
}


@pytest.mark.parametrize("op", sorted(_OPS))
def test_payload_tensors_are_fixed(model, op):
    """tokens, pos, temp and every cache leaf are the same tensor objects
    after each engine operation: a dispatch's result is copied back in
    place, so a captured graph's reads and an admission's writes meet."""
    eng = _engine(model)
    tokens, pos, before = eng.payload["tokens"], eng.payload["pos"], _ids(eng)
    _OPS[op](eng)
    assert eng.payload["tokens"] is tokens and eng.payload["pos"] is pos
    assert _ids(eng) == before


def test_steps_write_tokens_and_positions_in_place(model):
    """The fixed tensors carry the step's results: the next token of each
    active slot and its position one further."""
    eng = _engine(model)
    _admit_two(eng)
    pos0 = eng.payload["pos"].clone()
    out = eng.step()
    assert eng.payload["pos"].tolist() == (pos0 + 1).tolist()
    assert [t for _, t in out] == eng.payload["tokens"][:, 0].tolist()


# -- when a block replays the graph ------------------------------------------


@pytest.fixture
def dtensor_leaf():
    """A replicated DTensor on a one-rank CPU mesh; the process group is
    taken down again if this fixture made it."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch.mesh import make_mesh, single_rank_world

    owned = not dist.is_initialized()
    single_rank_world("cpu")
    try:
        mesh = make_mesh((1,), ("model",), device="cpu")
        yield DTensor.from_local(torch.zeros(2), mesh, [Replicate()], run_check=False)
    finally:
        if owned:
            dist.destroy_process_group()


_RULE_CASES = {
    # name: (device, temperatures of the slots (None: free), DTensor leaf, engages)
    "cuda_greedy": ("cuda", [0.0, 0.0], False, True),
    "cuda_greedy_one_free_slot": ("cuda", [0.0, None], False, True),
    "cpu_greedy": ("cpu", [0.0, 0.0], False, False),
    "cuda_sampled": ("cuda", [0.0, 0.7], False, False),
    "cuda_greedy_dtensor_leaf": ("cuda", [0.0, 0.0], True, False),
}


@pytest.mark.parametrize("case", sorted(_RULE_CASES))
def test_engagement_rule(case, request):
    """A pure function of the engine's state: device, the active slots'
    temperatures and the payload's leaf types (no card needed to ask)."""
    device, temps, dtensor, want = _RULE_CASES[case]
    slot_req = [None if t is None else Request(prompt=np.arange(3), temperature=t)
                for t in temps]
    payload = {"cache": {"k": torch.zeros(2, 2)}, "tokens": torch.zeros(2, 1),
               "pos": torch.zeros(2), "temp": torch.zeros(())}
    if dtensor:
        payload["cache"]["k"] = request.getfixturevalue("dtensor_leaf")
    assert replays_graph(torch.device(device), slot_req, payload) is want


# -- launch bookkeeping of a captured step -----------------------------------


def _read(*keys):
    return [getattr(importlib.import_module(m), c) for m, c in keys]


@pytest.mark.parametrize("times", [1, 16, 15])
def test_replays_add_the_captured_launches(times):
    """Each replay adds the launches the capture recorded, per counted
    module and counter, and nothing else."""
    keys = [(DEC, "launches"), (DEC, "launches_q8"), (GMM, "launches")]
    captured = {(DEC, "launches"): 48, (GMM, "launches"): 3}
    before = _read(*keys)
    _build.add_counts(captured, times)
    after = _read(*keys)
    assert [a - b for a, b in zip(after, before)] == [48 * times, 0, 3 * times]


def test_capture_withholds_its_launches_on_its_thread_only():
    """Inside ``withheld`` the thread's counts go to the record, not the
    counters (a capture launches nothing); another thread counts as usual."""
    before = decode_attention.launches
    with _build.withheld() as held:
        _build.count(DEC)
        _build.count(DEC, n=47)
        _build.count(GMM, "launches", 3)
        other = threading.Thread(target=_build.count, args=(DEC,))
        other.start()
        other.join()
    assert held == {(DEC, "launches"): 48, (GMM, "launches"): 3}
    assert decode_attention.launches - before == 1
    _build.count(DEC)
    assert decode_attention.launches - before == 2


# -- the replay path's block logic, with a stand-in graph ---------------------


class _EagerReplay:
    """Stands in for a captured step on the CPU: a replay is one eager
    dispatch of the key."""

    def __init__(self, eng, key):
        self.eng, self.key = eng, key

    def replay(self):
        self.eng._dispatch(self.key)


PER_STEP = {(DEC, "launches"): 7}


def _stand_in_capture(self, key):
    self._dispatch(key)   # the capturing block's eager first step
    return E.StepGraph(_EagerReplay(self, key), pytree.tree_leaves(self.payload),
                       dict(PER_STEP))


def _greedy_engages(device, slot_req, payload):
    return all(r is None or r.temperature <= 0 for r in slot_req)


def _serve(eng, block):
    _admit_two(eng)
    while any(r is not None for r in eng.slot_req):
        if block > 1:
            eng.step_many(block)
        else:
            eng.step()
    return eng.outputs


@pytest.mark.parametrize("block", [4, 3, 16])
def test_replayed_blocks_match_eager_steps(model, monkeypatch, block):
    """Graphed blocks (the first captures after one eager step, later ones
    replay every step) emit exactly the tokens of single eager steps; every
    block takes the replay path; the launches the counters gain are the
    captured step's times the replays."""
    want = _serve(_engine(model), 1)
    monkeypatch.setattr(E, "replays_graph", _greedy_engages)
    monkeypatch.setattr(ServingEngine, "_capture", _stand_in_capture)
    eng = _engine(model)
    before, launches = trace.snapshot(), decode_attention.launches
    got = _serve(eng, block)
    spans = {k: v - before.get(k, 0) for k, v in trace.snapshot().items()}
    assert got == want and list(eng.graphs) == [eng.key_greedy]
    blocks = spans["span.engine.dispatch.count"]
    assert spans["span.engine.replay.count"] == blocks > 0
    replays = spans["span.engine.replay.units"]
    assert replays == eng.steps_dispatched - 1     # the capturing block's first step is eager
    assert decode_attention.launches - launches == 7 * replays


def test_replay_refuses_a_payload_it_was_not_captured_on(model, monkeypatch):
    """A graph reads the tensors it was captured on: a payload leaf
    replaced behind the engine's back raises instead of replaying."""
    monkeypatch.setattr(E, "replays_graph", _greedy_engages)
    monkeypatch.setattr(ServingEngine, "_capture", _stand_in_capture)
    eng = _engine(model)
    _admit_two(eng)
    eng.step_many(2)
    eng.payload["pos"] = eng.payload["pos"].clone()
    with pytest.raises(RuntimeError, match="captured"):
        eng.step_many(2)
