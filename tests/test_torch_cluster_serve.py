"""The slice: cluster serving through the port's HAM runtime, held against
the reference ``ClusterServingEngine`` on the same parameters and requests.

Reduced llama3-405b, 2 thread workers x 2 slots, ``max_len`` 24 and the
requests of tests/test_serve.py (six prompts of 3-5 tokens, budgets of
2-4): the reference's params reach the port through ``params_from_numpy``,
and in both drive modes (worker-driven decode loops and host lockstep) the
port's greedy transcripts must equal the reference cluster engine's, each
other's and the port's single ``ServingEngine``'s token for token.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models.api import build_model as jax_build
from repro.serve.engine import ClusterServingEngine as JClusterServingEngine
from repro.serve.engine import Request as JRequest
from repro_torch.configs import get_reduced
from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.engine import ClusterServingEngine, Request, ServingEngine
from repro_torch.serve.handlers import _NODE_ENGINES

WORKERS, SLOTS, MAX_LEN = 2, 2, 24


def _requests(cls, vocab):
    """Fresh requests (the engines write rids into them): tests/test_serve.py's."""
    return [cls(prompt=np.arange(3 + i % 3) % vocab, max_new_tokens=2 + i % 3)
            for i in range(6)]


@pytest.fixture(scope="module")
def models():
    jm = jax_build(jax_reduced("llama3-405b"))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_reduced("llama3-405b")
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    return jm, jp, model, params


@pytest.fixture(scope="module")
def reference(models):
    """The reference cluster engine's transcripts (worker-driven, its default)."""
    jm, jp, _, _ = models
    eng = JClusterServingEngine(jm, jp, num_workers=WORKERS, slots_per_worker=SLOTS,
                                max_len=MAX_LEN)
    try:
        return eng.run(_requests(JRequest, jm.cfg.vocab_size), timeout=120)
    finally:
        eng.close()


@pytest.fixture(scope="module")
def single(models):
    _, _, model, params = models
    eng = ServingEngine(model, params, num_slots=SLOTS, max_len=MAX_LEN, device="cpu")
    return eng.run(_requests(Request, model.cfg.vocab_size))


@pytest.mark.parametrize("worker_driven", [True, False], ids=["worker_driven", "lockstep"])
def test_cluster_transcripts_match_reference_and_single_engine(models, reference, single,
                                                              worker_driven):
    _, _, model, params = models
    eng = ClusterServingEngine(model, params, num_workers=WORKERS, slots_per_worker=SLOTS,
                               max_len=MAX_LEN, worker_driven=worker_driven, device="cpu")
    try:
        out = eng.run(_requests(Request, model.cfg.vocab_size), timeout=120)
        stats = dict(eng.sched.stats)
    finally:
        eng.close()
    assert {r: len(t) for r, t in reference.items()} == {i: 2 + i % 3 for i in range(6)}
    assert out == reference
    assert out == single
    # both workers served traffic
    assert sorted(stats["routed"]) == [1, 2] and all(n > 0 for n in stats["routed"].values())
    if worker_driven:
        # one slot-lease RPC per request: the host never drove a step
        assert stats["submitted"] == 6 and stats["oneways"] == 0


def test_replicas_share_params_and_own_caches(models):
    """One copy of the weights for every replica; each replica owns its
    cache, so in-place decode writes never cross replicas."""
    _, _, model, params = models
    eng = ClusterServingEngine(model, params, num_workers=WORKERS, slots_per_worker=SLOTS,
                               max_len=MAX_LEN, device="cpu")
    try:
        replicas = [_NODE_ENGINES[k] for k in eng._engine_keys.values()]
        assert len(replicas) == WORKERS
        assert all(r.params is params for r in replicas)
        ptrs = [r.payload["cache"]["k"].data_ptr() for r in replicas]
        assert len(set(ptrs)) == WORKERS
        assert [r.B for r in replicas] == [SLOTS] * WORKERS
    finally:
        eng.close()
    assert not set(eng._engine_keys.values()) & set(_NODE_ENGINES)


def test_cluster_engine_defaults_to_cuda(monkeypatch, models):
    """``device=None`` means the card: without CUDA it raises, never falls
    back; a model on another device than the engine is refused."""
    _, _, model, params = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ClusterServingEngine(model, params, num_workers=1, slots_per_worker=1, max_len=8)
    with pytest.raises(ValueError, match="model on cpu"):
        ClusterServingEngine(model, params, num_workers=1, slots_per_worker=1, max_len=8,
                             device="meta")


def test_replica_on_a_process_worker_raises_naming_item_11b(models):
    """A worker with no in-process runtime is a process worker: serving
    replicas run on thread workers only, as in the reference, and adding a
    replica there raises instead of leaving the worker without one (the
    reference returns silently)."""
    _, _, model, params = models
    eng = ClusterServingEngine(model, params, num_workers=1, slots_per_worker=1,
                               max_len=MAX_LEN, device="cpu")
    try:
        with pytest.raises(NotImplementedError, match="thread workers only"):
            eng._add_replica(max(eng.pool.worker_nodes) + 1)
        assert len(eng._engine_keys) == 1
    finally:
        eng.close()
