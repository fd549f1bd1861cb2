"""The port's device handler table and serving engine, held against the
reference ``ServingEngine`` on the same parameters and prompts
(tests/test_serve.py and tests/test_serve_stream.py set-up: reduced
llama3-405b, reference params carried across with ``params_from_numpy``)."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models.api import build_model as jax_build
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JServingEngine
from repro_torch.configs import get_reduced
from repro_torch.core.device_table import DeviceHandlerTable
from repro_torch.core.errors import RegistryError, UnknownHandlerError
from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.engine import Request, ServingEngine


@pytest.fixture(scope="module")
def engines():
    """(make_port_engine, make_reference_engine) over shared params."""
    jm = jax_build(jax_reduced("llama3-405b"))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_reduced("llama3-405b")
    m = build_model(cfg, device="cpu")
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")

    def port(**kw):
        return ServingEngine(m, p, device="cpu", **kw)

    def reference(**kw):
        return JServingEngine(jm, jp, **kw)

    return port, reference


def _reqs(specs, cls):
    """Fresh requests (the engines write rids into them)."""
    return [cls(prompt=np.arange(n)[::-1] % 128 if i % 2 else np.arange(n) % 128,
                max_new_tokens=m) for i, (n, m) in enumerate(specs)]


# -- device table (mirrors tests/test_serve.py) ------------------------------


def test_device_table_keys_sorted_and_stable():
    t = DeviceHandlerTable()
    t.register("z", lambda x: x)
    t.register("a", lambda x: x + 1)
    t.register("m", lambda x: x * 2)
    assert [h.stable_name for h in t.handlers] == ["a", "m", "z"]
    assert t.key_of("a") == 0 and t.key_of("z") == 2
    with pytest.raises(UnknownHandlerError):
        t.key_of("nope")
    with pytest.raises(RegistryError):
        t.register("b", lambda x: x)  # sealed by reading the handlers


def test_device_table_rejects_mismatched_results():
    t = DeviceHandlerTable()
    t.register("a", lambda x: x)
    t.register("b", lambda x: (x, x))  # different result structure
    with pytest.raises(RegistryError):
        t.validate(torch.empty(4, device="meta"))
    t2 = DeviceHandlerTable()
    t2.register("a", lambda x: x)
    t2.register("b", lambda x: x.double())  # same structure, other dtype
    with pytest.raises(RegistryError):
        t2.validate(torch.empty(4, device="meta"))


def test_device_table_dispatch_selects_branch_and_checks_first_call():
    t = DeviceHandlerTable()
    t.register("id", lambda x: x)
    t.register("neg", lambda x: -x)
    t.register("wide", lambda x: torch.cat([x, x]))
    d = t.build()
    x = torch.arange(3.0)
    assert torch.equal(d(t.key_of("id"), x), x)
    assert torch.equal(d(t.key_of("neg"), x), -x)
    with pytest.raises(RegistryError):   # first call of a branch with another shape
        d(t.key_of("wide"), x)
    with pytest.raises(UnknownHandlerError):
        d(len(t), x)


# -- engine against the reference --------------------------------------------


@pytest.mark.parametrize("num_slots,specs", [
    (2, [(4, 3), (9, 6), (2, 4), (5, 2)]),          # test_serve.py mixed lengths
    (3, [(1, 5), (12, 3), (7, 7), (3, 1), (6, 4)]),  # one-token prompt, one-token budget
])
def test_run_token_identical_to_reference(engines, num_slots, specs):
    port, reference = engines
    eng = port(num_slots=num_slots, max_len=32)
    out = eng.run(_reqs(specs, Request))
    ref = reference(num_slots=num_slots, max_len=32).run(_reqs(specs, JRequest))
    assert out == ref
    # as in the reference, a one-token budget still runs one decode step
    # (its slot counter is checked after a step), so it emits two tokens
    assert {r: len(v) for r, v in out.items()} == {
        i: max(m, 2) for i, (_, m) in enumerate(specs)}
    # continuous batching: fewer dispatched steps than tokens decoded
    assert eng.steps_dispatched < sum(m for _, m in specs)


def test_run_past_cache_end_matches_reference(engines):
    """Lanes decode past max_len: the reference drops those cache writes
    and attends the whole cache; the port mirrors both."""
    port, reference = engines
    specs = [(5, 9), (3, 12)]
    out = port(num_slots=2, max_len=8).run(_reqs(specs, Request))
    ref = reference(num_slots=2, max_len=8).run(_reqs(specs, JRequest))
    assert out == ref


def _serve_blocks(eng, block):
    eng.admit(Request(prompt=np.arange(4) % 128, max_new_tokens=5, rid=0), 0)
    eng.admit(Request(prompt=np.arange(6) % 128, max_new_tokens=11, rid=1), 1)
    while any(r is not None for r in eng.slot_req):
        if block > 1:
            eng.step_many(block)
        else:
            eng.step()
    return eng.outputs


@pytest.mark.parametrize("block", [4, 3])
def test_step_many_matches_sequential_steps(engines, block):
    """k-step blocks emit exactly the tokens of single steps, including a
    slot whose budget ends mid-block (tests/test_serve_stream.py)."""
    port, _ = engines
    ref = _serve_blocks(port(num_slots=2, max_len=32), 1)
    out = _serve_blocks(port(num_slots=2, max_len=32), block)
    assert out == ref
    assert {r: len(v) for r, v in out.items()} == {0: 5, 1: 11}


def test_step_early_out_and_noop(engines):
    port, _ = engines
    eng = port(num_slots=2, max_len=16)
    assert eng.step() == [] and eng.step_many(4) == []
    assert eng.steps_dispatched == 0
    eng.admit(Request(prompt=np.arange(3), max_new_tokens=4, rid=0), 0)
    before = {k: v.clone() for k, v in eng.payload["cache"].items()}
    tokens, pos = eng.payload["tokens"].clone(), eng.payload["pos"].clone()
    assert eng.step(key=eng.key_noop) == []
    assert eng.steps_dispatched == 1
    assert torch.equal(eng.payload["tokens"], tokens) and torch.equal(eng.payload["pos"], pos)
    for k in before:
        assert torch.equal(eng.payload["cache"][k], before[k])


def test_sampling_reproducible_under_seed(engines):
    port, _ = engines

    def sample(seed):
        eng = port(num_slots=2, max_len=32, seed=seed)
        return eng.run([Request(prompt=np.arange(5), max_new_tokens=8, temperature=1.5),
                        Request(prompt=np.arange(7), max_new_tokens=6)])

    a, b = sample(7), sample(7)
    assert a == b
    assert [len(a[0]), len(a[1])] == [8, 6]
    assert all(0 <= t < 128 for ts in a.values() for t in ts)
    assert any(sample(s)[0] != a[0] for s in (8, 9, 10))


def test_evict_frees_slot(engines):
    port, _ = engines
    eng = port(num_slots=2, max_len=16)
    eng.admit(Request(prompt=np.arange(3), max_new_tokens=8, rid=5), 1)
    assert eng.free_slots() == [0]
    assert eng.evict(5) and not eng.evict(5)
    assert eng.free_slots() == [0, 1] and eng.step() == []


def test_prompt_longer_than_cache_rejected(engines):
    port, _ = engines
    eng = port(num_slots=1, max_len=4)
    with pytest.raises(ValueError):
        eng.admit(Request(prompt=np.arange(5), max_new_tokens=2, rid=0), 0)


# -- admission along each cache leaf's batch axis -----------------------------


@pytest.mark.parametrize("arch,axes", [
    ("llama3-405b", 1),          # KV caches (L, B, S, Hkv, hd)
    ("olmoe-1b-7b", 1),
    ("xlstm-1.3b", 2),           # states (G, M, B, ...)
    ("zamba2-2.7b", {"mamba": (2, 2), "attn_kv": {"k": 1, "v": 1}}),
])
def test_admission_writes_each_leaf_along_its_batch_axis(arch, axes):
    """Admission into slot 1 of 3 over a cache of random values: every leaf
    gets the prefill's lane (a KV cache its prompt prefix) along its own
    batch axis, and nothing else changes.  Dense, MoE and xLSTM keep one int
    for every leaf, so their admission is the one they had; Zamba2 mixes
    axis 2 (Mamba2 states) and axis 1 (KV caches)."""
    from repro_torch.models.api import tree_map

    m = build_model(get_reduced(arch), device="cpu")
    assert m.cache_batch_axis == axes
    p = m.init(seed=0)
    eng = ServingEngine(m, p, num_slots=3, max_len=16, device="cpu")
    g = torch.Generator().manual_seed(1)
    tree_map(lambda t: t.copy_(torch.randn(t.shape, generator=g)), eng.payload["cache"])
    before = tree_map(torch.clone, eng.payload["cache"])
    prompt = np.arange(7) % 128
    eng.admit(Request(prompt=prompt, max_new_tokens=2, rid=0), 1)
    _, pcache = m.prefill(p, {"tokens": torch.from_numpy(prompt[None])})
    per_leaf = axes if isinstance(axes, dict) else tree_map(lambda _: axes, pcache)

    def check(full, old, part, axis):
        src = part.select(axis, 0)
        prefix = tuple(slice(0, n) for n in src.shape)
        want = old.clone()
        want.select(axis, 1)[prefix] = src
        assert torch.equal(full, want)

    tree_map(check, eng.payload["cache"], before, pcache, per_leaf)
