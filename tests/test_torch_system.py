"""End-to-end behaviour of the port: the paper's story in one test each, the
port twin of ``tests/test_system.py``.

1. Heterogeneous agreement: two differently-ordered registries drive one
   fabric and still agree on every key.
2. HAM as control plane: offloaded training driven entirely by RPC.
3. The Fig. 2 program: allocate/put/async(inner_prod)/get on a worker.
4. Serving with the device dispatch table end to end.
5. The trainer's handlers derive the same keys in both packages for the
   same explicit names (a reference host could drive a port trainer).
"""

import numpy as np

from repro_torch.comm.local import LocalFabric
from repro_torch.core.closure import f2f
from repro_torch.core.registry import HandlerRegistry
from repro_torch.offload.api import OffloadDomain, deref
from repro_torch.offload.runtime import NodeRuntime, register_internal_handlers


def _user_handlers(reg):
    def inner_prod(a_ptr, b_ptr, n):
        a, b = deref(a_ptr), deref(b_ptr)
        return float(a[:n] @ b[:n])

    def scale(ptr, alpha):
        deref(ptr)[:] *= alpha

    reg.register(inner_prod, name="app/inner_prod")
    reg.register(scale, name="app/scale")


def test_heterogeneous_key_agreement_end_to_end():
    """Process A registers handlers in one order, process B in another;
    frames produced by A's keys execute the right handler on B."""
    reg_a = HandlerRegistry()
    register_internal_handlers(reg_a)
    _user_handlers(reg_a)
    table_a = reg_a.init()

    reg_b = HandlerRegistry()
    _user_handlers(reg_b)          # a different registration order
    register_internal_handlers(reg_b)
    table_b = reg_b.init()

    assert table_a.digest == table_b.digest
    fabric = LocalFabric(2)
    host = NodeRuntime(0, fabric.endpoint(0), table_a, inline=True)
    worker = NodeRuntime(1, fabric.endpoint(1), table_b).start()
    try:
        ptr_msg = host.send_sync(1, f2f("_ham/alloc", [8], "float64", registry=reg_a))
        assert ptr_msg[0] == "ptr"
    finally:
        worker.stop()


def test_paper_fig2_program():
    reg = HandlerRegistry()
    register_internal_handlers(reg)
    _user_handlers(reg)
    reg.init()
    dom = OffloadDomain.local(2, registry=reg)
    try:
        n = 1024
        a = np.arange(n, dtype=np.float64)
        b = np.full(n, 2.0)
        target = 1
        a_t = dom.allocate(target, (n,), "float64")
        b_t = dom.allocate(target, (n,), "float64")
        dom.put(a, a_t)
        dom.put(b, b_t)
        result = dom.async_(target, f2f("app/inner_prod", a_t, b_t, n, registry=reg))
        c = result.get(30)   # the host works in parallel, then syncs on the future
        assert c == a @ b
        dom.sync(target, f2f("app/scale", a_t, 3.0, registry=reg))
        np.testing.assert_array_equal(dom.get(a_t), a * 3.0)
    finally:
        dom.shutdown()


def test_offloaded_training_via_rpc():
    from repro_torch.configs import get_reduced
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import Trainer

    reg = HandlerRegistry()
    register_internal_handlers(reg)
    cfg = get_reduced("zamba2-2.7b")
    trainer = Trainer(cfg, AdamWConfig(lr=1e-3), global_batch=4, seq_len=16, device="cpu")
    trainer.register_handlers(reg)
    reg.init()
    dom = OffloadDomain.local(2, registry=reg)
    try:
        m3 = dom.sync(1, f2f("train/run_steps", 3, registry=reg), timeout=300)
        m9 = dom.sync(1, f2f("train/run_steps", 6, registry=reg), timeout=300)
        assert m9["step"] == 9
        assert m9["loss"] < m3["loss"] * 1.2  # training is progressing
    finally:
        dom.shutdown()


def test_serving_end_to_end_with_dispatch_table():
    from repro_torch.configs import get_reduced
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import Request, ServingEngine

    cfg = get_reduced("qwen2-moe-a2.7b")
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    eng = ServingEngine(model, params, num_slots=2, max_len=24, device="cpu")
    out = eng.run([
        Request(prompt=np.arange(4) % cfg.vocab_size, max_new_tokens=4),
        Request(prompt=np.arange(6) % cfg.vocab_size, max_new_tokens=3),
        Request(prompt=np.arange(3) % cfg.vocab_size, max_new_tokens=5),
    ])
    assert [len(out[i]) for i in range(3)] == [4, 3, 5]
    assert len(eng.table) == 3  # greedy / sample / noop branches


def test_trainer_handler_keys_equal_across_packages():
    """The same explicit names give the same keys and digest in a port
    registry holding a port ``Trainer``'s handlers and a reference registry
    holding the reference ``Trainer``'s."""
    from repro.configs import get_reduced as jax_reduced
    from repro.core.registry import HandlerRegistry as RefRegistry
    from repro.offload.runtime import register_internal_handlers as ref_internal
    from repro.optim.adamw import AdamWConfig as RefAdamW
    from repro.train.loop import Trainer as RefTrainer
    from repro_torch.configs import get_reduced
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import Trainer

    ref = RefRegistry()
    ref_internal(ref)
    RefTrainer(jax_reduced("internlm2-20b"), RefAdamW()).register_handlers(ref)
    port = HandlerRegistry()
    register_internal_handlers(port)
    Trainer(get_reduced("internlm2-20b"), AdamWConfig(), device="cpu").register_handlers(port)
    rt, pt = ref.init(), port.init()
    names = ["train/run_steps", "train/metrics", "train/checkpoint_now", "train/stop",
             "train/step"]
    assert [pt.key_of(n) for n in names] == [rt.key_of(n) for n in names]
    assert pt.digest == rt.digest
