"""The port's counterpart of tests/test_fastpath.py, on the local fabric
and, end to end, a fresh-interpreter worker over shm.

Static-spec RPC fast path: compiled WirePlans, FLAG_STATIC wire format,
small-call fusion (FLAG_FUSED), and wire compat with pre-plan peers."""

import numpy as np
import pytest

from repro_torch.core import errors as ham
import repro_torch.offload.demo_handlers  # noqa: F401 — registers demo/* at
#                            collection, before any test seals the registry
from repro_torch.core import migratable as mig
from repro_torch.core.closure import f2f
from repro_torch.core.errors import SpecMismatchError
from repro_torch.core.executor import ThreadPoolPolicy
from repro_torch.core.message import (
    FLAG_DYNAMIC,
    FLAG_ERROR,
    FLAG_FUSED,
    FLAG_REPLY,
    FLAG_SHAPED,
    FLAG_STATIC,
    decode_fast,
    encode_frame,
    iter_fused,
)
from repro_torch.core.migratable import ArraySpec, ScalarSpec
from repro_torch.core.registry import HandlerRegistry
from repro_torch.core.wireplan import WirePlan
from repro_torch.comm.local import LocalFabric
from repro_torch.offload.runtime import NodeRuntime, register_internal_handlers

ARR = np.arange(28, dtype=np.float64)
ECHO_SPECS = tuple(mig.spec_of(x) for x in (1, 2, 3.0, ARR))


# -- WirePlan unit behaviour -------------------------------------------------


def test_wireplan_layout_matches_legacy_pack_static():
    """The compiled plan's wire bytes are identical to pack_static — the
    invariant that makes FLAG_STATIC advisory (pre-plan peers interop)."""
    cases = [
        ((True, 5, 2.5), None),
        ((1, 2, 3.0, ARR), None),
        ((ARR,), None),
        ((np.arange(12, dtype=np.int32).reshape(3, 4), False, 7), None),
        ((), None),
    ]
    for args, _ in cases:
        specs = tuple(mig.spec_of(a) for a in args)
        plan = WirePlan(specs)
        assert plan.nbytes == mig.static_payload_nbytes(specs)
        buf = bytearray(plan.nbytes)
        plan.pack_args(buf, 0, args)
        assert bytes(buf) == bytes(mig.pack_static(args, specs))
        out = plan.unpack_args(memoryview(buf))
        legacy = mig.unpack_static(buf, specs)
        assert len(out) == len(legacy)
        for a, b in zip(out, legacy):
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b and type(a) is type(b)


def test_wireplan_zero_copy_array_views():
    plan = WirePlan((ArraySpec((4,), "float64"),))
    buf = bytearray(plan.nbytes)
    plan.pack_args(buf, 0, (np.arange(4.0),))
    (view,) = plan.unpack_args(memoryview(buf))
    buf[0:8] = mig.pack_static((99.0,), (ScalarSpec("f8"),))
    assert view[0] == 99.0  # aliases the payload, no copy


def test_wireplan_offset_pack_and_2d_noncontiguous():
    arr2 = np.arange(64, dtype=np.float32).reshape(8, 8)
    plan = WirePlan((mig.spec_of(arr2), ScalarSpec("i8")))
    buf = bytearray(16 + plan.nbytes)
    plan.pack_args(buf, 16, (np.asfortranarray(arr2), 7))  # non-contiguous
    out = plan.unpack_args(memoryview(buf)[16:])
    np.testing.assert_array_equal(out[0], arr2)
    assert out[1] == 7


def test_wireplan_opaque_leaf_roundtrip():
    from repro_torch.offload.buffer import BufferPtr

    ptr = BufferPtr(3, 17, 4096)
    plan = WirePlan((mig.spec_of(ptr), ScalarSpec("i8")))
    buf = bytearray(plan.nbytes)
    plan.pack_args(buf, 0, (ptr, 5))
    out = plan.unpack_args(buf)
    assert (out[0].node, out[0].handle, out[0].nbytes) == (3, 17, 4096)
    assert out[1] == 5


def test_wireplan_result_arity_convention():
    # () => None, zero bytes
    p0 = WirePlan(())
    p0.pack_result(bytearray(0), 0, None)
    assert p0.unpack_result(b"") is None
    with pytest.raises(SpecMismatchError):
        p0.pack_result(bytearray(0), 0, 1)
    # one spec => bare value
    p1 = WirePlan((ScalarSpec("f8"),))
    b1 = bytearray(8)
    p1.pack_result(b1, 0, 2.5)
    assert p1.unpack_result(b1) == 2.5
    # N specs => tuple
    p2 = WirePlan((ScalarSpec("i8"), ScalarSpec("b1")))
    b2 = bytearray(p2.nbytes)
    p2.pack_result(b2, 0, (4, True))
    assert p2.unpack_result(b2) == (4, True)
    with pytest.raises(SpecMismatchError):
        p2.pack_result(bytearray(p2.nbytes), 0, 4)  # not a tuple


def test_wireplan_rejects_mismatches():
    plan = WirePlan(ECHO_SPECS)
    buf = bytearray(plan.nbytes)
    with pytest.raises(SpecMismatchError):
        plan.pack_args(buf, 0, (1, 2, 3.0))  # arity
    with pytest.raises(SpecMismatchError):
        plan.pack_args(buf, 0, (1, 2, 3.0, np.zeros(5)))  # shape
    with pytest.raises(SpecMismatchError):
        plan.pack_args(buf, 0, (1, 2, 3.0, ARR.astype(np.float32)))  # dtype
    with pytest.raises(SpecMismatchError):
        plan.pack_args(buf, 0, ("x", 2, 3.0, ARR))  # scalar type
    with pytest.raises(SpecMismatchError):
        plan.unpack_args(memoryview(buf)[: plan.nbytes - 1])  # short payload


def test_handler_table_compiles_dense_plan_arrays():
    reg = _make_registry()
    table = reg.table
    k_static = table.key_of("t/add_s")
    k_dyn = table.key_of("t/add_d")
    assert table.arg_plans[k_static] is not None
    assert table.arg_plans[k_static].nbytes == 16
    assert table.result_plans[k_static] is not None
    assert table.arg_plans[k_dyn] is None
    assert table.result_plans[k_dyn] is None
    assert len(table.arg_plans) == len(table.records) == len(table)


# -- wire format + compat ----------------------------------------------------


def _make_registry():
    reg = HandlerRegistry()
    register_internal_handlers(reg)

    def add(a, b):
        return a + b

    def echo(a, b, scale, arr):
        return float(a + b) * scale

    def boom_on(x):
        if x == 13:
            raise ValueError("unlucky thirteen")
        return x * 2

    order: list = []

    def record_order(x):
        order.append(x)
        return x

    i8, f8 = ScalarSpec("i8"), ScalarSpec("f8")
    reg.register(add, arg_specs=(i8, i8), result_specs=(i8,), name="t/add_s")
    reg.register(add, name="t/add_d")
    reg.register(echo, arg_specs=ECHO_SPECS, result_specs=(f8,),
                 name="t/echo_s")
    reg.register(echo, name="t/echo_d")
    reg.register(boom_on, arg_specs=(i8,), result_specs=(i8,),
                 name="t/boom_on")
    reg.register(record_order, arg_specs=(i8,), result_specs=(i8,),
                 name="t/order")
    reg.register(lambda: (3, 2.5), arg_specs=(), result_specs=(i8, f8),
                 name="t/pair")
    reg._order_log = order  # test hook (threads share the list)
    reg.init()
    return reg


def test_static_request_and_reply_carry_flag_static():
    reg = _make_registry()
    table = reg.table
    fab = LocalFabric(2)
    host = NodeRuntime(0, fab.endpoint(0), table, inline=True)
    epw = fab.endpoint(1)  # raw peer endpoint: observe frames on the wire
    host._send_request(1, f2f("t/add_s", 2, 3, registry=reg), 7)
    key, flags, src, mid, payload = decode_fast(epw.recv(timeout=5))
    assert flags & FLAG_STATIC and not flags & FLAG_DYNAMIC
    assert (key, src, mid) == (table.key_of("t/add_s"), 0, 7)
    assert bytes(payload) == bytes(
        mig.pack_static((2, 3), (ScalarSpec("i8"), ScalarSpec("i8")))
    )
    # dynamic handler request with a speccable shape rides the shape-keyed
    # plan cache (FLAG_SHAPED: u16 sig_len | sig | plan-packed leaves)
    host._send_request(1, f2f("t/add_d", 2, 3, registry=reg), 8)
    _, flags, _, _, payload = decode_fast(epw.recv(timeout=5))
    assert flags & FLAG_SHAPED and not flags & (FLAG_STATIC | FLAG_DYNAMIC)
    assert host._shape_cache.unpack_shaped(payload, expect_args=True) == (2, 3)
    # non-speccable args (a string) keep the TLV fallback with FLAG_DYNAMIC
    host._send_request(1, f2f("t/add_d", "a", "b", registry=reg), 8)
    _, flags, _, _, payload = decode_fast(epw.recv(timeout=5))
    assert flags & FLAG_DYNAMIC and not flags & (FLAG_STATIC | FLAG_SHAPED)
    assert mig.unpack_dynamic(payload) == ["a", "b"]
    # a worker runtime replies to the static request with a STATIC reply
    worker = NodeRuntime(1, epw, table)
    host._send_request(1, f2f("t/add_s", 20, 22, registry=reg), 9)
    worker._handle_frame(worker.endpoint.recv(timeout=5))
    key, flags, src, mid, payload = decode_fast(host.endpoint.recv(timeout=5))
    assert flags & FLAG_REPLY and flags & FLAG_STATIC
    assert table.result_plans[key].unpack_result(payload) == 42
    fab.close()


def test_flag_static_less_peer_frame_still_dispatches():
    """Wire compat: a pre-plan peer packs static payloads with flags=0 —
    the receiver's compiled plan must decode it (identical layout)."""
    reg = _make_registry()
    table = reg.table
    fab = LocalFabric(2)
    worker = NodeRuntime(1, fab.endpoint(1), table).start()
    ep0 = fab.endpoint(0)
    key = table.key_of("t/add_s")
    legacy = encode_frame(
        key,
        mig.pack_static((4, 5), (ScalarSpec("i8"), ScalarSpec("i8"))),
        src_node=0, msg_id=21, flags=0,  # no STATIC, no DYNAMIC: old wire
    )
    ep0.send(1, legacy)
    key2, flags2, _, mid2, payload = decode_fast(ep0.recv(timeout=5))
    assert mid2 == 21 and flags2 & FLAG_REPLY and not flags2 & FLAG_ERROR
    if flags2 & FLAG_STATIC:
        assert table.result_plans[key2].unpack_result(payload) == 9
    else:
        assert mig.unpack_dynamic(payload) == 9
    worker.stop()
    fab.close()


def test_flagless_dynamic_reply_still_resolves():
    """A pre-plan peer's reply carries neither STATIC nor DYNAMIC — it must
    decode as TLV (the legacy reply encoding)."""
    reg = _make_registry()
    table = reg.table
    fab = LocalFabric(2)
    host = NodeRuntime(0, fab.endpoint(0), table).start()
    ep1 = fab.endpoint(1)
    msg_id, fut = host.futures.create()
    reply = encode_frame(
        table.key_of("t/add_d"), mig.pack_dynamic(123),
        src_node=1, msg_id=msg_id, flags=FLAG_REPLY,
    )
    ep1.send(0, reply)
    assert fut.get(5) == 123
    host.stop()
    fab.close()


def test_mixed_static_dynamic_traffic_one_stream():
    reg = _make_registry()
    table = reg.table
    fab = LocalFabric(2)
    worker = NodeRuntime(1, fab.endpoint(1), table).start()
    host = NodeRuntime(0, fab.endpoint(0), table, inline=True)
    futs = []
    for i in range(40):
        name = "t/add_s" if i % 2 else "t/add_d"
        futs.append(host.send_async(1, f2f(name, i, i, registry=reg)))
        if i % 10 == 5:  # interleave sync calls into the same stream
            assert host.send_sync(1, f2f("t/echo_s", 1, 2, 3.0, ARR,
                                         registry=reg)) == 9.0
    assert [host._inline_wait(f, 10) for f in futs] == [2 * i for i in range(40)]
    # multi-leaf static result decodes as a tuple
    assert host.send_sync(1, f2f("t/pair", registry=reg)) == (3, 2.5)
    worker.stop()
    fab.close()


def test_static_result_spec_violation_travels_as_error():
    """A handler that returns something violating its declared result spec
    must error the CALLER (plan pack failure => REPLY|ERROR), not kill the
    worker loop."""
    reg = _make_registry()

    def bad():
        return "not an int"

    reg2 = HandlerRegistry()
    register_internal_handlers(reg2)
    reg2.register(bad, arg_specs=(), result_specs=(ScalarSpec("i8"),),
                  name="t/bad_result")
    table = reg2.init()
    fab = LocalFabric(2)
    worker = NodeRuntime(1, fab.endpoint(1), table).start()
    host = NodeRuntime(0, fab.endpoint(0), table, inline=True)
    with pytest.raises(ham.RemoteExecutionError):
        host.send_sync(1, f2f("t/bad_result", registry=reg2))
    # worker survived
    assert host.send_sync(1, f2f("_ham/ping", 4, registry=reg2)) == 4
    worker.stop()
    fab.close()


# -- fused frames ------------------------------------------------------------


def test_send_fused_values_and_order():
    reg = _make_registry()
    table = reg.table
    fab = LocalFabric(2)
    worker = NodeRuntime(1, fab.endpoint(1), table).start()
    host = NodeRuntime(0, fab.endpoint(0), table, inline=True)
    calls = [f2f("t/order", i, registry=reg) for i in range(24)]
    futs = host.send_fused(1, calls)
    assert [host._inline_wait(f, 10) for f in futs] == list(range(24))
    # executed in submission order, in one dispatch pass per frame
    assert reg._order_log == list(range(24))
    # replies to the fused batch came back fused (egress fold on the worker)
    assert worker.stats["fused"] >= 24
    worker.stop()
    fab.close()


def test_fused_error_isolated_to_its_own_future():
    reg = _make_registry()
    table = reg.table
    fab = LocalFabric(2)
    worker = NodeRuntime(1, fab.endpoint(1), table).start()
    host = NodeRuntime(0, fab.endpoint(0), table, inline=True)
    xs = [7, 13, 9, 13, 11]
    futs = host.send_fused(1, [f2f("t/boom_on", x, registry=reg) for x in xs])
    results = []
    for x, f in zip(xs, futs):
        if x == 13:
            with pytest.raises(ham.RemoteExecutionError, match="thirteen"):
                host._inline_wait(f, 10)
            results.append("err")
        else:
            results.append(host._inline_wait(f, 10))
    assert results == [14, "err", 18, "err", 22]
    worker.stop()
    fab.close()


def test_fused_mixed_static_dynamic_segments():
    reg = _make_registry()
    table = reg.table
    fab = LocalFabric(2)
    worker = NodeRuntime(1, fab.endpoint(1), table).start()
    host = NodeRuntime(0, fab.endpoint(0), table, inline=True)
    calls = [f2f("t/add_s", 1, 2, registry=reg),
             f2f("t/add_d", 10, 20, registry=reg),
             f2f("t/echo_s", 1, 2, 3.0, ARR, registry=reg)]
    futs = host.send_fused(1, calls)
    assert [host._inline_wait(f, 10) for f in futs] == [3, 30, 9.0]
    worker.stop()
    fab.close()


def test_fused_single_executor_pass_on_pool_policy():
    reg = _make_registry()
    table = reg.table

    submits = []

    class CountingPolicy(ThreadPoolPolicy):
        def submit(self, fn):
            submits.append(fn)
            super().submit(fn)

    fab = LocalFabric(2)
    worker = NodeRuntime(1, fab.endpoint(1), table,
                         policy=CountingPolicy(2)).start()
    host = NodeRuntime(0, fab.endpoint(0), table, inline=True)
    futs = host.send_fused(1, [f2f("t/add_s", i, i, registry=reg)
                               for i in range(10)])
    assert [host._inline_wait(f, 10) for f in futs] == [2 * i for i in range(10)]
    assert len(submits) == 1  # ten requests, ONE executor submit
    worker.stop()
    fab.close()


def test_send_fused_pack_failure_discards_every_future():
    """All-or-nothing send_fused: a call whose args violate its spec mid-
    batch must raise to the caller AND leave no orphaned FutureTable
    entries (nothing was handed back to wait on)."""
    from repro_torch.core.closure import Function

    reg = _make_registry()
    table = reg.table
    fab = LocalFabric(2)
    host = NodeRuntime(0, fab.endpoint(0), table, inline=True)
    good = f2f("t/add_s", 1, 2, registry=reg)
    bad = Function(good.record, ("x", "y"))  # bypasses f2f validation
    before = host.futures.outstanding()
    with pytest.raises(SpecMismatchError):
        host.send_fused(1, [good] * 70 + [bad])  # bad lands in chunk 2
    assert host.futures.outstanding() == before
    # and nothing hit the wire: all frames pack before any send
    assert fab.endpoint(1).recv(timeout=0.05) is None
    fab.close()


def test_fused_frame_layout_and_truncation():
    reg = _make_registry()
    table = reg.table
    fab = LocalFabric(2)
    host = NodeRuntime(0, fab.endpoint(0), table, inline=True)
    epw = fab.endpoint(1)
    host._send_fused_request(1, [
        (f2f("t/add_s", 1, 2, registry=reg), 101),
        (f2f("t/add_d", 3, 4, registry=reg), 102),
    ])
    frame = epw.recv(timeout=5)
    key, flags, src, mid, payload = decode_fast(frame)
    assert flags & FLAG_FUSED and (key, mid) == (0, 0) and src == 0
    segs = list(iter_fused(payload))
    assert [s[2] for s in segs] == [101, 102]
    assert segs[0][1] & FLAG_STATIC
    # the dynamic call's shape is speccable, so it rides a shaped segment
    assert segs[1][1] & FLAG_SHAPED
    assert host._shape_cache.unpack_shaped(segs[1][3], expect_args=True) == (3, 4)
    # truncated fused payloads must fail loudly, not mis-slice
    with pytest.raises(ham.MessageFormatError):
        list(iter_fused(payload[: len(payload) - 3]))
    with pytest.raises(ham.MessageFormatError):
        list(iter_fused(payload[:2]))
    fab.close()


def test_egress_fusion_skips_relayed_frames():
    """_ham/forward relays a frame whose src is the ORIGIN; folding it into
    a fused frame would rewrite its source and misroute the reply.  Relay
    through a middle node while its egress is busy — the reply must still
    come back to the origin."""
    reg = _make_registry()
    from repro_torch.offload.api import OffloadDomain

    dom = OffloadDomain.local(3, registry=reg)
    try:
        futs = [dom.relay(via=1, dst=2,
                          function=f2f("t/add_s", i, i, registry=reg))
                for i in range(8)]
        assert [f.get(10) for f in futs] == [2 * i for i in range(8)]
    finally:
        dom.shutdown()


# -- scheduler-level fusion --------------------------------------------------


def _cluster_registry():
    from repro_torch.cluster.pool import register_cluster_handlers

    reg = HandlerRegistry()
    register_internal_handlers(reg)
    register_cluster_handlers(reg)
    i8, f8 = ScalarSpec("i8"), ScalarSpec("f8")

    def mul(a, b):
        return float(a * b)

    def boom_on(x):
        if x == 13:
            raise ValueError("unlucky thirteen")
        return x * 2

    reg.register(mul, arg_specs=(i8, f8), result_specs=(f8,), name="t/mul_s")
    reg.register(boom_on, arg_specs=(i8,), result_specs=(i8,),
                 name="t/boom_on")
    reg.init()
    return reg


def test_scheduler_fusion_end_to_end():
    from repro_torch.cluster import ClusterPool, Scheduler, gather

    reg = _cluster_registry()
    pool = ClusterPool.local(2, registry=reg)
    sched = Scheduler(pool, fuse_window=0.002, fuse_max=8)
    try:
        futs = [sched.submit(f2f("t/mul_s", i, 0.5, registry=reg))
                for i in range(64)]
        assert gather(futs, 30) == [i * 0.5 for i in range(64)]
        assert sched.stats["fused_calls"] == 64
        assert sched.outstanding() == 0  # every credit returned
        # error isolation through the scheduler path
        futs = [sched.submit(f2f("t/boom_on", x, registry=reg))
                for x in (7, 13, 9)]
        assert futs[0].get(10) == 14 and futs[2].get(10) == 18
        with pytest.raises(ham.RemoteExecutionError, match="thirteen"):
            futs[1].get(10)
    finally:
        sched.close()
        pool.close()


def test_scheduler_fusion_preserves_order_vs_unfusible():
    """A non-fusible (dynamic) submit to the same target must not overtake
    parked fused calls: per-target submission order is preserved."""
    from repro_torch.cluster import ClusterPool, Scheduler

    reg = HandlerRegistry()
    register_internal_handlers(reg)
    from repro_torch.cluster.pool import register_cluster_handlers

    register_cluster_handlers(reg)
    order: list = []

    def note(x):
        order.append(x)
        return x

    reg.register(note, arg_specs=(ScalarSpec("i8"),),
                 result_specs=(ScalarSpec("i8"),), name="t/note_s")
    reg.register(note, name="t/note_d")
    reg.init()
    pool = ClusterPool.local(1, registry=reg)
    sched = Scheduler(pool, fuse_window=0.5, fuse_max=100)  # window >> test
    try:
        f1 = sched.submit(f2f("t/note_s", 1, registry=reg), node=1)
        f2 = sched.submit(f2f("t/note_s", 2, registry=reg), node=1)
        f3 = sched.submit(f2f("t/note_d", 3, registry=reg), node=1)  # flushes
        assert [f.get(10) for f in (f1, f2, f3)] == [1, 2, 3]
        assert order == [1, 2, 3]
        # and an explicit flush ships a parked tail without waiting
        f4 = sched.submit(f2f("t/note_s", 4, registry=reg), node=1)
        sched.flush()
        assert f4.get(1) == 4
    finally:
        sched.close()
        pool.close()


# -- end to end over a real forked shm worker --------------------------------


@pytest.mark.shm
def test_static_and_fused_roundtrip_over_shm_subprocess():
    """The full fast path against a REAL worker process over shared memory:
    static round trip, fused batch, mixed static/dynamic stream — crossing
    an actual address-space boundary, fresh interpreter (no fork inherit)."""
    from repro_torch.comm.shm import ShmFabric
    from repro_torch.core.registry import default_registry
    from repro_torch.offload.api import OffloadDomain
    from repro_torch.offload.demo_handlers import _ECHO_ARGS
    from repro_torch.offload.worker import reap, spawn_shm_worker_subprocess

    reg = default_registry()
    if not reg.initialised:
        reg.init()
    fab = ShmFabric(2, capacity=1 << 20)
    proc = spawn_shm_worker_subprocess(fab, 1)
    dom = OffloadDomain(fab, registry=reg, inline_host=True)
    try:
        assert dom.ping(1, 3, timeout=30.0) == 3
        call_s = f2f("demo/echo_small_static", *_ECHO_ARGS)
        call_d = f2f("demo/echo_small_dyn", *_ECHO_ARGS)
        assert dom.sync(1, call_s) == 9.0  # static args + static reply
        assert dom.sync(1, call_d) == 9.0  # TLV both ways, same handler
        # fused batch across the process boundary
        futs = dom.host.send_fused(1, [call_s] * 20)
        assert [dom.host._inline_wait(f, 30) for f in futs] == [9.0] * 20
        # mixed stream
        futs = [dom.host.send_async(1, call_s if i % 2 else call_d)
                for i in range(20)]
        assert [dom.host._inline_wait(f, 30) for f in futs] == [9.0] * 20
    finally:
        dom.shutdown()
        reap([proc], timeout=5.0)
