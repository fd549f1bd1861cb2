"""The port's counterpart of tests/test_offload.py, on the local
fabric (the shm case waits for ROADMAP item 11b).

HAM-Offload behaviour: the paper §2 surface end to end."""

import numpy as np
import pytest

from repro_torch.core import errors as ham
from repro_torch.core.closure import f2f
from repro_torch.core.executor import ThreadPoolPolicy
from repro_torch.core.registry import HandlerRegistry
from repro_torch.offload.api import OffloadDomain, deref
from repro_torch.offload.buffer import BufferPtr, BufferRegistry
from repro_torch.offload.runtime import current_node, register_internal_handlers


def _make_registry():
    reg = HandlerRegistry()
    register_internal_handlers(reg)

    def inner_prod(a_ptr, b_ptr, n):
        a, b = deref(a_ptr), deref(b_ptr)
        return float(a[:n] @ b[:n])

    def boom():
        raise ValueError("intentional failure")

    def reverse(host_node):
        node = current_node()
        fut = node.send_async(host_node, f2f("_ham/ping", 7, registry=reg))
        return node.wait(fut, 10.0)

    reg.register(inner_prod, name="t/inner_prod")
    reg.register(boom, name="t/boom")
    reg.register(reverse, name="t/reverse")
    reg.register(lambda x: x * 2, name="t/double")
    reg.init()
    return reg


def _f2f(reg, name, *args):
    return f2f(name, *args, registry=reg)


@pytest.fixture
def dom():
    reg = _make_registry()
    d = OffloadDomain.local(3, registry=reg)
    yield d
    d.shutdown()


def test_sync_offload(dom):
    assert dom.sync(1, _f2f(dom.registry, "t/double", 21)) == 42


def test_chunked_put_get_roundtrip():
    """Large WIRE-path transfers split into pipelined segments reassemble
    exactly (direct_data_plane off so the chunking machinery actually runs)."""
    reg = _make_registry()
    dom = OffloadDomain.local(2, registry=reg)
    dom.direct_data_plane = False
    try:
        n = 1 << 16
        ptr = dom.allocate(1, (n,), "float64")
        arr = np.arange(n, dtype=np.float64)
        dom.put(arr, ptr, chunk_nbytes=1 << 14)  # force 32 in-flight segments
        np.testing.assert_array_equal(dom.get(ptr), arr)
        part = dom.get(ptr, offset=100, count=1000, chunk_count=128)
        np.testing.assert_array_equal(part, arr[100:1100])
        dom.free(ptr)
    finally:
        dom.shutdown()


def test_direct_and_wire_data_plane_agree(dom):
    """The in-process direct data plane and the wire path are observationally
    identical (shape, dtype, offsets, partial reads)."""
    arr = np.arange(512, dtype=np.float64).reshape(32, 16)
    ptr = dom.allocate(1, arr.shape, "float64")
    assert dom.direct_data_plane  # default on for in-process workers
    dom.put(arr, ptr)
    direct = dom.get(ptr)
    direct_part = dom.get(ptr, offset=8, count=100)
    dom.direct_data_plane = False
    wire = dom.get(ptr)
    wire_part = dom.get(ptr, offset=8, count=100)
    dom.direct_data_plane = True
    assert direct.shape == wire.shape == arr.shape
    np.testing.assert_array_equal(direct, wire)
    np.testing.assert_array_equal(direct, arr)
    np.testing.assert_array_equal(direct_part, wire_part)
    # results are snapshots, not live views into the buffer
    dom.put(np.zeros_like(arr), ptr)
    np.testing.assert_array_equal(direct, arr)
    dom.free(ptr)


def test_async_futures_complete_out_of_order(dom):
    futs = [dom.async_(1 + (i % 2), _f2f(dom.registry, "t/double", i))
            for i in range(10)]
    assert [f.get(10) for f in futs] == [2 * i for i in range(10)]


def test_allocate_put_get_free(dom):
    a = np.arange(64, dtype=np.float64)
    ptr = dom.allocate(2, (64,), "float64")
    dom.put(a, ptr)
    np.testing.assert_array_equal(dom.get(ptr), a)
    # partial get with offset
    np.testing.assert_array_equal(dom.get(ptr, offset=10, count=5), a[10:15])
    dom.free(ptr)
    with pytest.raises(ham.RemoteExecutionError):
        dom.get(ptr)


def test_offloaded_compute_on_buffers(dom):
    a = np.arange(128.0)
    b = np.ones(128)
    pa = dom.allocate(1, (128,), "float64")
    pb = dom.allocate(1, (128,), "float64")
    dom.put(a, pa)
    dom.put(b, pb)
    assert dom.sync(1, _f2f(dom.registry, "t/inner_prod", pa, pb, 128)) == a @ b


def test_remote_exception_propagates(dom):
    with pytest.raises(ham.RemoteExecutionError, match="intentional"):
        dom.sync(1, _f2f(dom.registry, "t/boom"))
    # domain still alive
    assert dom.ping(1, 5) == 5


def test_reverse_offload(dom):
    assert dom.sync(2, _f2f(dom.registry, "t/reverse", 0)) == 7


def test_relay_offload_over_fabric(dom):
    fut = dom.relay(via=1, dst=2, function=_f2f(dom.registry, "t/double", 8))
    assert fut.get(10) == 16


def test_barrier(dom):
    dom.barrier()


def test_threadpool_policy_domain():
    reg = _make_registry()
    d = OffloadDomain.local(2, registry=reg,
                            policy_factory=lambda: ThreadPoolPolicy(2))
    try:
        assert d.sync(1, _f2f(reg, "t/double", 4)) == 8
    finally:
        d.shutdown()


def test_buffer_registry_rules():
    br = BufferRegistry(3)
    ptr = br.allocate((4, 4), "float32")
    assert ptr.node == 3
    assert br.deref(ptr).shape == (4, 4)
    with pytest.raises(ham.OffloadError):
        br.deref(BufferPtr(1, ptr.handle))  # wrong address space (§4.1)
    br.free(ptr)
    with pytest.raises(ham.OffloadError):
        br.free(ptr)
    assert br.live_count() == 0


def test_oneway_fire_and_forget(dom):
    dom.oneway(1, _f2f(dom.registry, "t/double", 1))
    dom.barrier()  # drains; no reply expected, no crash
