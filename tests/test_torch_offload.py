"""The port's counterpart of tests/test_offload.py, on the local fabric and,
for the oversized-reply case, a fresh-interpreter worker over shm.

HAM-Offload behaviour: the paper §2 surface end to end."""

import time

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


@pytest.mark.shm
def test_oversized_reply_errors_instead_of_killing_worker():
    """A reply that exceeds the transport frame limit must come back as a
    RemoteExecutionError — not silently kill the worker's event loop and
    strand the caller in a timeout.

    The worker is a *fresh interpreter* attached over shm, not a fork: by
    the time this test runs, earlier tests have imported torch and started
    its threads, and ``os.fork()`` in a multithreaded process risks exactly
    that deadlock — spawning avoids the hazard instead of suppressing the
    warning."""
    from repro_torch.comm.shm import ShmFabric
    from repro_torch.core.registry import default_registry
    from repro_torch.offload.worker import reap, spawn_shm_worker_subprocess

    # subprocess workers re-init the default registry, so the host must use
    # it too (same-source assumption): internal _ham handlers are enough here
    reg = default_registry()
    if not reg.initialised:
        reg.init()
    fab = ShmFabric(2, capacity=1 << 20)  # 1 MB rings
    proc = spawn_shm_worker_subprocess(fab, 1)
    dom = OffloadDomain(fab, registry=reg)
    try:
        assert dom.ping(1, 3, timeout=30.0) == 3
        n = (1 << 21) // 8  # 2 MB buffer
        ptr = dom.allocate(1, (n,), "float64")
        dom.put(np.ones(n), ptr)  # put auto-chunks to the ring size
        with pytest.raises(ham.RemoteExecutionError, match="capacity"):
            dom.get(ptr)  # unchunked 2 MB reply cannot fit a 1 MB ring
        # the worker survived and still serves requests
        assert dom.ping(1, 7, timeout=10.0) == 7
        got = dom.get(ptr, count=n, chunk_count=(1 << 19) // 8)
        assert got.size == n and got[0] == 1.0
        dom.free(ptr)
    finally:
        dom.shutdown()
        reap([proc], timeout=5.0)

@pytest.mark.shm
def test_fresh_interpreter_shm_worker_killed_respawned_answers():
    """Kill a fresh-interpreter shm worker, respawn it under the same node
    id and call it again.  Before Python 3.13 an interpreter that attaches
    a segment registers it with its own resource tracker, which unlinks it
    when that interpreter dies: the reference's worker takes the host's
    live rings with it and the respawn finds nothing to attach.  The port's
    worker leaves segment lifetime to the fabric owner."""
    import os

    from repro_torch.comm.shm import ShmFabric
    from repro_torch.core.registry import default_registry
    from repro_torch.offload.worker import reap, spawn_shm_worker_subprocess

    reg = default_registry()
    if not reg.initialised:
        reg.init()
    fab = ShmFabric(2, capacity=1 << 20)
    segments = sorted(f for f in os.listdir("/dev/shm") if f.startswith(fab.prefix))
    procs = [spawn_shm_worker_subprocess(fab, 1)]
    dom = OffloadDomain(fab, registry=reg)
    try:
        assert dom.ping(1, 3, timeout=30.0) == 3
        procs[0].kill()
        procs[0].wait(10.0)
        time.sleep(0.5)  # the dead interpreter's resource tracker has exited
        assert sorted(f for f in os.listdir("/dev/shm")
                      if f.startswith(fab.prefix)) == segments
        fab.prepare_restart(1)
        dom.host.endpoint.reset_peer(1)
        procs.append(spawn_shm_worker_subprocess(fab, 1))
        assert dom.ping(1, 4, timeout=30.0) == 4
        ptr = dom.allocate(1, (1024,), "float64")
        dom.put(np.arange(1024.0), ptr)
        np.testing.assert_array_equal(dom.get(ptr), np.arange(1024.0))
    finally:
        dom.shutdown()
        reap(procs, timeout=5.0)
        fab.close()
    assert not any(f.startswith(fab.prefix) for f in os.listdir("/dev/shm"))


@pytest.mark.shm
def test_fresh_shm_worker_untracks_only_the_fabric_segments():
    """A fresh-interpreter shm worker leaves the fabric's own segments
    (``{prefix}_...``) to the fabric owner, but any other shared memory it
    creates, as a handler module might, stays with its resource tracker,
    which unlinks it when the interpreter exits without doing so."""
    import os
    import subprocess
    import sys
    import uuid

    import repro_torch

    stem = f"test_torch_tracker_{os.getpid()}_{uuid.uuid4().hex[:8]}"
    owned, other = f"{stem}_0_1", f"{stem}x_other"
    code = (
        "from multiprocessing import shared_memory\n"
        "from repro_torch.offload.worker import _leave_segments_to_the_fabric\n"
        f"_leave_segments_to_the_fabric({stem!r})\n"
        f"for name in ({owned!r}, {other!r}):\n"
        "    shared_memory.SharedMemory(name, create=True, size=64).close()\n"
    )
    src = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
    env = dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    try:
        subprocess.run([sys.executable, "-c", code], env=env, check=True,
                       capture_output=True, timeout=60)
        deadline = time.monotonic() + 10.0  # the tracker outlives its interpreter briefly
        while os.path.exists(f"/dev/shm/{other}") and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not os.path.exists(f"/dev/shm/{other}"), "a handler's segment went untracked"
        assert os.path.exists(f"/dev/shm/{owned}"), "the tracker unlinked a fabric segment"
    finally:
        for name in (owned, other):
            if os.path.exists(f"/dev/shm/{name}"):
                os.unlink(f"/dev/shm/{name}")


def test_put_and_call_take_cpu_tensors(dom):
    """A ``torch.Tensor`` goes wherever the reference takes a ``jax.Array``:
    as a call argument and as the source of a put (its host copy; a CUDA
    tensor is staged through pinned memory, which the chip check drives)."""
    import torch

    dom.direct_data_plane = False  # the wire path, as a process worker sees it
    t = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    ptr = dom.allocate(1, (8, 8), "float32")
    dom.put(t, ptr)
    np.testing.assert_array_equal(dom.get(ptr), t.numpy())
    assert dom.sync(1, _f2f(dom.registry, "t/double", t)).tolist() == (t * 2).tolist()
    dom.direct_data_plane = True
    dom.put(t + 1, ptr)
    np.testing.assert_array_equal(dom.get(ptr), t.numpy() + 1)



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
