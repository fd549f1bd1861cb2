"""A JAX node and a PyTorch node on one shared-memory fabric.

HAM's heterogeneity made literal: the reference package (``repro``, JAX)
and the port (``repro_torch``, PyTorch) are two different "binaries" that
share nothing but the segment layout and the deterministic handler key map.

* the shm ring's counter layout, header, segment names and the doorbell's
  word layout and protocol orders are equal (the reference's model checker
  builds its models from them);
* a ring created by one package is read byte for byte by the other, with
  batched pushes and pops across the wrap;
* a reference host calls a port fresh-interpreter worker and a port host
  calls a reference fresh-interpreter worker: both pass the digest ping and
  return what the same calls return on a single-package fabric;
* the same seed and schedule give the same chaos ``fault_log`` in both.

The reference worker imports JAX; it runs with ``JAX_PLATFORMS=cpu``.
"""

from __future__ import annotations

import os
import uuid
from types import SimpleNamespace

import numpy as np
import pytest

import repro.cluster.pool as ref_pool
import repro.comm.chaos as ref_chaos
import repro.comm.doorbell as ref_doorbell
import repro.comm.local as ref_local
import repro.comm.shm as ref_shm
import repro.comm.socket as ref_socket
import repro.core.closure as ref_closure
import repro.core.message as ref_message
import repro.core.registry as ref_registry
import repro.offload.api as ref_api
import repro.offload.demo_handlers as ref_demo
import repro.offload.runtime as ref_runtime
import repro.offload.worker as ref_worker
import repro_torch.cluster.pool as port_pool
import repro_torch.comm.chaos as port_chaos
import repro_torch.comm.doorbell as port_doorbell
import repro_torch.comm.local as port_local
import repro_torch.comm.shm as port_shm
import repro_torch.comm.socket as port_socket
import repro_torch.core.closure as port_closure
import repro_torch.core.message as port_message
import repro_torch.core.registry as port_registry
import repro_torch.offload.api as port_api
import repro_torch.offload.demo_handlers as port_demo
import repro_torch.offload.runtime as port_runtime
import repro_torch.offload.worker as port_worker

REF = SimpleNamespace(
    name="repro", pool=ref_pool, chaos=ref_chaos, local=ref_local, shm=ref_shm,
    socket=ref_socket, closure=ref_closure, message=ref_message,
    registry=ref_registry, api=ref_api, demo=ref_demo, runtime=ref_runtime,
    worker=ref_worker,
)
PORT = SimpleNamespace(
    name="repro_torch", pool=port_pool, chaos=port_chaos, local=port_local,
    shm=port_shm, socket=port_socket, closure=port_closure, message=port_message,
    registry=port_registry, api=port_api, demo=port_demo, runtime=port_runtime,
    worker=port_worker,
)
PKGS = {"ref": REF, "port": PORT}

#: the demo and chaos handlers every host table holds, named explicitly
DEMO_HANDLERS = (
    "chaos/bump", "chaos/counts", "chaos/reset", "demo/add",
    "demo/echo_small_dyn", "demo/echo_small_static", "demo/empty",
    "demo/empty_static", "demo/inner_prod", "demo/matmul", "demo/saxpy",
)


# -- (a) layout ----------------------------------------------------------------

SHM_CONSTANTS = (
    "HEAD_OFF", "HEAD_CONFIRM_OFF", "TAIL_OFF", "TAIL_CONFIRM_OFF",
    "COUNTER_CONFIRM_STRIDE", "COUNTER_STABLE_RETRIES", "COUNTER_STORE_ORDER",
    "COUNTER_LOAD_ORDER", "_HDR",
)
DOORBELL_CONSTANTS = (
    "SEQ_OFF", "WAITERS_OFF", "PRODUCER_RING_PROTOCOL", "CONSUMER_PARK_PROTOCOL",
)


def test_segment_layout_and_protocol_constants_equal():
    for name in SHM_CONSTANTS:
        assert getattr(port_shm, name) == getattr(ref_shm, name), name
    for name in DOORBELL_CONSTANTS:
        assert getattr(port_doorbell, name) == getattr(ref_doorbell, name), name
    assert port_doorbell.Doorbell.NBYTES == ref_doorbell.Doorbell.NBYTES
    for prefix in ("ham1_abcd", "x"):
        for src, dst in ((0, 1), (3, 0), (12, 7)):
            assert (port_shm._ring_name(prefix, src, dst)
                    == ref_shm._ring_name(prefix, src, dst))
        for node in (0, 1, 9):
            assert (port_doorbell.bell_name(prefix, node)
                    == ref_doorbell.bell_name(prefix, node))


# -- (b) ring bytes --------------------------------------------------------------


def _frames(seed: int, n: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 1500, size=n)
    return [rng.integers(0, 256, size=int(s), dtype=np.uint8).tobytes() for s in sizes]


@pytest.mark.shm
@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_ring_bytes_identical_across_packages(writer, reader):
    """One package creates a 4 KiB ring and pushes batches whose frames
    straddle the wrap again and again; the other attaches to the same
    segment and pops them with ``pop_many``, byte for byte.  Then the
    roles of pushing and popping swap on the same segment."""
    name = f"ham_interop_{os.getpid()}_{uuid.uuid4().hex[:8]}"
    owner = PKGS[writer].shm.ShmRing(name, capacity=1 << 12, create=True)
    try:
        guest = PKGS[reader].shm.ShmRing(name)
        for producer, consumer, seed in ((owner, guest, 0), (guest, owner, 1)):
            sent, got = _frames(seed, 64), []
            for i in range(0, len(sent), 2):
                producer.push_many(sent[i:i + 2], timeout=1.0)
                lease = consumer.pop_many(max_frames=8)
                got.extend(bytes(v) for v in lease.views)
                lease.release()
                del lease
            assert got == sent
            assert consumer._tail() == consumer._head() == producer._head()
            assert consumer._head() > 10 * owner.capacity  # wrapped many times
        guest.close()
    finally:
        owner.close()
        owner.unlink()


# -- (c) cross-process calls ---------------------------------------------------


def _explicit_registry(pkg):
    """Internal, data-plane and cluster handlers plus the named demo and
    chaos handlers, with the options their module declares: the table a
    worker that imports the demo handlers and the cluster pool derives."""
    reg = pkg.registry.HandlerRegistry()
    pkg.runtime.register_internal_handlers(reg)
    pkg.pool.register_cluster_handlers(reg)
    demo = {r.stable_name.split("#")[0]: r
            for r in pkg.registry.default_registry().pending_records()
            if r.fn.__module__ == pkg.demo.__name__}
    for name in DEMO_HANDLERS:
        r = demo[name]
        reg.register(r.fn, name=name, arg_specs=r.arg_specs,
                     result_specs=r.result_specs, read_only=r.read_only,
                     mutates=r.mutates)
    reg.init()
    return reg


def _calls(pkg, dom, reg, node: int, token: str) -> list:
    """The call sequence both directions run, with the values it returns."""
    def f2f(name, *args):
        return pkg.closure.f2f(name, *args, registry=reg)

    out = [dom.sync(node, f2f("demo/add", np.arange(8.0), np.full(8, 0.5)), 30.0),
           dom.sync(node, f2f("demo/add", np.arange(6, dtype=np.float32).reshape(2, 3),
                              np.float32(2.0)), 30.0)]
    call_s = f2f("demo/echo_small_static", *pkg.demo._ECHO_ARGS)
    call_d = f2f("demo/echo_small_dyn", *pkg.demo._ECHO_ARGS)
    assert reg.table.arg_plans[reg.table.key_of(call_s.record.stable_name)] is not None
    out += [dom.sync(node, call_s, 30.0), dom.sync(node, call_d, 30.0)]
    # fused requests with replies, then a batch of fused oneways
    out.append([f.get(30.0) for f in dom.host.send_fused(node, [call_s, call_d] * 5)])
    dom.host.send_oneway_fused(node, [f2f("chaos/bump", token)] * 24)
    out.append(dom.sync(node, f2f("chaos/counts", token), 30.0))
    out.append(dom.sync(node, f2f("chaos/reset", token), 30.0))
    out.append(dom.sync(node, f2f("demo/empty_static"), 30.0))
    return out


def _plain(values) -> list:
    return [v.tolist() if isinstance(v, np.ndarray) else v for v in values]


def _same_package_values(host) -> list:
    """The same calls on a single-package fabric (the host package's own
    in-process fabric and thread worker)."""
    reg = _explicit_registry(host)
    dom = host.api.OffloadDomain.local(2, registry=reg)
    try:
        return _calls(host, dom, reg, 1, f"local-{uuid.uuid4().hex[:6]}")
    finally:
        dom.shutdown()


@pytest.mark.shm
@pytest.mark.parametrize("host_name,worker_name", [("ref", "port"), ("port", "ref")],
                         ids=["ref_host-port_worker", "port_host-ref_worker"])
def test_cross_package_calls_over_one_shm_fabric(host_name, worker_name, monkeypatch):
    host, worker = PKGS[host_name], PKGS[worker_name]
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")  # the reference worker's JAX
    reg = _explicit_registry(host)
    fab = host.shm.ShmFabric(2, capacity=1 << 20)
    proc = worker.worker.spawn_shm_worker_subprocess(
        fab, 1, [f"{worker.name}.offload.demo_handlers", f"{worker.name}.cluster.pool"])
    dom = host.api.OffloadDomain(fab, registry=reg)
    try:
        assert dom.ping(1, 5, timeout=120.0) == 5
        digest = dom.sync(1, host.closure.f2f("_cluster/digest", registry=reg), 30.0)
        host.registry.verify_peer_digest(reg.table, bytes.fromhex(digest))
        got = _calls(host, dom, reg, 1, "interop")
    finally:
        dom.shutdown()
        worker.worker.reap([proc], timeout=10.0)
        fab.close()
    assert proc.returncode == 0
    want = _same_package_values(host)
    assert _plain(got) == _plain(want)
    assert got[5] == 24  # every fused oneway ran exactly once
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and g.shape == w.shape


# -- (d) chaos -----------------------------------------------------------------

_DET_CFG = dict(drop=0.2, dup=0.15, schedule=((5, 8, "drop"), (12, 14, "deliver")))


def _drive_chaos(pkg, kind: str, seed: int, n: int = 40):
    """Send ``n`` HAM frames 0 -> 1 through a seeded chaos wrapper over one
    package's fabric, drain the receiver; returns (fault_log, msg_ids)."""
    inner = {"local": lambda: pkg.local.LocalFabric(2),
             "shm": lambda: pkg.shm.ShmFabric(2, capacity=1 << 20),
             "socket": lambda: pkg.socket.SocketFabric(2)}[kind]()
    chaos = pkg.chaos.ChaosFabric(inner, seed=seed,
                                  default=pkg.chaos.ChaosConfig(**_DET_CFG))
    try:
        src, dst = chaos.endpoint(0), chaos.endpoint(1)
        chaos.arm()
        for i in range(n):
            src.send(1, pkg.message.encode_frame(0, b"\0" * 8, src_node=0,
                                                 msg_id=i + 1))
        ids, quiet = [], 0
        while quiet < 10:  # 0.5 s of silence: the link has drained
            frames = dst.recv_many(64, timeout=0.05)
            if frames:
                ids.extend(pkg.message.HEADER_STRUCT.unpack_from(f, 0)[5]
                           for f in frames)
                frames = None
                dst.release()
                quiet = 0
            else:
                quiet += 1
        chaos.disarm()
        return list(chaos.fault_log), ids
    finally:
        chaos.close()


@pytest.mark.chaos
@pytest.mark.parametrize("kind,seed", [
    ("local", 7), ("local", 11), ("local", 20260809), ("socket", 11),
    pytest.param("shm", 11, marks=pytest.mark.shm),
])
def test_chaos_fault_log_equal_across_packages(kind, seed):
    ref_log, ref_ids = _drive_chaos(REF, kind, seed)
    port_log, port_ids = _drive_chaos(PORT, kind, seed)
    assert ref_log, "a 35% fault rate over 40 frames must log something"
    assert port_log == ref_log
    assert port_ids == ref_ids
