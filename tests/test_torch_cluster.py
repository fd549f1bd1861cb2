"""The port's cluster pool + scheduler (counterpart of tests/test_cluster.py):
routing policies, credit flow control, pipelined completions, worker
death/restart and elastic membership on thread workers; worker death,
restart, elastic membership and shm segment hygiene on forked processes;
and every process entry point starting a worker that answers."""

import os
import time

import numpy as np
import pytest

import repro_torch.cluster.pool  # noqa: F401 — registers _cluster/* at collection,
#                            before any test seals the default registry
import repro_torch.offload.demo_handlers  # noqa: F401 — registers demo/* at collection
from repro_torch.cluster import ClusterPool, Scheduler, as_completed, gather
from repro_torch.cluster.pool import register_cluster_handlers
from repro_torch.core.closure import f2f
from repro_torch.core.errors import (
    NodeDownError,
    OffloadError,
    RemoteExecutionError,
)
from repro_torch.core.registry import HandlerRegistry, default_registry, verify_peer_digest
from repro_torch.offload.runtime import register_internal_handlers


def _registry():
    reg = HandlerRegistry()
    register_internal_handlers(reg)
    register_cluster_handlers(reg)
    reg.init()
    return reg


@pytest.fixture
def pool():
    p = ClusterPool.local(3, registry=_registry())
    yield p
    p.close()


def _sleep(reg, seconds):
    return f2f("_cluster/sleep", seconds, registry=reg)


def _spin(reg, n=10):
    return f2f("_cluster/spin", n, registry=reg)


# -- routing policies --------------------------------------------------------


def test_round_robin_spreads_evenly(pool):
    sched = Scheduler(pool, policy="round_robin")
    futs = [sched.submit(_spin(pool.domain.registry)) for _ in range(9)]
    assert gather(futs, 30) == [45] * 9
    assert sorted(sched.stats["routed"].values()) == [3, 3, 3]


def test_least_outstanding_avoids_busy_worker(pool):
    reg = pool.domain.registry
    sched = Scheduler(pool, policy="least_outstanding", max_inflight=8)
    # pile outstanding calls on node 1, then policy-route a burst: node 1's
    # queue depth (3) always exceeds any transient depth on nodes 2/3 (<=1
    # spin in flight each), so the burst must avoid it
    busy = [sched.submit(_sleep(reg, 0.5), node=1) for _ in range(3)]
    futs = [sched.submit(_spin(reg)) for _ in range(6)]
    gather(futs, 30)
    gather(busy, 10)
    assert sched.stats["routed"][1] == 3  # the pinned calls only
    assert sched.stats["routed"][2] + sched.stats["routed"][3] == 6


def test_locality_routes_to_buffer_owner(pool):
    reg = pool.domain.registry
    sched = Scheduler(pool, policy="locality")
    dom = pool.domain
    arr = np.arange(16.0)
    for target in (1, 2, 3):
        ptr = dom.allocate(target, arr.shape, "float64")
        dom.put(arr, ptr)
        fut = sched.submit(f2f("_cluster/touch", ptr, registry=reg))
        assert fut.get(10) == arr.sum()
    # every call ran on its buffer's owner — a remote deref would have
    # raised (pointers are only valid in their own address space)
    assert sched.stats["routed"] == {1: 1, 2: 1, 3: 1}
    assert sched.stats["locality_hits"] == 3


def test_locality_falls_back_without_votes(pool):
    sched = Scheduler(pool, policy="locality")
    assert sched.submit(_spin(pool.domain.registry)).get(10) == 45
    assert sched.stats["locality_hits"] == 0


# -- pipelining --------------------------------------------------------------


def test_as_completed_yields_in_completion_order(pool):
    reg = pool.domain.registry
    sched = Scheduler(pool, max_inflight=4)
    slow = sched.submit(_sleep(reg, 0.4), node=1)
    fast = [sched.submit(_sleep(reg, 0.01), node=2) for _ in range(3)]
    order = list(as_completed([slow, *fast], timeout=30))
    assert order[-1] is slow  # the slow call finishes last
    assert set(order) == {slow, *fast}


def test_pipelined_submits_overlap_across_workers(pool):
    """The acceptance property at test scale: many in-flight sleeps across
    3 workers must beat the serial round-trip floor by ~worker count."""
    reg = pool.domain.registry
    sched = Scheduler(pool, max_inflight=16)
    n, per_call = 30, 0.02
    t0 = time.perf_counter()
    gather([sched.submit(_sleep(reg, per_call)) for _ in range(n)], 60)
    dt = time.perf_counter() - t0
    assert dt < n * per_call * 0.75  # strictly better than serial execution


def test_gather_orders_by_submission(pool):
    reg = pool.domain.registry
    sched = Scheduler(pool)
    futs = [sched.submit(f2f("_cluster/spin", i, registry=reg))
            for i in (3, 5, 7)]
    assert gather(futs, 30) == [3, 10, 21]


# -- credit-based flow control ----------------------------------------------


def test_backpressure_blocks_then_raises(pool):
    reg = pool.domain.registry
    sched = Scheduler(pool, max_inflight=2, submit_timeout=0.3)
    held = [sched.submit(_sleep(reg, 0.8), node=1) for _ in range(2)]
    t0 = time.perf_counter()
    with pytest.raises(OffloadError, match="backpressure"):
        sched.submit(_sleep(reg, 0.8), node=1)  # no credit on node 1
    assert 0.25 < time.perf_counter() - t0 < 2.0  # blocked, then gave up
    gather(held, 30)
    # credits returned on completion: the same pinned submit works now
    assert sched.submit(_sleep(reg, 0.01), node=1).get(10) == 0.01


def test_policy_routes_around_saturated_worker(pool):
    reg = pool.domain.registry
    sched = Scheduler(pool, max_inflight=1, submit_timeout=5.0)
    blocker = sched.submit(_sleep(reg, 0.5), node=1)
    t0 = time.perf_counter()
    futs = [sched.submit(_spin(reg)) for _ in range(4)]
    gather(futs, 30)
    # the burst never waited on node 1's credit
    assert time.perf_counter() - t0 < 0.45
    assert sched.stats["routed"][1] == 1  # only the blocker
    blocker.get(10)


# -- worker failure (thread pool) -------------------------------------------


def test_thread_worker_death_fails_queued_calls_and_reroutes(pool):
    reg = pool.domain.registry
    sched = Scheduler(pool, max_inflight=8)
    # occupy node 1 (let its loop start executing the sleep), then queue
    # more work behind it
    running = sched.submit(_sleep(reg, 0.3), node=1)
    time.sleep(0.1)
    queued = [sched.submit(_spin(reg), node=1) for _ in range(3)]
    pool.kill(1)  # stops the event loop: queued frames are never drained
    deadline = time.time() + 10
    while 1 in sched.live_nodes() and time.time() < deadline:
        time.sleep(0.02)
    assert sched.live_nodes() == [2, 3]
    for f in queued:
        with pytest.raises(RemoteExecutionError, match="died"):
            f.get(10)
    assert sched.stats["failed_inflight"] >= 3
    # policy traffic reroutes to the survivors
    assert sched.submit(_spin(reg)).get(10) == 45
    with pytest.raises(NodeDownError):
        sched.submit(_spin(reg), node=1)
    del running  # may have completed or failed depending on drain timing

    pool.restart(1)
    deadline = time.time() + 10
    while 1 not in sched.live_nodes() and time.time() < deadline:
        time.sleep(0.02)
    assert sched.live_nodes() == [1, 2, 3]
    assert sched.submit(_spin(reg), node=1).get(10) == 45


# -- elastic membership -------------------------------------------------------


def test_add_node_joins_scheduler_and_takes_traffic(pool):
    reg = pool.domain.registry
    sched = Scheduler(pool, policy="round_robin")
    new = pool.add_node()
    assert new == 4  # ids are monotonic, never reused
    assert sched.live_nodes() == [1, 2, 3, 4]
    futs = [sched.submit(_spin(reg)) for _ in range(8)]
    assert gather(futs, 30) == [45] * 8
    assert sched.stats["routed"][new] >= 2  # round robin includes the joiner
    # the new node is individually addressable too
    assert sched.submit(_spin(reg), node=new).get(10) == 45


def test_remove_node_drain_finishes_inflight_then_fences(pool):
    reg = pool.domain.registry
    sched = Scheduler(pool, max_inflight=8)
    inflight = [sched.submit(_sleep(reg, 0.3), node=3) for _ in range(3)]
    pool.remove_node(3, drain=True)  # blocks: fence, drain, retire
    # drained calls completed normally — nothing was failed
    assert gather(inflight, 5) == [0.3] * 3
    assert sched.stats["failed_inflight"] == 0
    assert sched.live_nodes() == [1, 2]
    with pytest.raises(NodeDownError):
        sched.submit(_spin(reg), node=3)
    # the id is retired from the pool and the fabric
    assert 3 not in pool.worker_nodes
    assert 3 not in pool.fabric.nodes()


def test_remove_node_without_drain_fails_inflight(pool):
    reg = pool.domain.registry
    sched = Scheduler(pool, max_inflight=8)
    running = sched.submit(_sleep(reg, 0.2), node=2)
    time.sleep(0.05)  # let the worker start executing
    queued = [sched.submit(_sleep(reg, 5.0), node=2) for _ in range(2)]
    pool.remove_node(2, drain=False)
    for f in queued:
        with pytest.raises(RemoteExecutionError, match="died"):
            f.get(10)
    assert sched.live_nodes() == [1, 3]
    del running  # may have completed or failed depending on kill timing


def test_elastic_resize_under_continuous_traffic():
    """The PR's acceptance property: a live pool grows 2 -> 4 and shrinks
    back to 2 (drained) while a continuous submit stream observes ZERO
    failed calls."""
    import threading

    pool = ClusterPool.local(2, registry=_registry())
    try:
        reg = pool.domain.registry
        sched = Scheduler(pool, max_inflight=8)
        stop = threading.Event()
        futs: list = []
        submit_errors: list = []

        def stream():
            while not stop.is_set():
                try:
                    futs.append(sched.submit(_sleep(reg, 0.003)))
                except Exception as e:  # noqa: BLE001 — the assertion target
                    submit_errors.append(e)

        t = threading.Thread(target=stream)
        t.start()
        try:
            time.sleep(0.15)
            added = [pool.add_node(), pool.add_node()]
            assert sched.live_nodes() == [1, 2, *added]
            time.sleep(0.25)  # let traffic spread over 4 workers
            for node in added:
                pool.remove_node(node, drain=True)
            assert sched.live_nodes() == [1, 2]
            time.sleep(0.1)
        finally:
            stop.set()
            t.join()
        results = gather(futs, 120)  # fail-fast on any errored future
        assert submit_errors == []
        assert len(results) > 50
        assert all(r == 0.003 for r in results)
        # the transient workers really carried traffic
        assert all(sched.stats["routed"].get(n, 0) > 0 for n in added)
    finally:
        pool.close()


# -- sticky sessions ----------------------------------------------------------


def test_sessions_stick_across_resize_and_replace_on_death(pool):
    reg = pool.domain.registry
    sched = Scheduler(pool, max_inflight=8)
    keys = [f"s{i}" for i in range(12)]
    for k in keys:
        assert sched.submit(_spin(reg), session=k).get(10) == 45
    placement = {k: sched.sessions.lookup(k) for k in keys}
    assert set(placement.values()) <= {1, 2, 3}

    # an unrelated grow must not move any pinned session
    new = pool.add_node()
    for k in keys:
        sched.submit(_spin(reg), session=k).get(10)
    assert {k: sched.sessions.lookup(k) for k in keys} == placement

    # kill one session-owning worker: only ITS sessions re-place
    victim = placement[keys[0]]
    victims = [k for k, n in placement.items() if n == victim]
    pool.kill(victim)
    deadline = time.time() + 10
    while victim in sched.live_nodes() and time.time() < deadline:
        time.sleep(0.02)
    for k in keys:
        sched.submit(_spin(reg), session=k).get(10)
    after = {k: sched.sessions.lookup(k) for k in keys}
    for k in keys:
        if k in victims:
            assert after[k] != victim and after[k] in sched.live_nodes()
        else:
            assert after[k] == placement[k]
    assert sched.stats["session_routed"] == 3 * len(keys)
    del new


def test_session_submits_respect_credits(pool):
    reg = pool.domain.registry
    sched = Scheduler(pool, max_inflight=2, submit_timeout=0.3)
    held = [sched.submit(_sleep(reg, 0.8), session="hot") for _ in range(2)]
    with pytest.raises(OffloadError, match="backpressure"):
        sched.submit(_sleep(reg, 0.8), session="hot")  # pinned worker full
    gather(held, 30)


# -- queue-depth feedback -----------------------------------------------------


def test_depth_reports_route_second_scheduler_around_busy_worker(pool):
    """Remote queue depth covers load the host-side in-flight count cannot
    see: a second scheduler (fresh counters) must avoid the worker another
    scheduler buried in work, purely from _cluster/stats reports."""
    reg = pool.domain.registry
    sched_a = Scheduler(pool, max_inflight=8)
    busy = [sched_a.submit(_sleep(reg, 0.5), node=1) for _ in range(5)]
    time.sleep(0.3)  # let the worker report its backlog
    assert pool.host.peer_depth.get(1, 0) > 0
    sched_b = Scheduler(pool, policy="least_outstanding", max_inflight=8)
    futs = [sched_b.submit(_spin(reg)) for _ in range(4)]
    assert gather(futs, 30) == [45] * 4
    assert sched_b.stats["routed"].get(1, 0) == 0  # avoided the buried node
    gather(busy, 30)


def test_depth_reports_decay_to_zero_when_idle(pool):
    reg = pool.domain.registry
    sched = Scheduler(pool, max_inflight=8)
    gather([sched.submit(_sleep(reg, 0.1), node=1) for _ in range(4)], 30)
    deadline = time.time() + 5
    while pool.host.peer_depth.get(1, 0) != 0 and time.time() < deadline:
        time.sleep(0.02)
    assert pool.host.peer_depth.get(1, 0) == 0  # idle worker retracted it
    del sched


# -- byte-weighted locality ---------------------------------------------------


def test_locality_routes_to_byte_heavy_node(pool):
    """The locality-weighting regression: a node owning ONE big buffer must
    win against a node owning MANY small ones (votes weigh nbytes)."""
    reg = pool.domain.registry
    sched = Scheduler(pool, policy="locality")
    dom = pool.domain
    smalls = [dom.allocate(1, (1,), "float64") for _ in range(3)]  # 24 B
    big = dom.allocate(2, (1 << 16,), "float64")                   # 512 KB
    fn = f2f("_cluster/touch", (big, *smalls), registry=reg)
    # routing only (the probe handler takes a single ptr): the pick must
    # follow the bytes, not the 3-pointer majority on node 1
    assert sched._pick(fn) == 2
    # and an executed call on the big buffer lands on its owner
    dom.put(np.ones(1 << 16), big)
    assert sched.submit(
        f2f("_cluster/touch", big, registry=reg)
    ).get(10) == float(1 << 16)
    assert sched.stats["routed"][2] == 1


# -- worker failure (forked processes over shm) ------------------------------


def _default_registry_ready():
    reg = default_registry()
    register_cluster_handlers(reg)  # no-op if already present/sealed
    if not reg.initialised:
        reg.init()
    return reg


@pytest.mark.fork
def test_fork_worker_killed_mid_stream_fails_inflight_and_reroutes():
    """The failure-semantics contract, against a REAL process death:
    kill one forked worker while its calls are in flight; the scheduler
    must mark it dead, fail those futures with RemoteExecutionError, and
    route subsequent calls to the survivor."""
    reg = _default_registry_ready()
    pool = ClusterPool.shm(2, registry=reg)
    try:
        sched = Scheduler(pool, policy="round_robin", max_inflight=8)
        pool.ping_all()
        inflight = [sched.submit(_sleep(reg, 3.0), node=1) for _ in range(3)]
        time.sleep(0.2)  # let the worker start executing
        pool.kill(1)
        deadline = time.time() + 10
        while 1 in sched.live_nodes() and time.time() < deadline:
            time.sleep(0.05)
        assert sched.live_nodes() == [2], "scheduler must mark the corpse dead"
        for f in inflight:
            with pytest.raises(RemoteExecutionError, match="died"):
                f.get(10)
        assert sched.stats["failed_inflight"] == 3
        results = gather([sched.submit(_spin(reg)) for _ in range(4)], 30)
        assert results == [45] * 4
        assert sched.stats["routed"][2] >= 4  # everything rerouted
    finally:
        pool.close()


@pytest.mark.fork
def test_fork_worker_restart_rejoins_pool():
    reg = _default_registry_ready()
    pool = ClusterPool.shm(2, registry=reg)
    try:
        sched = Scheduler(pool, max_inflight=4)
        pool.ping_all()
        pool.kill(1)
        deadline = time.time() + 10
        while 1 in sched.live_nodes() and time.time() < deadline:
            time.sleep(0.05)
        pool.restart(1)
        deadline = time.time() + 10
        while 1 not in sched.live_nodes() and time.time() < deadline:
            time.sleep(0.05)
        assert sched.live_nodes() == [1, 2]
        assert sched.submit(_spin(reg), node=1).get(20) == 45
    finally:
        pool.close()


@pytest.mark.fork
def test_fork_elastic_add_remove_node_under_traffic():
    """Elastic membership over a REAL process fabric: grow a forked shm
    pool under traffic (ring creation + attach_peer broadcast + spawn +
    digest verify), then drain-remove the newcomer and reclaim its rings."""
    reg = _default_registry_ready()
    pool = ClusterPool.shm(2, registry=reg)
    try:
        sched = Scheduler(pool, max_inflight=8)
        pool.ping_all()
        inflight = [sched.submit(_sleep(reg, 0.05)) for _ in range(8)]
        new = pool.add_node()
        assert new == 3
        assert sched.live_nodes() == [1, 2, 3]
        # traffic reaches the newcomer, pinned and policy-routed
        assert sched.submit(_spin(reg), node=new).get(20) == 45
        results = gather(
            [sched.submit(_spin(reg)) for _ in range(12)] + inflight, 30
        )
        assert results[:12] == [45] * 12
        assert sched.stats["routed"][new] >= 1

        pool.remove_node(new, drain=True)
        assert sched.live_nodes() == [1, 2]
        assert sched.stats["failed_inflight"] == 0
        # the retired node's ring segments are unlinked immediately
        assert not any(
            f.startswith(pool.fabric.prefix) and f.endswith("_3")
            or f.startswith(f"{pool.fabric.prefix}_3_")
            for f in os.listdir("/dev/shm")
        )
        assert gather([sched.submit(_spin(reg)) for _ in range(4)], 30) \
            == [45] * 4
    finally:
        pool.close()


@pytest.mark.fork
def test_shm_segments_unlinked_even_when_child_dies():
    """The segment-leak contract: a child killed mid-run must not leave
    its fabric's segments in /dev/shm after ClusterPool.close()."""
    reg = _default_registry_ready()
    pool = ClusterPool.shm(2, registry=reg)
    prefix = pool.fabric.prefix
    pool.ping_all()
    assert any(f.startswith(prefix) for f in os.listdir("/dev/shm"))
    pool.kill(1)
    time.sleep(0.3)
    pool.close()
    assert not any(f.startswith(prefix) for f in os.listdir("/dev/shm"))
    # close() reaped the children too
    for handle in pool._workers.values():
        assert not handle.alive()


def _demo_add(reg):
    return f2f("demo/add", np.arange(4.0), np.full(4, 2.0), registry=reg)


def _start(entry, reg):
    """Start one worker through ``entry``; returns (domain, node, close)."""
    from repro_torch.comm.shm import ShmFabric
    from repro_torch.comm.socket import SocketFabric
    from repro_torch.offload import worker
    from repro_torch.offload.api import OffloadDomain

    if entry in ("pool_shm", "pool_socket"):
        make = ClusterPool.shm if entry == "pool_shm" else ClusterPool.socket
        pool = make(1, registry=reg)
        return pool.domain, 1, pool.close
    if entry == "spawn_socket_worker_subprocess":
        fab = SocketFabric(2)
        procs = [worker.spawn_socket_worker_subprocess(1, 2, fab.base_port)]
    else:
        fab = ShmFabric(2, capacity=1 << 20)
        procs = (worker.spawn_shm_workers(fab, [1]) if entry == "spawn_shm_workers"
                 else [worker.spawn_shm_worker_subprocess(fab, 1)])
    dom = OffloadDomain(fab, registry=reg)

    def close():
        try:
            dom.shutdown()
            worker.reap(procs, timeout=5.0)
        finally:
            fab.close()

    return dom, 1, close


@pytest.mark.parametrize("entry", [
    pytest.param("pool_shm", marks=pytest.mark.fork),
    pytest.param("pool_socket"),
    pytest.param("spawn_shm_workers", marks=pytest.mark.fork),
    pytest.param("spawn_socket_worker_subprocess"),
    pytest.param("spawn_shm_worker_subprocess", marks=pytest.mark.shm),
])
def test_process_entry_points_start_and_answer(entry):
    """Every process entry point starts a real worker process (forked, or a
    fresh interpreter), which passes the digest ping, answers ``demo/add``
    and is reaped: none falls back to thread workers."""
    reg = _default_registry_ready()
    dom, node, close = _start(entry, reg)
    try:
        assert node not in dom._inproc  # a process, not a thread worker
        digest = dom.sync(node, f2f("_cluster/digest", registry=reg), 60.0)
        verify_peer_digest(reg.table, bytes.fromhex(digest))
        np.testing.assert_array_equal(dom.sync(node, _demo_add(reg), 30.0),
                                      np.arange(4.0) + 2.0)
    finally:
        close()


# -- misc --------------------------------------------------------------------


def test_no_live_workers_raises(pool):
    sched = Scheduler(pool, max_inflight=2)
    for n in pool.worker_nodes:
        pool.kill(n)
    deadline = time.time() + 10
    while sched.live_nodes() and time.time() < deadline:
        time.sleep(0.02)
    with pytest.raises(OffloadError, match="no live workers"):
        sched.submit(_spin(pool.domain.registry))


def test_unknown_policy_rejected(pool):
    with pytest.raises(OffloadError, match="unknown policy"):
        Scheduler(pool, policy="fastest_first")


def test_future_msg_id_tracks_table_entry(pool):
    fut = pool.domain.async_(
        1, f2f("_ham/ping", 9, registry=pool.domain.registry)
    )
    assert fut.msg_id > 0
    assert fut.get(10) == 9
