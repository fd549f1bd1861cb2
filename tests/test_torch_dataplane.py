"""The port's counterpart of tests/test_dataplane.py: the location-
transparent data plane (directory, epochs, replication, crash promotion,
session repin, lossless drain migration, free hygiene), on thread workers
and, in the two ``fork`` cases, on forked shm workers."""

import threading
import time

import numpy as np
import pytest

import repro_torch.cluster.pool  # noqa: F401 — registers _cluster/* + _ham/buf_*
from repro_torch.cluster import BufferDirectory, ClusterPool, Scheduler, gather
from repro_torch.cluster.pool import register_cluster_handlers
from repro_torch.core.closure import f2f
from repro_torch.core.errors import OffloadError, RemoteExecutionError
from repro_torch.core.registry import HandlerRegistry, default_registry
from repro_torch.offload.buffer import BufferPtr, BufferRegistry, handle_minter
from repro_torch.offload.runtime import register_internal_handlers


def _h_bump(ptr):
    """Buffer-MUTATING probe (deliberately not read_only): writes through
    deref, so the scheduler must pin it to the primary copy."""
    from repro_torch.offload.api import deref

    deref(ptr)[...] += 1.0


def _h_bump_declared(ptr):
    """The same write, DECLARED (mutates=True): the scheduler routes it at
    the primary and commits the dirty epoch + replica invalidation when it
    completes."""
    from repro_torch.offload.api import deref

    deref(ptr)[...] += 1.0


def _h_bump_then_fail(ptr):
    """Half-applied mutation: writes, then raises.  The commit must still
    run (the bytes DID change) and the caller must see the error."""
    from repro_torch.offload.api import deref

    deref(ptr)[...] += 1.0
    raise ValueError("half-applied on purpose")


def _registry():
    reg = HandlerRegistry()
    register_internal_handlers(reg)
    register_cluster_handlers(reg)  # includes the _ham/buf_* dataplane set
    reg.register(_h_bump, name="test/bump")
    reg.register(_h_bump_declared, name="test/bump_mut", mutates=True)
    reg.register(_h_bump_then_fail, name="test/bump_mut_fail", mutates=True)
    reg.init()
    return reg


@pytest.fixture
def pool():
    p = ClusterPool.local(3, registry=_registry(), replicas=1)
    yield p
    p.close()


def _wait_dead(sched, node, timeout=10.0):
    deadline = time.time() + timeout
    while node in sched.live_nodes() and time.time() < deadline:
        time.sleep(0.02)
    assert node not in sched.live_nodes()


# -- registry-level pieces ----------------------------------------------------


def test_global_handles_are_node_namespaced():
    a, b = BufferRegistry(1), BufferRegistry(2)
    pa = a.allocate((4,), "float64")
    pb = b.allocate((4,), "float64")
    assert pa.handle != pb.handle
    assert handle_minter(pa.handle) == 1 and handle_minter(pb.handle) == 2


def test_adopt_installs_foreign_handle_and_discard_is_idempotent():
    owner, replica = BufferRegistry(1), BufferRegistry(2)
    ptr = owner.allocate((8,), "float32")
    replica.adopt_empty(ptr.handle, (8,), "float32")
    assert replica.holds(ptr.handle)
    # the replica derefs through a pointer retargeted at itself
    view = replica.deref(ptr.at(2))
    assert view.shape == (8,)
    assert replica.discard(ptr.handle) is True
    assert replica.discard(ptr.handle) is False  # idempotent
    assert replica.live_count() == 0


# -- directory unit behaviour -------------------------------------------------


def test_directory_resolves_stale_epoch_and_promotes():
    d = BufferDirectory()
    ptr = BufferPtr(1, 101, 64, 0)
    out = d.register(ptr, (8,), "float64", replicas=(2, 3))
    assert out == ptr and len(d) == 1
    assert d.resolve(ptr) is ptr  # current pointer passes through untouched
    moved = d.on_node_death(1)
    assert moved == {101: 2}  # lowest-id replica promoted
    fresh = d.resolve(ptr)
    assert (fresh.node, fresh.epoch) == (2, 1)
    assert d.lookup(101).replicas == (3,)
    # a second promotion bumps again
    assert d.on_node_death(2) == {101: 3}
    assert d.resolve(ptr).epoch == 2
    # pointer minted at epoch 1 is also stale now
    assert d.resolve(fresh).node == 3


def test_directory_records_lost_buffers_loudly():
    d = BufferDirectory()
    ptr = d.register(BufferPtr(1, 7, 16, 0), (2,), "float64")
    assert d.on_node_death(1) == {}
    assert d.lost_handles() == [7]
    with pytest.raises(OffloadError, match="lost"):
        d.resolve(ptr)
    with pytest.raises(OffloadError, match="replicas>=1"):
        d.resolve_args((ptr,))


def test_directory_retargets_args_at_any_holder():
    d = BufferDirectory()
    ptr = d.register(BufferPtr(1, 9, 32, 0), (4,), "float64", replicas=(2,))
    # target holds a replica: pointer retargeted there
    (out,), changed = d.resolve_args((ptr,), target=2)
    assert changed and out.node == 2 and out.epoch == 0
    # non-holder target: pointer resolves to the primary
    (out,), changed = d.resolve_args((ptr,), target=3)
    assert not changed and out.node == 1
    # nested containers are rewritten too (one structure level deep)
    (lst, scalar), changed = d.resolve_args(([ptr, 5], 7), target=2)
    assert changed and lst[0].node == 2 and lst[1] == 5 and scalar == 7
    # untracked pointers pass through
    stranger = BufferPtr(9, 999, 8, 0)
    (out,), changed = d.resolve_args((stranger,), target=2)
    assert not changed and out is stranger


def test_directory_locality_resolver_votes_for_all_holders():
    d = BufferDirectory()
    ptr = d.register(BufferPtr(1, 5, 100, 0), (100,), "uint8",
                     replicas=(2, 3))
    votes = d.locality_resolver(ptr)
    assert votes == {1: 100, 2: 100, 3: 100}
    assert d.locality_resolver("not a ptr") is None
    assert d.locality_resolver(BufferPtr(4, 404, 8, 0)) is None


def test_directory_primary_resolver_votes_primary_only():
    """Calls NOT declared read-only use this resolver: only the primary
    copy may serve them (a replica-routed mutation would diverge)."""
    d = BufferDirectory()
    ptr = d.register(BufferPtr(1, 5, 100, 0), (100,), "uint8",
                     replicas=(2, 3))
    assert d.primary_resolver(ptr) == {1: 100}
    d.on_node_death(1)  # promotion moves the vote with the primary
    assert d.primary_resolver(ptr) == {2: 100}
    assert d.primary_resolver("not a ptr") is None
    assert d.primary_resolver(BufferPtr(4, 404, 8, 0)) is None


def test_resolve_args_depth_matches_scan_locality_vote_depth():
    """Vote implies rewrite: a pointer nested at the scan bound is both
    votable and rewritable; one past the bound is neither (it can never
    ship with a retargeted-but-unrewritten hint)."""
    from repro_torch.core.migratable import MAX_SCAN_DEPTH, scan_locality

    d = BufferDirectory()
    ptr = d.register(BufferPtr(1, 9, 64, 0), (8,), "float64", replicas=(2,))
    at_bound = ptr
    for _ in range(MAX_SCAN_DEPTH):
        at_bound = [at_bound]

    def innermost(v):
        while isinstance(v, list):
            v = v[0]
        return v

    assert scan_locality((at_bound,), resolver=d.locality_resolver) \
        == {1: 64, 2: 64}
    (out,), changed = d.resolve_args((at_bound,), target=2)
    assert changed and innermost(out).node == 2
    past_bound = [at_bound]
    assert scan_locality((past_bound,), resolver=d.locality_resolver) == {}
    (out,), changed = d.resolve_args((past_bound,), target=2)
    assert not changed and innermost(out) is ptr


# -- pool-level replication + crash recovery ---------------------------------


def test_write_through_put_and_replica_promotion_keeps_data(pool):
    sched = Scheduler(pool)
    arr = np.arange(256.0)
    ptr = pool.allocate(arr.shape, "float64", node=1)
    rec = pool.directory.lookup(ptr.handle)
    assert rec.primary == 1 and len(rec.replicas) == 1
    pool.put(arr, ptr)
    pool.kill(1)
    _wait_dead(sched, 1)
    rec2 = pool.directory.lookup(ptr.handle)
    assert rec2.primary == rec.replicas[0] and rec2.epoch == 1
    # the STALE pointer still reads the full data, transparently
    np.testing.assert_array_equal(pool.get(ptr), arr)
    assert pool.directory.stats["promoted"] == 1
    assert pool.directory.stats["lost"] == 0


def test_kill_worker_mid_stream_sessions_replace_onto_replica_holder():
    """The acceptance property: kill a worker holding replicated
    buffers while a session stream is running; zero buffers lost, its
    sessions resume ON the replica holder, stale-epoch pointers re-resolve
    transparently."""
    pool = ClusterPool.local(3, registry=_registry(), replicas=1)
    try:
        sched = Scheduler(pool, max_inflight=8)
        reg = pool.domain.registry
        arrs, ptrs = {}, {}
        for i in range(6):
            key = f"sess-{i}"
            arr = np.arange(64.0) + i
            ptr = pool.allocate(arr.shape, "float64", session=key)
            pool.put(arr, ptr)
            arrs[key], ptrs[key] = arr, ptr
            # first submit pins the session at its buffer's home
            assert sched.submit(
                f2f("_cluster/touch", ptr, registry=reg), session=key
            ).get(10) == arr.sum()
        placement = {k: sched.sessions.lookup(k) for k in ptrs}
        for k, ptr in ptrs.items():
            assert placement[k] == pool.directory.lookup(ptr.handle).primary
        victim = placement["sess-0"]
        victims = [k for k, n in placement.items() if n == victim]
        expected_home = {
            k: pool.directory.lookup(ptrs[k].handle).replicas[0]
            for k in victims
        }
        # keep a stream of session traffic running through the kill
        streaming = [
            sched.submit(f2f("_cluster/sleep", 0.05, registry=reg),
                         session=k)
            for k in ptrs for _ in range(2)
        ]
        pool.kill(victim)
        _wait_dead(sched, victim)
        # ZERO lost buffers; the victim's buffers promoted onto replicas
        assert pool.directory.stats["lost"] == 0
        assert pool.directory.lost_handles() == []
        # its sessions were re-pinned onto the nodes now holding their data
        for k in victims:
            assert sched.sessions.lookup(k) == expected_home[k]
        # unaffected sessions never moved
        for k in ptrs:
            if k not in victims:
                assert sched.sessions.lookup(k) == placement[k]
        # the stream continues: every session still reaches ITS data with
        # the ORIGINAL (now stale-epoch) pointers
        for k, ptr in ptrs.items():
            fut = sched.submit(f2f("_cluster/touch", ptr, registry=reg),
                               session=k)
            assert fut.get(10) == arrs[k].sum()
            np.testing.assert_array_equal(pool.get(ptr), arrs[k])
        for f in streaming:
            try:
                f.get(10)
            except Exception:  # noqa: BLE001 — in-flight calls on the
                pass  # victim legitimately fail; sessions re-placed after
        assert sched.sessions.stats["recovered"] >= len(victims)
    finally:
        pool.close()


def test_crash_without_replica_is_recorded_lost(pool):
    sched = Scheduler(pool)
    ptr = pool.allocate((16,), "float64", node=2, replicas=0)
    pool.put(np.ones(16), ptr)
    pool.kill(2)
    _wait_dead(sched, 2)
    assert ptr.handle in pool.directory.lost_handles()
    with pytest.raises(OffloadError, match="lost"):
        pool.get(ptr)
    with pytest.raises(OffloadError, match="lost"):
        sched.submit(f2f("_cluster/touch", ptr,
                         registry=pool.domain.registry))


def test_remove_node_drain_migrates_primaries_losslessly(pool):
    sched = Scheduler(pool)
    reg = pool.domain.registry
    # one replicated buffer (promotion path: zero copy) and one
    # replica-less buffer (stream path) homed on the leaving node
    a = pool.allocate((32,), "float64", node=3, session="drain-a")
    b = pool.allocate((1024,), "float64", node=3, replicas=0)
    va, vb = np.arange(32.0), np.arange(1024.0)
    pool.put(va, a)
    pool.put(vb, b)
    assert sched.submit(f2f("_cluster/touch", a, registry=reg),
                        session="drain-a").get(10) == va.sum()
    pool.remove_node(3, drain=True)
    assert pool.directory.stats["lost"] == 0
    for ptr, val in ((a, va), (b, vb)):
        rec = pool.directory.lookup(ptr.handle)
        assert rec.primary in sched.live_nodes() and rec.epoch == 1
        np.testing.assert_array_equal(pool.get(ptr), val)
    # the drained node's session followed its migrated buffer
    assert sched.sessions.lookup("drain-a") == \
        pool.directory.lookup(a.handle).primary
    assert sched.submit(f2f("_cluster/touch", a, registry=reg),
                        session="drain-a").get(10) == va.sum()


def test_free_invalidates_replicas_and_live_count_is_truthful(pool):
    ptr = pool.allocate((8,), "float64", node=1)
    rec = pool.directory.lookup(ptr.handle)
    replica = rec.replicas[0]
    assert pool.buffer_count(1) == 1
    assert pool.buffer_count(replica) == 1
    pool.free(ptr)
    assert pool.directory.lookup(ptr.handle) is None
    for n in pool.live_nodes():
        assert pool.buffer_count(n) == 0  # no replica leaks


def test_worker_side_free_announces_and_invalidates_replicas(pool):
    """A free executed ON a worker (not via pool.free) must still reach the
    directory: the worker announces _ham/buf_freed, the host drops the
    record and invalidates the other holders."""
    ptr = pool.allocate((8,), "float64", node=1)
    replica = pool.directory.lookup(ptr.handle).replicas[0]
    # free at the primary through the plain paper-level data plane
    pool.domain.free(ptr.at(1))
    deadline = time.time() + 10
    while pool.directory.lookup(ptr.handle) is not None \
            and time.time() < deadline:
        time.sleep(0.02)
    assert pool.directory.lookup(ptr.handle) is None
    deadline = time.time() + 10
    while pool.buffer_count(replica) and time.time() < deadline:
        time.sleep(0.02)
    assert pool.buffer_count(replica) == 0


def test_end_session_releases_bound_buffers_cluster_wide(pool):
    sched = Scheduler(pool)
    ptr = pool.allocate((8,), "float64", session="done-s")
    pool.put(np.ones(8), ptr)
    assert len(pool.directory) == 1
    sched.end_session("done-s")
    assert len(pool.directory) == 0
    for n in pool.live_nodes():
        assert pool.buffer_count(n) == 0
    assert sched.sessions.lookup("done-s") is None


def test_locality_votes_route_to_live_replica(pool):
    """Locality policy must treat ANY live holder as local: with the
    primary dead, a read routes to the surviving replica."""
    sched = Scheduler(pool, policy="locality")
    reg = pool.domain.registry
    arr = np.arange(128.0)
    ptr = pool.allocate(arr.shape, "float64", node=2)
    pool.put(arr, ptr)
    replica = pool.directory.lookup(ptr.handle).replicas[0]
    pool.kill(2)
    _wait_dead(sched, 2)
    fut = sched.submit(f2f("_cluster/touch", ptr, registry=reg))
    assert fut.get(10) == arr.sum()
    assert sched.stats["routed"][replica] >= 1


def test_mutating_call_routes_and_pins_to_primary(pool):
    """A handler NOT declared read_only must never be served from a
    replica: locality votes go to the primary only, and its pointers are
    never retargeted — so the mutation can only land on the authoritative
    copy (the replica keeps the bytes of the last put, as documented)."""
    sched = Scheduler(pool, policy="locality")
    reg = pool.domain.registry
    arr = np.arange(16.0)
    ptr = pool.allocate(arr.shape, "float64", node=1)
    pool.put(arr, ptr)
    rec = pool.directory.lookup(ptr.handle)
    replica = rec.replicas[0]
    for _ in range(3):
        sched.submit(f2f("test/bump", ptr, registry=reg)).get(10)
    assert sched.stats["routed"].get(replica, 0) == 0
    assert sched.stats["routed"][1] == 3
    np.testing.assert_array_equal(pool.get(ptr), arr + 3.0)
    # handler-side writes are not write-through: the replica still holds
    # the last put (the documented caveat callers re-put to close)
    np.testing.assert_array_equal(
        pool.domain.get(ptr.at(replica, rec.epoch)), arr
    )


def test_mutating_call_pinned_at_replica_fails_loudly(pool):
    """Pinning a mutating call at a replica holder must fail the deref
    check (pointer stays at the primary), never silently diverge that
    copy; the same pin with a read_only handler is retargeted and works."""
    sched = Scheduler(pool)
    reg = pool.domain.registry
    ptr = pool.allocate((8,), "float64", node=1)
    pool.put(np.zeros(8), ptr)
    replica = pool.directory.lookup(ptr.handle).replicas[0]
    with pytest.raises(RemoteExecutionError):
        sched.submit(f2f("test/bump", ptr, registry=reg),
                     node=replica).get(10)
    np.testing.assert_array_equal(pool.get(ptr), np.zeros(8))  # no write
    fut = sched.submit(f2f("_cluster/touch", ptr, registry=reg),
                       node=replica)
    assert fut.get(10) == 0.0
    assert sched.stats["routed"][replica] >= 1


def test_put_serialises_against_join_backfill(pool):
    """The write-through race: a joiner backfilled from a pre-put snapshot
    of the bytes must not become a promotable holder without receiving the
    put.  The backfill copy is held open mid-window; a concurrent put must
    serialise behind it and write through the new replica too."""
    sched = Scheduler(pool)
    ptr = pool.allocate((64,), "float64", node=1)
    pool.put(np.zeros(64), ptr)
    replica = pool.directory.lookup(ptr.handle).replicas[0]
    pool.kill(replica)  # leave the buffer under-replicated
    _wait_dead(sched, replica)
    assert pool.directory.lookup(ptr.handle).replicas == ()
    copied = threading.Event()
    orig = pool._copy_buffer

    def slow_copy(rec, src, dst, timeout=30.0):
        orig(rec, src, dst, timeout)  # pre-put snapshot lands on the joiner
        copied.set()
        time.sleep(0.3)  # window in which an unserialised put would miss dst

    pool._copy_buffer = slow_copy
    try:
        joined = {}
        t = threading.Thread(
            target=lambda: joined.setdefault("node", pool.add_node())
        )
        t.start()
        assert copied.wait(30)
        new_data = np.arange(64.0)
        pool.put(new_data, ptr)  # must block until the joiner is registered
        t.join(30)
        assert not t.is_alive()
    finally:
        pool._copy_buffer = orig
    rec = pool.directory.lookup(ptr.handle)
    assert rec.replicas == (joined["node"],)
    np.testing.assert_array_equal(
        pool.domain.get(ptr.at(joined["node"], rec.epoch)), new_data
    )
    # the backfilled copy is genuinely promotable: kill the primary, read
    pool.kill(rec.primary)
    _wait_dead(sched, rec.primary)
    np.testing.assert_array_equal(pool.get(ptr), new_data)


def test_join_backfills_under_replicated_buffers(pool):
    sched = Scheduler(pool)
    arr = np.arange(64.0)
    ptr = pool.allocate(arr.shape, "float64", node=1)
    pool.put(arr, ptr)
    replica = pool.directory.lookup(ptr.handle).replicas[0]
    pool.kill(replica)  # the REPLICA dies: buffer is under-replicated
    _wait_dead(sched, replica)
    assert pool.directory.lookup(ptr.handle).replicas == ()
    new = pool.add_node()  # lazy backfill restores the replication factor
    rec = pool.directory.lookup(ptr.handle)
    assert rec.replicas == (new,)
    assert pool.directory.stats["backfilled"] >= 1
    # the backfilled copy really holds the bytes: kill the primary, read
    pool.kill(rec.primary)
    _wait_dead(sched, rec.primary)
    np.testing.assert_array_equal(pool.get(ptr), arr)


# -- the active-access write protocol (chain put + mutate-at-data) -----------


def _holder_dirty(pool, node, handle):
    return pool.domain._inproc[node].applied_dirty.get(int(handle))


def test_chain_put_wire_confirms_every_holder(pool):
    """Over the wire, a replicated put sends the bytes host->primary once;
    the primary streams the chain.  Every holder must end with the payload
    AND an applied_dirty watermark matching the directory's dirty epoch —
    that watermark is what host-crash recovery uses to spot stale tails."""
    pool.domain.direct_data_plane = False
    arr = np.arange(4096.0)
    ptr = pool.allocate(arr.shape, "float64", node=1)
    pool.put(arr, ptr)
    pool.put(arr * 2, ptr)  # second write: dirty must advance, not reset
    rec = pool.directory.lookup(ptr.handle)
    assert rec.replicas != ()
    assert rec.dirty == 2
    for holder in (ptr.node, *rec.replicas):
        np.testing.assert_array_equal(
            pool.domain.get(ptr.at(holder, rec.epoch)), arr * 2
        )
        assert _holder_dirty(pool, holder, ptr.handle) == rec.dirty


def test_chain_put_direct_path_keeps_the_same_contract(pool):
    """Thread pools take the in-process shortcut (memcpy per holder) —
    bytes and applied_dirty must come out exactly as the wire chain's."""
    assert pool.domain.direct_data_plane
    arr = np.arange(512.0)
    ptr = pool.allocate(arr.shape, "float64", node=1)
    pool.put(arr, ptr)
    rec = pool.directory.lookup(ptr.handle)
    assert rec.replicas != () and rec.dirty == 1
    for holder in (ptr.node, *rec.replicas):
        np.testing.assert_array_equal(
            pool.domain.get(ptr.at(holder, rec.epoch)), arr
        )
        assert _holder_dirty(pool, holder, ptr.handle) == rec.dirty


def test_mutation_commit_drops_replicas_for_lazy_backfill(pool):
    """Drop mode (default): a committed mutates=True call invalidates the
    replica copies — they leave the holder set (nothing stale stays
    promotable) and the next join re-backfills the NEW bytes."""
    sched = Scheduler(pool, policy="locality")
    reg = pool.domain.registry
    arr = np.arange(64.0)
    ptr = pool.allocate(arr.shape, "float64", node=1)
    pool.put(arr, ptr)
    assert pool.directory.lookup(ptr.handle).replicas != ()
    sched.submit(f2f("test/bump_mut", ptr, registry=reg)).get(10)
    rec = pool.directory.lookup(ptr.handle)
    assert rec.replicas == ()  # dropped at commit, not left stale
    assert rec.dirty == 2  # put, then the committed mutation
    assert sched.stats["mutations_committed"] == 1
    np.testing.assert_array_equal(pool.get(ptr), arr + 1.0)
    joined = pool.add_node()  # lazy backfill re-replicates the new bytes
    rec = pool.directory.lookup(ptr.handle)
    assert rec.replicas == (joined,)
    np.testing.assert_array_equal(
        pool.domain.get(ptr.at(joined, rec.epoch)), arr + 1.0
    )


def test_mutation_commit_refresh_converges_replica():
    """Refresh mode: the primary chain-pushes the new bytes; the replica
    stays a holder and reflects the mutation by the time the future
    resolves — zero stale-read window beyond the in-flight write."""
    p = ClusterPool.local(3, registry=_registry(), replicas=1,
                          mutation_refresh=True)
    try:
        sched = Scheduler(p, policy="locality")
        reg = p.domain.registry
        arr = np.arange(64.0)
        ptr = p.allocate(arr.shape, "float64", node=1)
        p.put(arr, ptr)
        replica = p.directory.lookup(ptr.handle).replicas[0]
        sched.submit(f2f("test/bump_mut", ptr, registry=reg)).get(10)
        rec = p.directory.lookup(ptr.handle)
        assert rec.replicas == (replica,)  # still a holder
        np.testing.assert_array_equal(
            p.domain.get(ptr.at(replica, rec.epoch)), arr + 1.0
        )
        assert _holder_dirty(p, replica, ptr.handle) == rec.dirty
    finally:
        p.close()


def test_mutation_commit_runs_even_when_handler_raises(pool):
    """A mutating handler that raises AFTER writing is half-applied: the
    caller must see the error, but the commit must still run — replica
    holders would otherwise keep serving the overwritten bytes."""
    sched = Scheduler(pool, policy="locality")
    reg = pool.domain.registry
    ptr = pool.allocate((16,), "float64", node=1)
    pool.put(np.zeros(16), ptr)
    with pytest.raises(RemoteExecutionError, match="half-applied"):
        sched.submit(f2f("test/bump_mut_fail", ptr, registry=reg)).get(10)
    rec = pool.directory.lookup(ptr.handle)
    assert rec.replicas == ()  # invalidated despite the error
    assert sched.stats["mutations_committed"] == 1
    np.testing.assert_array_equal(pool.get(ptr), np.ones(16))


def test_undeclared_mutation_warns_once(pool, caplog):
    """A handler that is neither read_only nor mutates and derefs a
    replicated tracked buffer gets ONE warning naming the mutates=True
    fix — per handler, not per call."""
    import logging

    sched = Scheduler(pool, policy="locality")
    reg = pool.domain.registry
    ptr = pool.allocate((8,), "float64", node=1)
    pool.put(np.zeros(8), ptr)
    with caplog.at_level(logging.WARNING, logger="repro_torch.cluster.scheduler"):
        for _ in range(3):
            sched.submit(f2f("test/bump", ptr, registry=reg)).get(10)
    hits = [r for r in caplog.records if "mutates=True" in r.getMessage()]
    assert len(hits) == 1
    assert "docs/failure-model.md" in hits[0].getMessage()


def test_pool_mutate_routes_to_primary_and_commits(pool):
    """pool.mutate is the bare Active-Access write primitive: one sync call
    at the primary plus the dirty-epoch commit — no scheduler attached.
    If the call ran anywhere but the primary, the post-commit read (served
    by the primary after replicas drop) would return the OLD bytes."""
    reg = pool.domain.registry
    arr = np.arange(64.0)
    ptr = pool.allocate(arr.shape, "float64", node=1)
    pool.put(arr, ptr)
    assert pool.directory.lookup(ptr.handle).replicas != ()
    pool.mutate(f2f("test/bump_mut", ptr, registry=reg))
    rec = pool.directory.lookup(ptr.handle)
    assert rec.replicas == ()  # committed: dropped, not left stale
    assert rec.dirty == 2  # put, then the committed mutation
    np.testing.assert_array_equal(pool.get(ptr), arr + 1.0)


def test_pool_mutate_commits_on_error_and_rejects_misuse(pool):
    """Half-applied mutations still commit (the caller sees the handler's
    error, replicas do not keep the overwritten bytes); handlers not
    declared mutates=True and calls with no tracked buffer are refused
    up front."""
    reg = pool.domain.registry
    ptr = pool.allocate((16,), "float64", node=1)
    pool.put(np.zeros(16), ptr)
    with pytest.raises(RemoteExecutionError, match="half-applied"):
        pool.mutate(f2f("test/bump_mut_fail", ptr, registry=reg))
    rec = pool.directory.lookup(ptr.handle)
    assert rec.replicas == ()  # invalidated despite the error
    np.testing.assert_array_equal(pool.get(ptr), np.ones(16))
    with pytest.raises(OffloadError, match="mutates=True"):
        pool.mutate(f2f("test/bump", ptr, registry=reg))
    with pytest.raises(OffloadError, match="no directory-tracked buffer"):
        pool.mutate(f2f("test/bump_mut", np.zeros(4), registry=reg))


# -- the same recovery story over a REAL process fabric ----------------------


def _default_registry_ready():
    reg = default_registry()
    register_cluster_handlers(reg)
    if not reg.initialised:
        reg.init()
    return reg


@pytest.mark.fork
def test_fork_kill_worker_with_replicated_buffers_recovers():
    """Crash recovery across real process death: a forked shm worker
    holding replicated buffers is killed mid-stream; its session re-places
    onto the replica holder and the ORIGINAL stale pointer still reads the
    data back intact over the wire."""
    reg = _default_registry_ready()
    pool = ClusterPool.shm(3, registry=reg, replicas=1)
    try:
        sched = Scheduler(pool, max_inflight=8)
        pool.ping_all()
        arr = np.arange(4096.0)
        ptr = pool.allocate(arr.shape, "float64", node=1, session="fk")
        pool.put(arr, ptr)
        assert sched.submit(f2f("_cluster/touch", ptr, registry=reg),
                            session="fk").get(20) == arr.sum()
        assert sched.sessions.lookup("fk") == 1
        replica = pool.directory.lookup(ptr.handle).replicas[0]
        streaming = [sched.submit(f2f("_cluster/sleep", 0.05, registry=reg),
                                  session="fk") for _ in range(4)]
        pool.kill(1)
        _wait_dead(sched, 1)
        assert pool.directory.stats["lost"] == 0
        assert sched.sessions.lookup("fk") == replica
        rec = pool.directory.lookup(ptr.handle)
        assert rec.primary == replica and rec.epoch == 1
        np.testing.assert_array_equal(pool.get(ptr), arr)
        assert sched.submit(f2f("_cluster/touch", ptr, registry=reg),
                            session="fk").get(20) == arr.sum()
        for f in streaming:
            try:
                f.get(10)
            except Exception:  # noqa: BLE001 — in-flight on the corpse
                pass
    finally:
        pool.close()


@pytest.mark.fork
def test_fork_remove_node_drain_is_lossless():
    reg = _default_registry_ready()
    pool = ClusterPool.shm(2, registry=reg, replicas=0)
    try:
        sched = Scheduler(pool)
        pool.ping_all()
        arr = np.arange(2048.0)
        ptr = pool.allocate(arr.shape, "float64", node=2)
        pool.put(arr, ptr)
        pool.remove_node(2, drain=True)
        assert sched.live_nodes() == [1]
        rec = pool.directory.lookup(ptr.handle)
        assert rec.primary == 1 and rec.epoch == 1
        assert pool.directory.stats["lost"] == 0
        np.testing.assert_array_equal(pool.get(ptr), arr)
    finally:
        pool.close()
