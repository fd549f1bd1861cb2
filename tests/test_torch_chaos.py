"""The port's counterpart of tests/test_chaos.py: failure-domain hardening
under seeded fault injection (``repro_torch.comm.chaos``).

Covers the four robustness layers as one suite (docs/failure-model.md):

* the ChaosFabric determinism contract — same seed + schedule => the
  identical fault sequence, on every transport;
* deadlines/retries with exactly-once replay — mutating handlers execute
  once per logical call no matter how many frames are dropped/duplicated;
* the auto-restart circuit breaker — a crash-looping worker is quarantined
  instead of hot-looped, then readmitted by a half-open probe;
* the durable BufferDirectory — a host crash+restart rebuilds the full
  directory from worker-journalled shards with zero lost buffers;
* the socket acceptance run — >=1000 calls through seeded drop+dup+delay,
  mixed mutating/read-only, all complete, zero double-executions, zero
  stranded futures.

Everything here carries the ``chaos`` marker (the CI chaos smoke job runs
``pytest -m chaos``); the tests also run in the default suite.
"""

import time

import numpy as np
import pytest

import repro_torch.cluster.pool  # noqa: F401 — registers _cluster/* at collection
import repro_torch.offload.demo_handlers  # noqa: F401 — registers chaos/* probes
from repro_torch.offload import dataplane
from repro_torch.cluster import ClusterPool, Scheduler, gather
from repro_torch.cluster.pool import register_cluster_handlers
from repro_torch.comm.chaos import ChaosConfig, ChaosFabric
from repro_torch.comm.local import LocalFabric
from repro_torch.core.closure import f2f
from repro_torch.core.errors import OffloadError
from repro_torch.core.future import Future
from repro_torch.core.message import HEADER_STRUCT, encode_frame
from repro_torch.core.registry import default_registry
from repro_torch.offload.runtime import ReplayCache

pytestmark = pytest.mark.chaos


def _default_registry_ready():
    reg = default_registry()
    register_cluster_handlers(reg)  # no-op if already present/sealed
    if not reg.initialised:
        reg.init()
    return reg


# -- determinism contract (raw fabrics, no runtime) ---------------------------

#: drop + dup only: both are decided-and-done at decide time, so the fault
#: log AND the delivered set are reproducible.  (delay/reorder decisions are
#: equally deterministic, but their *delivery timing* is not — they get
#: their own behavioural tests below.)
_DET_CFG = ChaosConfig(
    drop=0.2, dup=0.15,
    schedule=((5, 8, "drop"), (12, 14, "deliver")),
)


def _drive(fabric, seed, n=40):
    """Send ``n`` HAM frames 0 -> 1 through a seeded wrapper and drain the
    receiver; returns (fault_log, delivered_msg_ids)."""
    chaos = ChaosFabric(fabric, seed=seed, default=_DET_CFG)
    try:
        src, dst = chaos.endpoint(0), chaos.endpoint(1)
        chaos.arm()
        for i in range(n):
            src.send(1, encode_frame(0, b"\0" * 8, src_node=0, msg_id=i + 1))
        ids, quiet = [], 0
        # drain until the link stays silent for 0.5 s: a loaded host (tests run
        # in parallel) can hold a socket reader back for well over 0.15 s
        while quiet < 10:
            frames = dst.recv_many(64, timeout=0.05)
            if frames:
                # unpack immediately, then release the recv lease — shm
                # frames are zero-copy views into the ring, valid (and
                # holding the segment open) until released
                ids.extend(HEADER_STRUCT.unpack_from(f, 0)[5] for f in frames)
                frames = None
                dst.release()
                quiet = 0
            else:
                quiet += 1
        chaos.disarm()
        return list(chaos.fault_log), ids
    finally:
        chaos.close()


def test_same_seed_reproduces_fault_sequence_local():
    log_a, ids_a = _drive(LocalFabric(2), seed=7)
    log_b, ids_b = _drive(LocalFabric(2), seed=7)
    assert log_a == log_b and ids_a == ids_b
    assert log_a, "a 35% fault rate over 40 frames must log something"
    # the forced schedule window always drops send-side frames 5..7
    send_actions = {s: a for _, _, s, a, w in log_a if w == "send"}
    assert all(send_actions.get(s) == "drop" for s in (5, 6, 7))
    # frames 12..13 are schedule-protected: never in the log on either side
    assert all(s not in (12, 13) for _, _, s, _, _ in log_a)
    # a different seed draws a different sequence
    log_c, _ = _drive(LocalFabric(2), seed=8)
    assert log_c != log_a


def test_fault_sequence_identical_on_socket_fabric():
    from repro_torch.comm.socket import SocketFabric

    log_local, ids_local = _drive(LocalFabric(2), seed=11)
    log_sock, ids_sock = _drive(SocketFabric(2), seed=11)
    assert log_sock == log_local  # decisions are transport-independent
    assert ids_sock == ids_local


@pytest.mark.shm
def test_fault_sequence_identical_on_shm_fabric():
    from repro_torch.comm.shm import ShmFabric

    log_local, ids_local = _drive(LocalFabric(2), seed=11)
    log_shm, ids_shm = _drive(ShmFabric(2, capacity=1 << 20), seed=11)
    assert log_shm == log_local
    assert ids_shm == ids_local


def test_partition_blocks_link_until_unblocked():
    chaos = ChaosFabric(LocalFabric(2), seed=3)  # no probabilistic faults
    try:
        src, dst = chaos.endpoint(0), chaos.endpoint(1)
        chaos.arm().block(0, 1)
        for i in range(5):
            src.send(1, encode_frame(0, b"", src_node=0, msg_id=i + 1))
        assert dst.recv(timeout=0.1) is None  # one-way partition holds
        assert all(a == "drop" for _, _, _, a, _ in chaos.fault_log)
        chaos.unblock(0, 1)
        src.send(1, encode_frame(0, b"", src_node=0, msg_id=99))
        healed = dst.recv(timeout=2.0)
        assert healed is not None
        assert HEADER_STRUCT.unpack_from(healed, 0)[5] == 99
    finally:
        chaos.close()


def test_delayed_frames_eventually_deliver():
    chaos = ChaosFabric(LocalFabric(2), seed=5,
                        default=ChaosConfig(delay=1.0, delay_s=0.01))
    try:
        src, dst = chaos.endpoint(0), chaos.endpoint(1)
        chaos.arm()
        for i in range(3):
            src.send(1, encode_frame(0, b"", src_node=0, msg_id=i + 1))
        got = []
        deadline = time.time() + 5
        while len(got) < 3 and time.time() < deadline:
            got.extend(dst.recv_many(8, timeout=0.05))
        assert len(got) == 3  # held, never lost
        assert {a for _, _, _, a, _ in chaos.fault_log} == {"delay"}
    finally:
        chaos.close()


def test_reordered_batch_loses_nothing():
    chaos = ChaosFabric(LocalFabric(2), seed=5,
                        default=ChaosConfig(reorder=1.0, delay_s=0.01))
    try:
        src, dst = chaos.endpoint(0), chaos.endpoint(1)
        chaos.arm()
        batch = [encode_frame(0, b"", src_node=0, msg_id=i + 1)
                 for i in range(6)]
        src.send_many(1, batch)
        got = []
        deadline = time.time() + 5
        while len(got) < 6 and time.time() < deadline:
            got.extend(dst.recv_many(16, timeout=0.05))
        ids = sorted(HEADER_STRUCT.unpack_from(f, 0)[5] for f in got)
        assert ids == [1, 2, 3, 4, 5, 6]  # scrambled, not dropped
        assert chaos.faults["reorder"] > 0
    finally:
        chaos.close()


# -- replay cache unit behaviour ---------------------------------------------


def test_replay_cache_ack_floor_suppresses_stragglers():
    rc = ReplayCache()
    assert rc.begin(7, 1) is None  # first sight: caller executes
    rc.commit(7, 1, b"reply-frame")
    assert rc.begin(7, 1) == b"reply-frame"  # retransmit: cached reply
    assert rc.stats == {"replayed": 1, "suppressed": 0, "acked": 0}
    rc.ack(7, 1)
    assert rc.stats["acked"] == 1
    # a duplicate reordered behind the ack must NOT re-execute: the floor
    # swallows it (no execution, no reply — the sender already completed)
    assert rc.begin(7, 1) is ReplayCache.IN_PROGRESS
    assert rc.stats["suppressed"] == 1
    # the flush sentinel announces a NEW msg_id space (host restart):
    # everything is forgotten, low ids execute fresh again
    rc.ack(7, ReplayCache.FLUSH)
    assert rc.begin(7, 1) is None


def test_replay_cache_flush_drops_in_progress_entries():
    rc = ReplayCache()
    assert rc.begin(3, 9) is None  # executing when the host restarts
    rc.ack(3, ReplayCache.FLUSH)
    rc.commit(3, 9, b"stale")  # the old call's commit must no-op:
    assert rc.begin(3, 9) is None  # a new call with the same id runs fresh


# -- exactly-once under retry (local pool + chaos) ----------------------------


def test_exactly_once_replay_under_reply_loss():
    """Drop ~28% of worker->host reply frames; every retried chaos/bump
    must hit the worker replay cache instead of re-executing — the counter
    total stays exactly the number of logical calls."""
    reg = _default_registry_ready()
    holder = {}

    def wrap(f):
        holder["chaos"] = ChaosFabric(f, seed=42)
        return holder["chaos"]

    pool = ClusterPool.local(3, registry=reg, wrap_fabric=wrap)
    chaos = holder["chaos"]
    sched = Scheduler(pool, deadline=0.3, retries=8, max_inflight=16)
    try:
        for w in (1, 2, 3):  # lossy replies; requests stay clean
            chaos.set_link(w, 0, ChaosConfig(drop=0.15))
        chaos.arm()
        # partition ONE reply link for one deadline period: worker 1's
        # in-window replies are dropped DETERMINISTICALLY, so the
        # retries>0 assert below never depends on whether the seeded
        # probabilistic drops happened to land on a first-attempt reply.
        # (One link only — workers 2/3 keep returning flow-control
        # credits, so submission never backpressure-stalls.)
        chaos.block(1, 0)
        n = 60
        futs = [sched.submit(f2f("chaos/bump", "t-replay", registry=reg))
                for _ in range(n)]
        time.sleep(0.35)  # > deadline: >=1 in-window reply must retry
        chaos.unblock(1, 0)
        results = gather(futs, 120)
        chaos.disarm()
        # thread workers share one process-global counter, which makes the
        # exactly-once property *sharper* here: n logical calls must produce
        # exactly the post-increment values 1..n — a re-executed retry would
        # push the ceiling past n, a lost call would leave a hole
        assert sorted(results) == list(range(1, n + 1))
        # verification read runs fault-free (any worker: shared counter)
        total = pool.domain.sync(
            1, f2f("chaos/counts", "t-replay", registry=reg))
        assert total == n, "a retry re-executed (or lost) a mutating call"
        assert sched.stats["retries"] > 0  # faults actually bit
        replayed = sum(pool.domain._inproc[w].stats["replayed"]
                       for w in (1, 2, 3))
        assert replayed > 0  # cached replies were re-sent, not re-run
        assert sched.outstanding() == 0  # zero stranded futures
        pool.domain.sync(1, f2f("chaos/reset", "t-replay", registry=reg))
    finally:
        sched.close()
        pool.close()


def test_deadline_exhaustion_raises_diagnosis():
    reg = _default_registry_ready()
    pool = ClusterPool.local(2, registry=reg)
    sched = Scheduler(pool, max_inflight=8)
    try:
        # non-retryable: one attempt, then a diagnosis (at-most-once)
        fut = sched.submit(f2f("_cluster/sleep", 2.0, registry=reg),
                           node=1, deadline=0.2, retries=0)
        with pytest.raises(OffloadError, match="no reply within"):
            fut.get(10)
        assert sched.stats["deadline_failed"] == 1

        # retryable: the retransmits of a still-running call are absorbed
        # by the worker's replay cache (never executed twice), and the
        # exhausted call still gets a diagnosis
        fut = sched.submit(f2f("_cluster/sleep", 2.0, registry=reg),
                           node=2, deadline=0.15, retries=2)
        with pytest.raises(OffloadError, match="no reply within"):
            fut.get(10)
        assert sched.stats["retries"] >= 2
        # the retransmits queue behind the still-running sleep (DirectPolicy
        # executes inline) and are deduped once it finishes — wait for that
        rc = pool.domain._inproc[2].replay
        deadline = time.time() + 10
        while (rc.stats["suppressed"] + rc.stats["replayed"] < 1
               and time.time() < deadline):
            time.sleep(0.05)
        assert rc.stats["suppressed"] + rc.stats["replayed"] >= 1
    finally:
        sched.close()
        pool.close()


def test_future_result_defaults_to_bounded_wait(monkeypatch):
    monkeypatch.setattr(Future, "default_timeout", 0.05)
    f = Future()
    with pytest.raises(OffloadError, match="no reply within"):
        f.result()  # bounded by the class default — never an eternal block
    f.set_result(13)
    assert f.result() == 13  # a late reply still resolves it


# -- auto-restart circuit breaker ---------------------------------------------


def test_crash_loop_quarantines_then_probe_readmits():
    reg = _default_registry_ready()
    pool = ClusterPool.local(
        2, registry=reg, auto_restart=True, monitor_interval=0.02,
        restart_backoff=0.05, restart_backoff_max=0.1, max_restarts=2,
        fail_window=30.0, quarantine_probe=0.25,
    )
    deaths = []
    pool.on_death(deaths.append)
    try:
        handle = pool._workers[1]

        def refuse():
            raise RuntimeError("spawn refused (injected)")

        handle.respawn = refuse  # every restart attempt now fails
        pool.kill(1)
        deadline = time.time() + 10
        while not pool.is_quarantined(1) and time.time() < deadline:
            time.sleep(0.02)
        assert pool.is_quarantined(1), "breaker never tripped"
        assert not pool.is_alive(1)
        # the death was announced exactly once — failed respawns must not
        # re-announce (the scheduler already drained the node)
        assert deaths.count(1) == 1
        # heal the spawner: the next half-open probe restarts + pings the
        # worker and closes the breaker
        del handle.respawn
        deadline = time.time() + 10
        while pool.is_quarantined(1) and time.time() < deadline:
            time.sleep(0.02)
        assert not pool.is_quarantined(1), "half-open probe never readmitted"
        deadline = time.time() + 10
        while not pool.is_alive(1) and time.time() < deadline:
            time.sleep(0.02)
        assert pool.domain.ping(1, 5, timeout=10.0) == 5
    finally:
        pool.close()


def test_readmit_overrides_quarantine():
    reg = _default_registry_ready()
    pool = ClusterPool.local(
        2, registry=reg, auto_restart=True, monitor_interval=0.02,
        restart_backoff=0.05, restart_backoff_max=0.1, max_restarts=1,
        quarantine_probe=60.0,  # probe far away: only readmit() can help
    )
    try:
        handle = pool._workers[1]

        def refuse():
            raise RuntimeError("spawn refused (injected)")

        handle.respawn = refuse
        pool.kill(1)
        deadline = time.time() + 10
        while not pool.is_quarantined(1) and time.time() < deadline:
            time.sleep(0.02)
        assert pool.is_quarantined(1)
        del handle.respawn
        pool.readmit(1)  # operator override: restart now
        assert not pool.is_quarantined(1)
        assert pool.domain.ping(1, 4, timeout=10.0) == 4
    finally:
        pool.close()


# -- durable directory: host crash recovery -----------------------------------


def test_host_restart_recovers_full_directory():
    reg = _default_registry_ready()
    pool = ClusterPool.local(3, registry=reg, replicas=1)
    try:
        arrays, ptrs = {}, {}
        for i in range(6):
            arr = np.arange(16.0) + i
            ptr = pool.allocate(arr.shape, "float64", session=f"s{i}")
            pool.put(arr, ptr)
            arrays[i], ptrs[i] = arr, ptr
        time.sleep(0.3)  # let the dir_gossip oneways land on the workers
        report = pool.restart_host()
        assert report["lost"] == 0
        assert report["recovered"] == 6, "zero lost buffers after host crash"
        for i in range(6):  # bytes survived AND the directory resolves them
            np.testing.assert_array_equal(pool.get(ptrs[i]), arrays[i])
        rec = pool.directory.lookup(ptrs[0].handle)
        assert rec is not None and rec.session == "s0"  # bindings survive
        assert len(rec.holders) == 2  # primary + replica both recovered
    finally:
        pool.close()


def test_host_restart_promotes_when_primary_died_with_host():
    """Worker AND host die together: the rebuilt directory must promote the
    surviving replica (epoch bump) and still serve the bytes."""
    reg = _default_registry_ready()
    pool = ClusterPool.local(3, registry=reg, replicas=1)
    try:
        arr = np.arange(64.0)
        ptr = pool.allocate(arr.shape, "float64", node=1, session="both")
        pool.put(arr, ptr)
        time.sleep(0.3)  # gossip journal reaches the holders
        old_rec = pool.directory.lookup(ptr.handle)
        replica = old_rec.replicas[0]
        pool.kill(1)  # the primary dies...
        time.sleep(0.3)
        report = pool.restart_host()  # ...and then the host crashes
        assert report["lost"] == 0
        rec = pool.directory.lookup(ptr.handle)
        assert rec.primary == replica  # promoted onto the survivor
        assert rec.epoch > old_rec.epoch
        np.testing.assert_array_equal(pool.get(ptr), arr)
    finally:
        pool.close()


# -- chain replication under partition (write protocol, failure-model.md) -----


def _chaos_pool(seed, **kw):
    """Local pool with every link under a seeded (fault-free until armed)
    chaos wrapper; returns (pool, chaos)."""
    holder = {}

    def wrap(f):
        holder["chaos"] = ChaosFabric(f, seed=seed)
        return holder["chaos"]

    pool = ClusterPool.local(3, registry=_default_registry_ready(),
                             replicas=1, wrap_fabric=wrap, **kw)
    return pool, holder["chaos"]


def _wait_dead(sched, node, timeout=10.0):
    deadline = time.time() + timeout
    while node in sched.live_nodes() and time.time() < deadline:
        time.sleep(0.02)
    assert node not in sched.live_nodes()


def test_chain_put_partition_mid_chain_truncates_tail_then_heals(monkeypatch):
    """Partition the primary->replica hop mid-chain: the put must still
    complete (primary confirmed), with the unreachable tail DROPPED from
    the replica set — a detectable gap, never a silently-stale promotable
    copy.  Healing the link + a join backfills a replica carrying the NEW
    bytes, verified promotable by killing the primary and reading back."""
    monkeypatch.setattr(dataplane, "CHAIN_HOP_TIMEOUT", 1.5)
    pool, chaos = _chaos_pool(seed=11)
    sched = Scheduler(pool)
    try:
        pool.domain.direct_data_plane = False  # wire chain, not direct store
        x = np.arange(1024.0)
        ptr = pool.allocate(x.shape, "float64", session="chain-part")
        pool.put(x, ptr)  # healthy write-through: both holders confirm
        rec = pool.directory.lookup(ptr.handle)
        p, r = rec.primary, rec.replicas[0]
        chaos.arm().block(p, r)  # the forward hop goes dark
        y = x * 3.0
        t0 = time.perf_counter()
        pool.put(y, ptr)  # completes: tail truncated, not stuck for 30 s
        assert time.perf_counter() - t0 < 10.0
        assert any(a == "drop" for _, _, _, a, _ in chaos.fault_log)
        rec = pool.directory.lookup(ptr.handle)
        assert rec.primary == p
        assert r not in rec.replicas  # no silently-stale promotable copy
        np.testing.assert_array_equal(pool.get(ptr), y)
        chaos.unblock(p, r)
        chaos.disarm()
        new = pool.add_node()  # heal: lazy backfill restores the factor
        rec = pool.directory.lookup(ptr.handle)
        assert rec.replicas == (new,)
        np.testing.assert_array_equal(
            pool.domain.get(ptr.at(new, rec.epoch)), y)
        # the backfilled copy is genuinely promotable: kill the primary
        pool.kill(p)
        _wait_dead(sched, p)
        np.testing.assert_array_equal(pool.get(ptr), y)
        assert pool.directory.stats["lost"] == 0
    finally:
        sched.close()
        pool.close()


def test_chain_put_primary_unreachable_fails_loudly_keeps_old_bytes(
        monkeypatch):
    """Partition host->primary: the chain never confirms anywhere, so the
    put must raise (torn-write diagnosis, not silent success) while every
    holder keeps the PREVIOUS write; a healed retry converges all copies."""
    monkeypatch.setattr(dataplane, "CHAIN_HOP_TIMEOUT", 1.5)
    pool, chaos = _chaos_pool(seed=12)
    try:
        pool.domain.direct_data_plane = False
        orig_chain_put = pool.domain.chain_put  # shrink the host-side wait
        monkeypatch.setattr(
            pool.domain, "chain_put",
            lambda *a, **k: orig_chain_put(*a, **{**k, "timeout": 2.0}))
        x = np.arange(256.0)
        ptr = pool.allocate(x.shape, "float64", session="chain-torn")
        pool.put(x, ptr)
        rec = pool.directory.lookup(ptr.handle)
        p, r = rec.primary, rec.replicas[0]
        chaos.arm().block(0, p)  # the host cannot reach the primary
        with pytest.raises((OffloadError, TimeoutError)):
            pool.put(x * 2.0, ptr)
        chaos.unblock(0, p)
        chaos.disarm()
        # every holder kept the previous write — readable, just not new
        np.testing.assert_array_equal(pool.get(ptr), x)
        rec = pool.directory.lookup(ptr.handle)
        np.testing.assert_array_equal(
            pool.domain.get(ptr.at(r, rec.epoch)), x)
        z = x * 5.0
        pool.put(z, ptr)  # healed retry converges the full chain
        rec = pool.directory.lookup(ptr.handle)
        assert set(rec.replicas) == {r}
        np.testing.assert_array_equal(pool.get(ptr), z)
        np.testing.assert_array_equal(
            pool.domain.get(ptr.at(r, rec.epoch)), z)
    finally:
        pool.close()


# -- the socket acceptance run ------------------------------------------------


def test_socket_thousand_calls_exactly_once_under_chaos():
    """The acceptance bar: >=1000 calls (4:1 mutating:read-only) over
    the socket fabric with seeded drop+dup+delay on every link.  All must
    complete, the side-effect counters must total EXACTLY the number of
    mutating calls (no loss, no double-execution), and no future may be
    left stranded."""
    reg = _default_registry_ready()
    holder = {}

    def wrap(f):
        holder["chaos"] = ChaosFabric(
            f, seed=20260809,
            default=ChaosConfig(drop=0.03, dup=0.02, delay=0.01,
                                delay_s=0.003),
        )
        return holder["chaos"]

    pool = ClusterPool.socket(3, registry=reg, wrap_fabric=wrap)
    chaos = holder["chaos"]
    sched = None
    try:
        pool.ping_all(timeout=60.0)  # fault-free build-out, then arm
        sched = Scheduler(pool, deadline=0.4, retries=6, max_inflight=32)
        chaos.arm()
        tokens = [f"tok{i}" for i in range(8)]
        futs, bumps = [], 0
        for i in range(1000):
            if i % 5 == 4:  # interleave read-only probes with the mutators
                fn = f2f("chaos/counts", tokens[i % 8], registry=reg)
            else:
                fn = f2f("chaos/bump", tokens[i % 8], registry=reg)
                bumps += 1
            futs.append(sched.submit(fn))
        results = gather(futs, 300)
        chaos.disarm()
        assert len(results) == 1000  # every call completed correctly
        # verification reads run with chaos disarmed
        total = 0
        for w in pool.worker_nodes:
            for tok in tokens:
                total += pool.domain.sync(
                    w, f2f("chaos/counts", tok, registry=reg), 30.0)
        assert total == bumps, (
            f"side-effect total {total} != {bumps} mutating calls: a retry "
            "double-executed or a call was lost"
        )
        assert sched.outstanding() == 0  # zero stranded futures
        assert sched.stats["deadline_failed"] == 0
        assert sched.stats["retries"] > 0  # the chaos actually bit
    finally:
        if sched is not None:
            sched.close()
        pool.close()
