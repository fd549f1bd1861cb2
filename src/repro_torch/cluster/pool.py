"""Cluster worker pool: lifecycle + liveness for a set of HAM offload nodes.

HAM-Offload (paper §2) targets one hand-picked node per call; this module
supplies the fleet underneath a :class:`~repro_torch.cluster.scheduler.Scheduler`:

* :class:`ClusterPool` owns one fabric's worth of workers — in-process
  threads (``local``), forked processes over shared-memory rings (``shm``,
  the SCIF/DMA analogue), or fresh interpreters over TCP (``socket``, the
  heterogeneous-binaries case);
* a monitor thread watches liveness and announces deaths to subscribers
  (the scheduler fails that node's in-flight futures and reroutes);
* writes to replicated buffers ride **chain replication** (`put`, and the
  ``_migrate_off``/backfill copies): bytes leave the host once and the
  holders forward them peer-to-peer — see "Replicated data plane" below;
* dead workers can be restarted in place (``auto_restart=True`` or an
  explicit :meth:`ClusterPool.restart`): the fabric drops frames queued
  toward the corpse, the host endpoint forgets stale transport state, and a
  replacement attaches under the same node id;
* :meth:`ClusterPool.close` reaps every child and tears the fabric down —
  together with ``ShmFabric``'s atexit unlink this is the fix for the
  ``/dev/shm`` segment leak when a child dies mid-run.

Fault-injection helpers (``kill``) are first-class: a scheduler that cannot
be tested against a dying worker cannot be trusted with one.

Elastic membership protocol (grow/shrink under live traffic)
------------------------------------------------------------

The paper fixes the node set at MPI startup and names that as a limitation;
here membership is runtime state, in the spirit of HPX's AGAS.  Node ids
are **monotonic and never reused** — a retired id stays invalid forever, so
a straggler frame addressed to it fails fast instead of reaching an
unrelated replacement.

:meth:`ClusterPool.add_node` (host-driven, in order):

1. ``fabric.add_node()`` provisions transport resources (shm ring pairs, a
   port) for the next id;
2. the host endpoint attaches the id (``attach_peer``);
3. every live worker is told ``_cluster/attach_peer`` as a **sync** call —
   when step 4 starts, every survivor can already address the newcomer
   (the same broadcast role ``restart`` plays with ``_cluster/reset_peer``);
4. the worker is spawned (same launch mode as the pool), pinged (startup
   barrier), and its key-map digest is verified against the host table
   (``verify_peer_digest`` — elastic join re-checks the same-source
   assumption that static startup checked implicitly);
5. ``on_join`` subscribers run (the scheduler creates the node's
   credit/in-flight/stats entries atomically under its lock).

:meth:`ClusterPool.remove_node` (the reverse, with a drain fence):

1. ``on_leave`` subscribers run first — the scheduler *fences* the node
   (no new submits route to it) and returns a drain waiter;
2. with ``drain=True`` the waiter blocks until the node's in-flight futures
   finish (the worker is still alive and replying); with ``drain=False``
   the death path fails them immediately;
3. the worker gets ``_ham/terminate`` and is reaped;
4. the host endpoint and every surviving worker ``detach_peer`` the id
   (broadcast ``_cluster/detach_peer``), and ``fabric.remove_node``
   reclaims its resources.

Workers report executor queue depth to the host as ``_cluster/stats``
oneways (see ``NodeRuntime.enable_depth_report``); the scheduler folds the
reports into ``least_outstanding`` so host-side in-flight counts are
corrected by what is actually queued behind each worker.

Replicated data plane (ownership epochs; full protocol in
``repro_torch.offload.dataplane``)
------------------------------------------------------------------------

Every pool owns a :class:`BufferDirectory` and exposes a directory-tracked
data plane: :meth:`allocate` places a buffer's primary on a live worker
(round-robin unless pinned) and installs ``replicas=N`` empty copies under
the SAME global handle on other workers (``_ham/buf_adopt``); :meth:`put`
**writes through every holder by chain replication** — the bytes go to
the primary once (zero-copy chunked pipeline) and the primary streams
them to the replicas over worker->worker links, each write sequenced by a
directory-minted dirty epoch (``repro_torch.offload.dataplane``, "Chain
replication") — so copies never diverge and the host is off the
replication path; :meth:`get`/:meth:`free` resolve stale pointers through
the directory first.  A handler registered ``mutates=True`` writes the
primary in place and :meth:`commit_mutation` restores coherence
(invalidate or chain-refresh the replicas).  The failure/elasticity
contract:

* **crash** — the monitor's death announcement runs the directory's
  metadata-only promotion *before* any external subscriber: each affected
  buffer's lowest-id replica becomes primary, its epoch bumps (old
  pointers are now stale and re-resolve transparently at submit), and
  sessions bound to moved buffers repin onto the node holding their bytes;
  buffers with no replica are recorded lost and resolve loudly;
* **shrink** — ``remove_node(drain=True)`` migrates every primary off the
  leaving node before the scheduler fence (promoting an existing replica
  when one holds the bytes — zero copy — else streaming to a survivor),
  backfills the replicas it held, and detaches it from the directory:
  shrink is lossless.  ``drain=False`` takes the crash path (replicas
  promote, replica-less buffers are lost — that is what drain is for);
* **join/restart** — lazy backfill: buffers left under-replicated by
  earlier deaths copy one replica onto the joiner.

Write-through :meth:`put` (and :meth:`free`) serialise against every
byte-copying holder-set mutation — join/restart backfill and drain
migration — on a handle-striped data-plane lock: a holder created from a
pre-put snapshot of the bytes either finishes registering before the put
(which then writes through it too) or copies after the put and sees the
new bytes, so a promotable holder can never silently hold stale data.
No caller-side write quiescing is required around ``remove_node`` or
``add_node``.

Handler-side buffer writes are write-through only when DECLARED: a
``mutates=True`` handler runs at the primary and its commit
(:meth:`commit_mutation`, driven by the scheduler) bumps the dirty epoch
and invalidates or chain-refreshes the replica holders.  A handler that
is neither ``read_only`` nor ``mutates`` and mutates through ``deref``
leaves the replicas at the last put until the caller re-puts (the routing
contract in ``repro_torch.offload.dataplane``; the scheduler logs a one-shot
warning for such calls — see docs/failure-model.md, "Write visibility
and convergence").
"""

from __future__ import annotations

import threading
import time

import numpy as np

from repro_torch.comm.local import LocalFabric
from repro_torch.core import migratable as mig
from repro_torch.core.closure import Function, f2f
from repro_torch.core.errors import OffloadError, RegistrySealedError
from repro_torch.core.executor import DirectPolicy
from repro_torch.core.registry import default_registry, verify_peer_digest
from repro_torch.offload.api import OffloadDomain
from repro_torch.offload.buffer import BufferPtr
from repro_torch.offload.dataplane import (
    BufferDirectory,
    BufferRecord,
    register_dataplane_handlers,
    tracked_handles,
)
from repro_torch.offload.runtime import NodeRuntime, ReplayCache
from repro_torch.offload.worker import (
    reap,
    spawn_shm_workers,
    spawn_socket_worker_subprocess,
)


# --------------------------------------------------------------------------
# pool-exercisable handlers (registered at import = static initialisation,
# like runtime's _ham/* set) — used by benchmarks and liveness tests
# --------------------------------------------------------------------------


def _h_sleep(seconds):
    """Blocking I/O stand-in: holds a worker busy without burning CPU."""
    time.sleep(float(seconds))
    return float(seconds)


def _h_spin(n):
    """CPU-bound stand-in: a bounded arithmetic loop."""
    x = 0
    for i in range(int(n)):
        x += i
    return x


def _h_touch(ptr):
    """Data-local stand-in: dereference a buffer_ptr and reduce it — only
    executable on the owning node, so it exercises locality routing."""
    from repro_torch.offload.api import deref

    return float(deref(ptr).sum())


def _h_reset_peer(node_id):
    """Drop this node's cached transport toward a restarted peer — relays
    (offload over fabric) cache worker->worker connections the host's own
    reset cannot reach."""
    from repro_torch.offload.runtime import current_node

    current_node().endpoint.reset_peer(int(node_id))


def _h_attach_peer(node_id):
    """Membership broadcast (grow): make ``node_id`` addressable from this
    node.  Called sync so the host knows every survivor attached BEFORE the
    newcomer spawns (protocol step 3 in the module docs)."""
    from repro_torch.offload.runtime import current_node

    current_node().endpoint.attach_peer(int(node_id))


def _h_detach_peer(node_id):
    """Membership broadcast (shrink): retire ``node_id`` on this node —
    drop its transport state; later sends toward it fail fast."""
    from repro_torch.offload.runtime import current_node

    current_node().endpoint.detach_peer(int(node_id))


def _h_stats(node_id, depth):
    """Queue-depth report (oneway): a worker's executor backlog, folded into
    the receiving node's ``peer_depth`` for depth-aware scheduling."""
    from repro_torch.offload.runtime import current_node

    current_node().note_peer_depth(int(node_id), int(depth))


def _h_digest():
    """Key-map digest of this node's handler table (hex) — lets an elastic
    join *verify* the paper's same-source assumption (registry docs)."""
    from repro_torch.offload.runtime import current_node

    return current_node().table.digest.hex()


def register_cluster_handlers(registry=None) -> None:
    """Register the pool's control + demo/probe handlers (plus the
    ``_ham/buf_*`` dataplane control set).  Safe to call repeatedly;
    silently skipped on an already-sealed registry (then callers must have
    registered these before ``init()`` themselves)."""
    reg = registry or default_registry()
    register_dataplane_handlers(reg)
    for name, fn, read_only in (
        ("_cluster/sleep", _h_sleep, False),
        ("_cluster/spin", _h_spin, False),
        # touch only READS through its pointer, so it may be served from
        # any replica (the dataplane's read-only routing contract)
        ("_cluster/touch", _h_touch, True),
        ("_cluster/reset_peer", _h_reset_peer, False),
        ("_cluster/attach_peer", _h_attach_peer, False),
        ("_cluster/detach_peer", _h_detach_peer, False),
        ("_cluster/stats", _h_stats, False),
        ("_cluster/digest", _h_digest, False),
    ):
        try:
            reg.register(fn, name=name, read_only=read_only)
        except RegistrySealedError:
            return


register_cluster_handlers()


# --------------------------------------------------------------------------
# worker handles (one per launch mode)
# --------------------------------------------------------------------------


class _ThreadWorker:
    """In-process worker: a NodeRuntime on its own event-loop thread."""

    def __init__(self, node_id: int, runtime: NodeRuntime, pool: "ClusterPool"):
        self.node_id = node_id
        self.runtime = runtime
        self._pool = pool

    def alive(self) -> bool:
        t = self.runtime._thread
        return t is not None and t.is_alive()

    def kill(self) -> None:
        # closest analogue of a crash for a thread: stop the event loop cold
        self.runtime.request_stop()

    def reap(self, timeout: float = 5.0) -> None:
        self.runtime.stop(timeout)

    def respawn(self) -> "_ThreadWorker":
        pool = self._pool
        rt = NodeRuntime(
            self.node_id,
            pool.fabric.endpoint(self.node_id),
            pool.domain._table,
            policy=pool._policy_factory(),
        ).enable_depth_report(dst=pool.domain.host_node).start()
        pool.domain._inproc[self.node_id] = rt  # direct data plane follows
        return _ThreadWorker(self.node_id, rt, pool)


class _ForkWorker:
    """Forked child over shm rings (spawn_shm_workers)."""

    def __init__(self, node_id: int, proc, pool: "ClusterPool"):
        self.node_id = node_id
        self.proc = proc
        self._pool = pool

    def alive(self) -> bool:
        return self.proc.is_alive()

    def kill(self) -> None:
        self.proc.kill()

    def reap(self, timeout: float = 5.0) -> None:
        reap([self.proc], timeout)

    def respawn(self) -> "_ForkWorker":
        pool = self._pool
        proc = spawn_shm_workers(pool.fabric, [self.node_id],
                                 pool._setup_modules)[0]
        return _ForkWorker(self.node_id, proc, pool)


class _SubprocessWorker:
    """Fresh-interpreter child over TCP (spawn_socket_worker_subprocess)."""

    def __init__(self, node_id: int, popen, pool: "ClusterPool"):
        self.node_id = node_id
        self.proc = popen
        self._pool = pool

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        self.proc.kill()

    def reap(self, timeout: float = 5.0) -> None:
        reap([self.proc], timeout)

    def respawn(self) -> "_SubprocessWorker":
        pool = self._pool
        popen = spawn_socket_worker_subprocess(
            self.node_id, pool.fabric.num_nodes, pool.fabric.base_port,
            pool._setup_modules,
        )
        return _SubprocessWorker(self.node_id, popen, pool)


# --------------------------------------------------------------------------
# the pool
# --------------------------------------------------------------------------


class ClusterPool:
    """Owns the workers of one offload domain and watches them.

    Subscribers (``on_death`` / ``on_restart``) are called from the monitor
    thread with the node id; the scheduler uses these to fail in-flight
    futures and to re-admit a node into the routing set.  Callbacks must not
    block — they run on the liveness path.
    """

    def __init__(
        self,
        domain: OffloadDomain,
        workers: dict,
        *,
        monitor_interval: float = 0.1,
        auto_restart: bool = False,
        setup_modules=None,
        policy_factory=DirectPolicy,
        mode: str = "local",
        replicas: int = 0,
        mutation_refresh: bool = False,
        restart_backoff: float = 0.5,
        restart_backoff_max: float = 8.0,
        max_restarts: int = 5,
        fail_window: float = 30.0,
        quarantine_probe: float = 5.0,
    ):
        self.domain = domain
        self.fabric = domain.fabric
        self.host = domain.host
        self._mode = mode  # launch mode for elastic spawns (local/shm/socket)
        self._workers = dict(workers)
        self._dead: set[int] = set()
        self._removing: set[int] = set()  # mid-remove: no auto_restart
        self._lock = threading.Lock()
        self._resize_lock = threading.Lock()  # serialises add/remove/restart
        self._death_cbs: list = []
        self._restart_cbs: list = []
        self._join_cbs: list = []
        self._leave_cbs: list = []
        #: replication factor for the directory-tracked data plane (module
        #: docs, "Replicated data plane"); 0 = primaries only
        self.replicas = int(replicas)
        #: after a ``mutates=True`` handler commits: False (default) drops
        #: the replica copies (metadata-only invalidate, lazy re-backfill);
        #: True chain-refreshes them from the primary (commit_mutation docs)
        self.mutation_refresh = bool(mutation_refresh)
        #: thread-local gossip batching (``_gossip_batch``): oneway storms
        #: produced under it coalesce into one FLAG_FUSED frame per dst
        self._gossip_tls = threading.local()
        self.directory = BufferDirectory()
        self.host.buffer_directory = self.directory  # _ham/buf_freed target
        self._alloc_rr = 0  # round-robin primary placement for allocate()
        # serialises write-through puts/frees against holder-set mutation
        # that COPIES bytes (join/restart backfill, drain migration): a
        # holder added from a pre-put snapshot of the bytes must not become
        # promotable without also receiving the put (put's divergence guard).
        # Striped by handle — the invariant is per buffer, and a migration
        # copy can hold its lock across a multi-second network transfer;
        # striping keeps puts/frees to unrelated buffers from stalling
        # behind it except on a (1-in-64) stripe collision, which merely
        # waits, never deadlocks
        self._dataplane_locks = tuple(threading.Lock() for _ in range(64))
        # the directory's failover MUST run before any external death
        # subscriber (the scheduler repins sessions onto post-promotion
        # placement) — subscribe first, before the monitor can announce
        self.on_death(self._dataplane_on_death)
        self.on_join(self._dataplane_on_join)
        self.on_restart(self._dataplane_on_join)
        #: None => auto-derive from the host registry at each spawn
        #: (registered_setup_modules), so restarts track late registrations
        self._setup_modules = (
            None if setup_modules is None else list(setup_modules)
        )
        self._policy_factory = policy_factory
        self.auto_restart = auto_restart
        # -- auto-restart circuit breaker (module docs) --------------------
        #: first-retry delay; doubles per consecutive failure, capped below
        self.restart_backoff = float(restart_backoff)
        self.restart_backoff_max = float(restart_backoff_max)
        #: consecutive failures within ``fail_window`` that trip quarantine
        self.max_restarts = int(max_restarts)
        self.fail_window = float(fail_window)
        #: cool-down before a quarantined worker's first half-open probe
        self.quarantine_probe = float(quarantine_probe)
        self._restart_fails: dict[int, int] = {}
        self._last_fail_t: dict[int, float] = {}
        self._pending_restart: dict[int, float] = {}  # node -> due (monotonic)
        self._quarantined: set[int] = set()
        self._probe_at: dict[int, float] = {}
        self._probe_iv: dict[int, float] = {}
        # -- directory gossip (durable directory; offload.dataplane docs) --
        self.directory.on_change(self._gossip_change)
        self._closed = False
        self._stop = threading.Event()
        self._monitor = threading.Thread(
            target=self._monitor_loop, args=(monitor_interval,),
            name="ham-cluster-monitor", daemon=True,
        )
        self._monitor.start()

    # -- constructors ------------------------------------------------------

    @classmethod
    def local(cls, num_workers: int, *, registry=None,
              policy_factory=DirectPolicy, wrap_fabric=None,
              **kw) -> "ClusterPool":
        """Thread workers in this process (node 0 is the host).

        ``wrap_fabric=`` (all three constructors) wraps the fabric before
        any endpoint is handed out — e.g. ``lambda f:
        ChaosFabric(f, seed=7)`` puts every link under seeded fault
        injection (``repro_torch.comm.chaos``).
        """
        reg = registry or default_registry()
        fabric = LocalFabric(num_workers + 1)
        if wrap_fabric is not None:
            fabric = wrap_fabric(fabric)
        domain = OffloadDomain(fabric, registry=reg,
                               policy_factory=policy_factory)
        pool = cls.__new__(cls)
        workers = {}
        for node in range(1, num_workers + 1):
            rt = NodeRuntime(node, fabric.endpoint(node), domain._table,
                             policy=policy_factory()).enable_depth_report(
                dst=domain.host_node).start()
            domain._inproc[node] = rt  # direct put/get shortcut stays live
            workers[node] = _ThreadWorker(node, rt, pool)
        pool.__init__(domain, workers, policy_factory=policy_factory,
                      mode="local", **kw)
        return pool

    @classmethod
    def shm(cls, num_workers: int, *, registry=None, capacity: int = 1 << 24,
            setup_modules=None, wrap_fabric=None, **kw) -> "ClusterPool":
        """Forked processes over shared-memory rings.

        ``setup_modules=None`` auto-derives the worker import list from the
        host's default registry (same-source key agreement by construction).
        ``wrap_fabric=`` as in :meth:`local` — forked workers inherit the
        wrapper, so both directions of every link are under fault injection.
        """
        from repro_torch.comm.shm import ShmFabric

        reg = registry or default_registry()
        fabric = ShmFabric(num_workers + 1, capacity=capacity)
        if wrap_fabric is not None:
            fabric = wrap_fabric(fabric)
        procs = spawn_shm_workers(fabric, list(range(1, num_workers + 1)),
                                  setup_modules)
        domain = OffloadDomain(fabric, registry=reg)
        pool = cls.__new__(cls)
        workers = {
            node: _ForkWorker(node, proc, pool)
            for node, proc in zip(range(1, num_workers + 1), procs)
        }
        pool.__init__(domain, workers, setup_modules=setup_modules,
                      mode="shm", **kw)
        return pool

    @classmethod
    def socket(cls, num_workers: int, *, registry=None, setup_modules=None,
               wrap_fabric=None, **kw) -> "ClusterPool":
        """Fresh-interpreter workers over loopback TCP (``setup_modules``
        as in :meth:`shm` — None auto-derives from the host registry).
        ``wrap_fabric=`` as in :meth:`local`; socket workers build their own
        endpoints in the child interpreter, so only the HOST side of each
        link is wrapped — chaos recv-side injection (keyed by the frame's
        ``src_node``) still exercises both directions."""
        from repro_torch.comm.socket import SocketFabric

        reg = registry or default_registry()
        fabric = SocketFabric(num_workers + 1)
        if wrap_fabric is not None:
            fabric = wrap_fabric(fabric)
        popens = [
            spawn_socket_worker_subprocess(node, num_workers + 1,
                                           fabric.base_port, setup_modules)
            for node in range(1, num_workers + 1)
        ]
        domain = OffloadDomain(fabric, registry=reg)
        pool = cls.__new__(cls)
        workers = {
            node: _SubprocessWorker(node, popen, pool)
            for node, popen in zip(range(1, num_workers + 1), popens)
        }
        pool.__init__(domain, workers, setup_modules=setup_modules,
                      mode="socket", **kw)
        return pool

    # -- introspection -----------------------------------------------------

    @property
    def worker_nodes(self) -> list[int]:
        return sorted(self._workers)

    def live_nodes(self) -> list[int]:
        with self._lock:
            return sorted(n for n in self._workers if n not in self._dead)

    def is_alive(self, node: int) -> bool:
        with self._lock:
            return node in self._workers and node not in self._dead

    def ping_all(self, timeout: float = 20.0) -> None:
        """Round-trip every worker once (startup barrier for process pools)."""
        for node in self.worker_nodes:
            self.domain.ping(node, node, timeout=timeout)

    # -- liveness ----------------------------------------------------------

    def on_death(self, cb) -> None:
        self._death_cbs.append(cb)

    def on_restart(self, cb) -> None:
        self._restart_cbs.append(cb)

    def on_join(self, cb) -> None:
        """``cb(node)`` after an added worker is up, verified and routable."""
        self._join_cbs.append(cb)

    def on_leave(self, cb) -> None:
        """``cb(node)`` at the *start* of a remove — the fence point: the
        subscriber must stop routing new work to the node immediately.  A
        callable return value is a drain waiter ``waiter(timeout)`` that
        ``remove_node(drain=True)`` blocks on before tearing the worker
        down (the scheduler waits out the node's in-flight futures there).
        """
        self._leave_cbs.append(cb)

    def _monitor_loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            for node in self.worker_nodes:
                with self._lock:
                    handle = self._workers.get(node)
                    announced = node in self._dead
                if handle is None or announced:
                    continue
                if not handle.alive():
                    self._announce_death(node)
            self._run_due_restarts()

    def _announce_death(self, node: int) -> None:
        with self._lock:
            if node in self._dead:
                return
            self._dead.add(node)
        for cb in self._death_cbs:
            try:
                cb(node)
            except Exception:  # noqa: BLE001 — one bad subscriber must not
                # stop death propagation to the others
                import traceback

                traceback.print_exc()
        with self._lock:
            removing = node in self._removing or node not in self._workers
        if self.auto_restart and not self._closed and not removing:
            self._schedule_restart(node)

    # -- auto-restart circuit breaker ---------------------------------------
    #
    # A crash-looping worker used to restart inline in _announce_death — a
    # tight respawn/crash/respawn loop that burned CPU and kept readmitting
    # a node that could not hold traffic.  Deaths now *schedule* a restart
    # with capped exponential backoff, and ``max_restarts`` consecutive
    # failures inside ``fail_window`` trip a quarantine: the node stays out
    # of the pool (on_death was announced exactly once; the scheduler has
    # already drained it) until a half-open probe — restart + ping after
    # ``quarantine_probe`` seconds, interval doubling per failed probe —
    # succeeds, or an operator calls :meth:`readmit`.

    def _schedule_restart(self, node: int) -> None:
        now = time.monotonic()
        with self._lock:
            fails = self._restart_fails.get(node, 0)
            if now - self._last_fail_t.get(node, 0.0) > self.fail_window:
                fails = 0  # earlier failures aged out of the window
            fails += 1
            self._restart_fails[node] = fails
            self._last_fail_t[node] = now
            if fails > self.max_restarts:
                self._quarantined.add(node)
                self._pending_restart.pop(node, None)
                iv = self._probe_iv.get(node, self.quarantine_probe)
                self._probe_iv[node] = iv
                self._probe_at[node] = now + iv
                return
            delay = min(self.restart_backoff * (2 ** (fails - 1)),
                        self.restart_backoff_max)
            self._pending_restart[node] = now + delay

    def _run_due_restarts(self) -> None:
        """Monitor-loop tail: execute scheduled restarts and half-open
        probes that have come due (restarts never run inline on the death
        announcement path any more)."""
        now = time.monotonic()
        with self._lock:
            due = [n for n, t in self._pending_restart.items() if t <= now]
            for n in due:
                del self._pending_restart[n]
            probes = [n for n, t in self._probe_at.items() if t <= now]
            for n in probes:
                del self._probe_at[n]
        for node in due + probes:
            with self._lock:
                skip = (self._closed or node in self._removing
                        or node not in self._workers)
            if skip:
                continue
            probing = node in self._quarantined
            try:
                self.restart(node)
                if probing:
                    self.domain.ping(node, node, timeout=5.0)
            except Exception:  # noqa: BLE001 — the respawn (or probe ping)
                # failed: count it as another consecutive failure
                import traceback

                traceback.print_exc()
                if probing:
                    with self._lock:
                        iv = min(self._probe_iv.get(
                            node, self.quarantine_probe) * 2, 60.0)
                        self._probe_iv[node] = iv
                        self._probe_at[node] = time.monotonic() + iv
                else:
                    self._schedule_restart(node)
                continue
            with self._lock:
                # the worker came back (and, if probing, answered a ping):
                # close the breaker — but keep the failure timestamp, so an
                # immediate re-crash lands back in the window
                self._quarantined.discard(node)
                self._restart_fails[node] = 0
                self._probe_iv.pop(node, None)

    def is_quarantined(self, node: int) -> bool:
        with self._lock:
            return node in self._quarantined

    def readmit(self, node: int) -> None:
        """Operator override: clear a node's quarantine and restart it now
        (the breaker re-arms — it is not a permanent exemption)."""
        with self._lock:
            self._quarantined.discard(node)
            self._restart_fails[node] = 0
            self._probe_at.pop(node, None)
            self._probe_iv.pop(node, None)
        if self.is_alive(node):
            return
        self.restart(node)

    def kill(self, node: int) -> None:
        """Fault injection: hard-stop a worker (no goodbye on the wire)."""
        self._workers[node].kill()

    # -- replicated data plane (module docs; protocol in offload.dataplane) --

    def allocate(self, shape, dtype, *, node: int | None = None,
                 session=None, replicas: int | None = None,
                 timeout: float = 30.0) -> BufferPtr:
        """Allocate a directory-tracked buffer: primary on ``node`` (or the
        next live worker round-robin), ``replicas`` empty copies installed
        under the same global handle on other live workers (write-through
        ``put`` keeps them coherent).  ``session=`` binds the buffer to a
        sticky-session key: on failover the session repins onto the node
        holding its bytes, and ending the session frees the buffer
        everywhere (``Scheduler.end_session`` / :meth:`release_session`).
        """
        live = self.live_nodes()
        if not live:
            raise OffloadError("no live workers to place a buffer on")
        rr = self._alloc_rr
        self._alloc_rr += 1
        if node is None:
            node = live[rr % len(live)]
        elif node not in live:
            raise OffloadError(f"worker {node} is not live")
        ptr = self.domain.allocate(node, shape, dtype)
        want = self.replicas if replicas is None else int(replicas)
        # rotate replica placement with the same counter as primaries so
        # replicas (and their write-through traffic) spread over the pool
        # instead of piling onto the lowest ids
        others = [n for n in live if n != node]
        reps = [others[(rr + i) % len(others)]
                for i in range(min(want, len(others)))]
        for rep in reps:
            self.domain.sync(
                rep,
                f2f("_ham/buf_adopt", int(ptr.handle),
                    [int(d) for d in shape], str(np.dtype(dtype)),
                    registry=self.domain.registry),
                timeout,
            )
        return self.directory.register(ptr, shape, np.dtype(dtype),
                                       replicas=reps, session=session)

    def _buffer_lock(self, handle: int) -> threading.Lock:
        """The data-plane lock stripe for one buffer (``__init__`` notes);
        everything holding one stripe never takes another, so stripes can
        never deadlock."""
        return self._dataplane_locks[int(handle) % len(self._dataplane_locks)]

    def put(self, src, ptr: BufferPtr, *, offset: int = 0) -> None:
        """Chain-replicated write-through put: the payload goes to the
        primary ONCE (zero-copy chunked pipeline) and the primary streams
        it to the replicas over worker->worker links, forwarding chunk k
        while chunk k+1 is still arriving — the host pays one transfer
        regardless of the replica count (``repro_torch.offload.dataplane``,
        "Chain replication"; contract in docs/failure-model.md).

        Divergence guard: the write is sequenced by a directory-minted
        dirty epoch; a replica that did not confirm the COMPLETE write
        (died, partitioned, or torn mid-chain) is DROPPED from the holder
        set at commit — a copy that may be stale must never be promotable.
        A primary that did not confirm raises (and every holder's
        ``applied_dirty`` watermark keeps the torn state detectable at a
        host rebuild).

        Holds the buffer's data-plane lock so its holder set cannot change
        under it by a byte-copying path: a join/restart backfill (or drain
        migration) that snapshotted the bytes pre-put either completes
        first — and this put then writes through the new holder too — or
        starts after the put and copies the new bytes.  Either way no
        promotable holder misses the write."""
        with self._buffer_lock(ptr.handle):
            rec = self.directory.lookup(ptr.handle)
            if rec is None:  # untracked (or lost — resolve raises diagnosis)
                self.domain.put(src, self.directory.resolve(ptr),
                                offset=offset)
                return
            live_reps = [r for r in rec.replicas if self.is_alive(r)]
            for dead in rec.replicas:
                if dead not in live_reps:
                    self.directory.remove_replica(rec.handle, dead)
            if not live_reps:
                # no chain to drive: the plain single-destination put
                self.domain.put(src, ptr.at(rec.primary, rec.epoch),
                                offset=offset)
                return
            dirty = self.directory.begin_write(rec.handle)
            try:
                confirmed = self.domain.chain_put(
                    src, ptr.at(rec.primary, rec.epoch), live_reps, dirty,
                    offset=offset)
            except Exception:
                # the chain never confirmed (primary unreachable / chunk
                # failed): the primary may hold a torn write at epoch
                # ``dirty`` while the replicas hold the previous write.
                # Keep every holder — the applied_dirty watermarks name
                # the divergence at rebuild — and surface the failure.
                self.directory.commit_write(rec.handle)
                raise
            stale = [r for r in live_reps if r not in confirmed]
            self.directory.commit_write(rec.handle, stale=stale)
            if rec.primary not in confirmed:
                raise OffloadError(
                    f"chain put of buffer {rec.handle:#x} did not confirm "
                    f"on primary {rec.primary} (confirmed: {confirmed}) — "
                    "the write is torn; see docs/failure-model.md"
                )

    def get(self, ptr: BufferPtr, **kw):
        """Directory-resolved get: a stale-epoch pointer is transparently
        rewritten to the current primary before the fetch."""
        return self.domain.get(self.directory.resolve(ptr), **kw)

    def free(self, ptr: BufferPtr, timeout: float = 10.0) -> None:
        """Free the logical buffer everywhere: the record is dropped first
        (a racing worker-side ``_ham/buf_freed`` becomes a no-op), then the
        primary gets a strict ``_ham/free`` and every replica an idempotent
        ``_ham/buf_invalidate`` — ``live_count`` stays truthful cluster-wide
        and no replica outlives its buffer.  The drop takes the data-plane
        lock so a backfill copying this buffer finishes registering its new
        holder first (and is then invalidated with the rest) instead of
        adopting an orphan copy of a freed buffer."""
        with self._buffer_lock(ptr.handle):
            rec = self.directory.drop(ptr.handle)
        if rec is None:
            self.domain.free(ptr)  # untracked: the paper's plain free
            return
        for holder in rec.holders:
            if not self.is_alive(holder):
                continue  # its registry died with it
            try:
                if holder == rec.primary:
                    self.domain.free(ptr.at(holder, rec.epoch))
                else:
                    self.domain.sync(
                        holder,
                        f2f("_ham/buf_invalidate", int(rec.handle),
                            registry=self.domain.registry),
                        timeout,
                    )
            except Exception:  # noqa: BLE001 — a holder dying mid-free is
                # equivalent to it having freed; nothing leaks
                pass

    def release_session(self, session) -> int:
        """Free every buffer bound to ``session`` (the session ended — its
        data plane must not leak replicas); returns the number freed."""
        records = self.directory.session_records(session)
        with self._gossip_batch():  # one fused journal frame per survivor
            for rec in records:
                try:
                    self.free(rec.ptr())
                except Exception:  # noqa: BLE001 — keep releasing the rest
                    import traceback

                    traceback.print_exc()
        return len(records)

    def buffer_count(self, node: int, timeout: float = 10.0) -> int:
        """Live buffers held by ``node``'s registry (cluster-wide hygiene
        checks: replicas freed, nothing leaked)."""
        return int(self.domain.sync(
            node, f2f("_ham/buf_count", registry=self.domain.registry),
            timeout,
        ))

    def _copy_buffer(self, rec, src: int, dst: int,
                     timeout: float = 30.0) -> None:
        """Stream one buffer ``src`` -> ``dst`` under its global handle
        over the worker->worker chain (``_ham/chain_push``): the source
        streams its own bytes — adopt + windowed chunk pipeline + flush —
        and the host never stages the payload (it used to fetch the whole
        buffer and re-put it).  The copy lands stamped with the buffer's
        current dirty epoch, so the new holder's ``applied_dirty``
        watermark matches its peers'."""
        dom = self.domain
        confirmed = dom.sync(
            src,
            f2f("_ham/chain_push", int(rec.handle), [int(dst)],
                int(getattr(rec, "dirty", 0)), int(dom.chunk_nbytes), True,
                registry=dom.registry),
            timeout,
        )
        if int(dst) not in [int(n) for n in confirmed]:
            raise OffloadError(
                f"chain push of buffer {rec.handle:#x} {src}->{dst} did "
                f"not confirm (confirmed: {confirmed})"
            )

    def _dataplane_on_death(self, node: int) -> None:
        """First death subscriber: metadata-only replica promotion (+ lost
        accounting + session repin hooks) — see BufferDirectory.  The
        per-buffer gossip storm is batched: one fused frame per survivor."""
        with self._gossip_batch():
            self.directory.on_node_death(node)

    def _dataplane_on_join(self, node: int) -> None:
        """Join/restart subscriber: lazy backfill — buffers left
        under-replicated by earlier deaths copy one replica onto the
        joiner (data moves here, at join time, not on the death path).

        Each buffer's copy + directory registration runs under the
        buffer's data-plane lock stripe (concurrent puts to buffers on
        other stripes interleave): a write-through put can never land
        between our
        snapshot of the bytes and the joiner becoming a promotable holder
        — it either precedes the copy (we copy the new bytes) or follows
        the registration (it writes through the joiner too).  The record
        is re-read under the lock so a buffer freed or mutated since the
        under-replication scan is skipped, not resurrected."""
        if not self.replicas:
            return
        live = set(self.live_nodes())
        for stale in self.directory.under_replicated(self.replicas, live):
            with self._buffer_lock(stale.handle):
                rec = self.directory.lookup(stale.handle)
                if rec is None or node in rec.holders \
                        or rec.primary not in live:
                    continue
                try:
                    self._copy_buffer(rec, rec.primary, node)
                    self.directory.add_replica(rec.handle, node)
                except Exception:  # noqa: BLE001 — backfill is best-effort;
                    # the buffer stays under-replicated until the next join
                    import traceback

                    traceback.print_exc()

    # -- durable directory: gossip fan-out + host crash recovery ------------
    # (protocol in repro_torch.offload.dataplane, "Directory gossip" section)

    @staticmethod
    def _gossip_entry(handle: int, rec) -> list:
        """Wire form of one directory record (``_ham/dir_gossip`` /
        ``_ham/dir_dump`` share it): ``[handle, primary, replicas, epoch,
        nbytes, shape, dtype, session, dirty]``; ``primary = -1`` is a
        tombstone."""
        if rec is None:
            return [int(handle), -1, [], 0, 0, [], "", None, 0]
        return [int(rec.handle), int(rec.primary),
                [int(r) for r in rec.replicas], int(rec.epoch),
                int(rec.nbytes), [int(d) for d in rec.shape],
                str(rec.dtype), rec.session, int(getattr(rec, "dirty", 0))]

    def _gossip_change(self, handle: int, rec, holders) -> None:
        """Directory-journal subscriber: push the updated record to every
        live worker named in ``holders`` as a best-effort ``_ham/dir_gossip``
        oneway (a lost gossip frame degrades recovery, never correctness —
        the dataplane module docs state the guarantee).  Inside a
        :meth:`_gossip_batch` scope the sends are parked and flushed as one
        ``FLAG_FUSED`` frame per destination — an invalidation storm
        (mutation commit, node death, session release) costs one transport
        publication per worker, not one per buffer."""
        if getattr(self, "_closed", False):
            return
        entry = self._gossip_entry(handle, rec)
        me = self.host.node_id
        batch = getattr(self._gossip_tls, "buf", None)
        for node in holders:
            if node == me or not self.is_alive(node):
                continue
            fn = f2f("_ham/dir_gossip", [entry], registry=self.domain.registry)
            if batch is not None:
                batch.setdefault(int(node), []).append(fn)
                continue
            try:
                self.domain.oneway(node, fn)
            except Exception:  # noqa: BLE001 — best-effort journal
                pass

    def _queue_oneway(self, node: int, fn) -> None:
        """Send ``fn`` to ``node`` as a oneway — parked for the per-dst
        fused flush when inside a :meth:`_gossip_batch` scope."""
        batch = getattr(self._gossip_tls, "buf", None)
        if batch is not None:
            batch.setdefault(int(node), []).append(fn)
            return
        try:
            self.domain.oneway(node, fn)
        except Exception:  # noqa: BLE001 — best-effort control traffic
            pass

    def _gossip_batch(self):
        """Context manager: coalesce every gossip/invalidation oneway
        emitted in this thread while the scope is open into ONE
        ``FLAG_FUSED`` frame per destination (``NodeRuntime.
        send_oneway_fused``).  Nestable — only the outermost scope
        flushes."""
        import contextlib

        @contextlib.contextmanager
        def scope():
            if getattr(self._gossip_tls, "buf", None) is not None:
                yield  # nested: the outer scope owns the flush
                return
            self._gossip_tls.buf = {}
            try:
                yield
            finally:
                buf, self._gossip_tls.buf = self._gossip_tls.buf, None
                for dst, fns in buf.items():
                    if not self.is_alive(dst):
                        continue
                    try:
                        self.host.send_oneway_fused(dst, fns)
                    except Exception:  # noqa: BLE001 — best-effort journal
                        pass

        return scope()

    def commit_mutation(self, handles, *, refresh: bool | None = None,
                        timeout: float = 30.0) -> None:
        """Active-Access write commit: after a ``mutates=True`` handler ran
        at the primary, bump each buffer's dirty epoch and restore replica
        coherence (dataplane module docs, "Mutate-at-data"; contract in
        docs/failure-model.md, "Write visibility and convergence").

        ``refresh=False`` (default from ``mutation_refresh``) **drops** the
        replica copies — a metadata-only invalidate (one fused oneway frame
        per holder), with the copies re-backfilled lazily at the next
        join/restart.  ``refresh=True`` keeps the holder set and
        chain-pushes the new bytes from the primary down the same chain a
        put would use; a replica that does not confirm the refresh is
        dropped instead (never left promotable-but-stale).  Called by the
        scheduler's commit hook after every successful (or failed —
        half-applied mutations invalidate too) mutating call."""
        refresh = self.mutation_refresh if refresh is None else bool(refresh)
        with self._gossip_batch():
            for handle in handles:
                handle = int(handle)
                with self._buffer_lock(handle):
                    rec = self.directory.lookup(handle)
                    if rec is None:
                        continue
                    dirty = self.directory.begin_write(handle)
                    live_reps = [r for r in rec.replicas if self.is_alive(r)]
                    dead_reps = [r for r in rec.replicas
                                 if r not in live_reps]
                    if not live_reps:
                        self.directory.commit_write(handle, stale=dead_reps)
                        continue
                    if refresh:
                        try:
                            confirmed = self.domain.sync(
                                rec.primary,
                                f2f("_ham/chain_push", handle, live_reps,
                                    dirty, int(self.domain.chunk_nbytes),
                                    False, registry=self.domain.registry),
                                timeout,
                            )
                        except Exception:  # noqa: BLE001 — an unreachable
                            # chain degrades to the invalidate outcome for
                            # the unconfirmed holders
                            confirmed = [rec.primary]
                        stale = [r for r in rec.replicas
                                 if r not in {int(n) for n in confirmed}]
                        self.directory.commit_write(handle, stale=stale)
                        for r in stale:
                            if self.is_alive(r):
                                self._queue_oneway(r, f2f(
                                    "_ham/buf_invalidate", handle,
                                    registry=self.domain.registry))
                        continue
                    # invalidate: metadata-only — drop every replica from
                    # the holder set and tell it to free its copy
                    self.directory.commit_write(handle,
                                                stale=list(rec.replicas))
                    for r in live_reps:
                        self._queue_oneway(r, f2f(
                            "_ham/buf_invalidate", handle,
                            registry=self.domain.registry))

    def mutate(self, function, *, timeout: float = 30.0):
        """Active-Access write as a pool primitive: run a ``mutates=True``
        handler AT the primary holding the buffers it references, then
        commit the write (dirty-epoch bump + replica invalidate/refresh,
        :meth:`commit_mutation`) before returning the handler's result.

        This is the bare protocol round trip — one targeted sync call
        plus the commit, nothing else attached.  Routing the same call
        through a :class:`~repro_torch.cluster.scheduler.Scheduler` gives the
        identical write-coherence contract for *scheduled* traffic, with
        queueing, deadlines and retries on top.

        The commit runs on success AND on a raised handler (a handler may
        mutate before raising — replicas must not keep serving the
        half-overwritten bytes); the handler's own error outranks a
        commit failure.  Raises :class:`OffloadError` for a handler not
        declared ``mutates=True``, or one referencing no directory-tracked
        buffer (nothing to route on or commit)."""
        if not getattr(function.record, "mutates", False):
            raise OffloadError(
                f"pool.mutate needs a mutates=True handler; "
                f"{function.record.stable_name!r} is not declared mutating "
                "(docs/failure-model.md, 'Write visibility and "
                "convergence')"
            )
        handles = tracked_handles(self.directory, function.args)
        if not handles:
            raise OffloadError(
                "pool.mutate call references no directory-tracked buffer "
                "— nothing to route on or commit"
            )
        votes = mig.scan_locality(function.args,
                                  resolver=self.directory.primary_resolver)
        live = {n: w for n, w in votes.items() if self.is_alive(n)}
        if not live:
            raise OffloadError(
                "no live primary for the buffers referenced by "
                f"{function.record.stable_name!r} (handles "
                f"{[hex(h) for h in handles]})"
            )
        target = max(live, key=lambda n: live[n])
        new_args, changed = self.directory.resolve_args(function.args,
                                                        target=target)
        if changed:
            function = Function(function.record, new_args)
        try:
            result = self.domain.sync(target, function, timeout)
        except BaseException:
            try:  # half-applied mutations invalidate too
                self.commit_mutation(handles, timeout=timeout)
            except Exception:  # noqa: BLE001 — the call's error outranks
                pass
            raise
        self.commit_mutation(handles, timeout=timeout)
        return result

    def restart_host(self, timeout: float = 30.0) -> dict:
        """Crash-recover the HOST in place (the last unprotected failure
        domain — workers got this in PR 5).

        The host runtime is torn down — every outstanding future fails with
        :class:`NodeDownError`, exactly what a real crash does to callers —
        and a fresh :class:`NodeRuntime` starts on the SAME endpoint with a
        fresh future table and msg_id space.  The :class:`BufferDirectory`
        is rebuilt by sync-calling ``_ham/dir_dump`` on every survivor and
        merging the shards: highest epoch wins, ties prefer the dumper that
        is its own primary; an entry whose primary did not survive promotes
        onto its lowest live replica (epoch bump — the crash-promotion
        rule); an entry with no live holder counts ``lost``.  Finally every
        survivor's replay cache is flushed (``_ham/replay_ack`` with a
        max sentinel): the new host's msg_id counter restarts at 1, so a
        cached reply keyed by an old id could otherwise alias a new call.

        Schedulers bound to the old host runtime must be recreated after
        this returns (their future table and credit state died with it).
        Returns ``{"recovered": n, "lost": m, "seconds": s}``.
        """
        t0 = time.monotonic()
        with self._resize_lock:
            old = self.host
            host_node = old.node_id
            old.stop(2.0)  # fails outstanding futures; endpoint stays open
            new = NodeRuntime(host_node, old.endpoint, self.domain._table)
            new.start()
            self.host = new
            self.domain.host = new
            self.domain._inproc[host_node] = new
            survivors = self.live_nodes()
            # merge the survivors' shards (docstring: epoch-max, dumper-is-
            # primary tiebreak — a node serving a buffer has the freshest
            # view of it)
            best: dict[int, tuple] = {}
            #: handle -> {dumper node -> applied_dirty watermark} — the
            #: chain protocol's stale-tail evidence (dump element 10)
            applied_by: dict[int, dict[int, int]] = {}
            for node in survivors:
                try:
                    entries = self.domain.sync(
                        node,
                        f2f("_ham/dir_dump", registry=self.domain.registry),
                        timeout,
                    )
                except Exception:  # noqa: BLE001 — a survivor dying during
                    # recovery just shrinks the merge set
                    continue
                for e in entries:
                    h, p = int(e[0]), int(e[1])
                    rank = (int(e[3]), 1 if p == node else 0)
                    cur = best.get(h)
                    if cur is None or rank > cur[0]:
                        best[h] = (rank, e)
                    if len(e) > 9:
                        applied_by.setdefault(h, {})[node] = int(e[9])
            live = set(survivors)
            records: list[BufferRecord] = []
            promoted: list[BufferRecord] = []
            lost_map: dict[int, str] = {}
            for h, (_rank, e) in sorted(best.items()):
                _, p, reps, epoch, nbytes, shape, dtype, session = e[:8]
                dirty = int(e[8]) if len(e) > 8 else 0
                p, epoch = int(p), int(epoch)
                reps = sorted({int(r) for r in reps} & live - {p})
                # stale-tail filter (chain write protocol): a holder whose
                # bytes reflect an older write epoch than a surviving
                # peer's was cut off mid-chain — it must not be promotable.
                # Holders that never reported a watermark (pre-v2 peers)
                # get the benefit of the doubt; all-equal watermarks keep
                # every holder (the torn-primary residual — the failed
                # write already raised at the caller).
                amap = applied_by.get(h, {})
                maxa = max(amap.values(), default=0)
                stale_tail = [r for r in reps
                              if amap.get(r, maxa) < maxa]
                reps = [r for r in reps if r not in stale_tail]
                was_promoted = False
                if p not in live:
                    if not reps:
                        lost_map[h] = "no holder survived the host crash"
                        continue
                    p = reps.pop(0)  # lowest live replica, as on_node_death
                    epoch += 1
                    was_promoted = True
                elif amap.get(p, maxa) < maxa and reps:
                    # the primary itself missed the newest write some
                    # replica holds complete: promote the freshest holder
                    # (ties lowest-id) — the old primary's copy is stale
                    p = min(reps, key=lambda r: (-amap.get(r, maxa), r))
                    reps = [r for r in reps if r != p]
                    epoch += 1
                    was_promoted = True
                rec = BufferRecord(
                    handle=h, primary=p, replicas=tuple(reps), epoch=epoch,
                    nbytes=int(nbytes), shape=tuple(int(d) for d in shape),
                    dtype=str(dtype), session=session,
                    dirty=max(dirty, maxa),
                )
                records.append(rec)
                if was_promoted:
                    promoted.append(rec)
            directory = BufferDirectory()
            directory.install(records, lost=lost_map)
            directory.on_change(self._gossip_change)
            self.directory = directory
            new.buffer_directory = directory
            # push the rebuild-time promotions back out (install itself does
            # not re-gossip — but these entries CHANGED during the merge)
            for rec in promoted:
                self._gossip_change(rec.handle, rec, rec.holders)
            # flush worker replay caches: the old host's msg_id space is
            # dead, and the new counter would alias its low ids
            for node in survivors:
                try:
                    self.domain.oneway(node, f2f(
                        "_ham/replay_ack", host_node, ReplayCache.FLUSH,
                        registry=self.domain.registry,
                    ))
                except Exception:  # noqa: BLE001 — the FIFO cap still bounds
                    pass
            return {"recovered": len(records), "lost": len(lost_map),
                    "seconds": time.monotonic() - t0}

    def _migrate_off(self, node: int, timeout: float = 30.0) -> None:
        """Lossless-shrink half of ``remove_node(drain=True)``: move every
        primary off ``node`` — promote a surviving replica when one already
        holds the bytes (zero copy), else stream to a survivor — backfill
        the replicas it held, detach it from the directory, and repin the
        sessions whose buffers moved.

        Each buffer moves under the data-plane lock (copy + epoch bump
        atomic w.r.t. write-through puts): a concurrent put either lands
        before the copy — and the copy carries it — or after the bump, when
        the directory already names the new primary.  The record is
        re-read under the lock so a buffer freed since the scan is
        skipped."""
        live = [n for n in self.live_nodes() if n != node]
        if not live:
            # shrinking to zero workers: there is nowhere to move the data —
            # take the crash path so the loss is *recorded*, not silent
            self.directory.on_node_death(node)
            return
        moved: list[int] = []
        rr = 0
        for stale in self.directory.primaries_on(node):
            with self._buffer_lock(stale.handle):
                rec = self.directory.lookup(stale.handle)
                if rec is None or rec.primary != node:
                    continue  # freed or already moved since the scan
                reps = [r for r in rec.replicas if r in live]
                if reps:
                    dst = min(reps)  # the bytes are already there
                else:
                    dst = live[rr % len(live)]
                    rr += 1
                    try:
                        self._copy_buffer(rec, node, dst, timeout)
                    except Exception:  # noqa: BLE001 — an unreadable buffer
                        # at migration time degrades to the crash outcome for
                        # this buffer only (recorded LOST, resolves raise the
                        # diagnosis); the removal itself must proceed
                        import traceback

                        traceback.print_exc()
                        self.directory.mark_lost(
                            rec.handle,
                            f"migration off node {node} failed at its "
                            "removal",
                        )
                        continue
                self.directory.set_primary(rec.handle, dst)
                moved.append(rec.handle)
        if self.replicas:
            for stale in self.directory.replicas_on(node):
                with self._buffer_lock(stale.handle):
                    rec = self.directory.lookup(stale.handle)
                    if rec is None or node not in rec.replicas:
                        continue  # freed or re-placed since the scan
                    candidates = [n for n in live if n not in rec.holders]
                    if not candidates or rec.primary not in live:
                        continue
                    try:
                        self._copy_buffer(rec, rec.primary, candidates[0],
                                          timeout)
                        self.directory.add_replica(rec.handle, candidates[0])
                    except Exception:  # noqa: BLE001
                        import traceback

                        traceback.print_exc()
        self.directory.detach_node(node)
        if moved:
            self.directory.repin_sessions_moved(moved)

    # -- elastic membership ------------------------------------------------

    def _spawn_worker(self, node: int):
        """Launch a worker for ``node`` in this pool's launch mode (the
        fabric must already have the node's transport resources)."""
        if self._mode == "local":
            rt = NodeRuntime(
                node, self.fabric.endpoint(node), self.domain._table,
                policy=self._policy_factory(),
            ).enable_depth_report(dst=self.domain.host_node).start()
            self.domain._inproc[node] = rt  # direct data plane follows
            return _ThreadWorker(node, rt, self)
        if self._mode == "shm":
            proc = spawn_shm_workers(self.fabric, [node],
                                     self._setup_modules)[0]
            return _ForkWorker(node, proc, self)
        if self._mode == "socket":
            popen = spawn_socket_worker_subprocess(
                node, self.fabric.num_nodes, self.fabric.base_port,
                self._setup_modules,
            )
            return _SubprocessWorker(node, popen, self)
        raise OffloadError(f"unknown pool mode {self._mode!r}")

    def add_node(self, *, timeout: float = 30.0) -> int:
        """Grow the pool by one worker under live traffic; returns its node
        id.  Protocol (ordering contract in the module docs): provision the
        fabric, attach the host, sync-broadcast ``_cluster/attach_peer`` to
        every live worker, spawn, barrier-ping, verify the newcomer's
        key-map digest, then announce ``on_join``.
        """
        if self._closed:
            raise OffloadError("pool is closed")
        with self._resize_lock:
            node = self.fabric.add_node()
            handle = None
            try:
                self.host.endpoint.attach_peer(node)
                for peer in self.live_nodes():
                    self.domain.sync(
                        peer,
                        f2f("_cluster/attach_peer", node,
                            registry=self.domain.registry),
                        timeout,
                    )
                handle = self._spawn_worker(node)
                with self._lock:
                    self._workers[node] = handle
                    self._dead.discard(node)
                self.domain.ping(node, node, timeout=timeout)
                digest = self.domain.sync(
                    node,
                    f2f("_cluster/digest", registry=self.domain.registry),
                    timeout,
                )
                verify_peer_digest(self.domain._table, bytes.fromhex(digest))
            except Exception:
                # full rollback — a worker that failed its barrier ping or
                # digest check must NOT stay a routable member: reap it,
                # undo the attach broadcasts, reclaim the fabric resources
                with self._lock:
                    self._removing.add(node)  # no auto_restart interference
                    self._workers.pop(node, None)
                    self._dead.discard(node)
                try:
                    if handle is not None:
                        handle.reap(5.0)
                finally:
                    for peer in self.live_nodes():
                        try:
                            self.domain.sync(
                                peer,
                                f2f("_cluster/detach_peer", node,
                                    registry=self.domain.registry),
                                5.0,
                            )
                        except Exception:  # noqa: BLE001 — best effort
                            pass
                    self.host.endpoint.detach_peer(node)
                    self.fabric.remove_node(node)
                    self.domain._inproc.pop(node, None)
                    with self._lock:
                        self._removing.discard(node)
                raise
            # announce INSIDE the resize lock: a concurrent remove_node of
            # this id serialises behind us, so a subscriber can never admit
            # a node that another thread already finished retiring
            for cb in self._join_cbs:
                try:
                    cb(node)
                except Exception:  # noqa: BLE001 — one bad subscriber must
                    # not block the others from admitting the node
                    import traceback

                    traceback.print_exc()
        return node

    def remove_node(self, node: int, *, drain: bool = True,
                    timeout: float = 30.0) -> None:
        """Retire one worker.  ``drain=True`` fences new submits (via
        ``on_leave``) and waits up to ``timeout`` for the node's in-flight
        calls to finish before terminating it — calls still running at the
        deadline are failed (as on death) so the removal always completes;
        ``drain=False`` fails them immediately.  Either way the id is never
        reused and every surviving endpoint detaches it (module docs,
        shrink protocol).
        """
        with self._resize_lock:
            with self._lock:
                if node not in self._workers:
                    raise OffloadError(f"no worker with node id {node}")
                self._removing.add(node)
                handle = self._workers[node]
            try:
                if drain:
                    # lossless shrink: primaries migrate off while the node
                    # still serves gets — BEFORE the scheduler fence, so the
                    # directory never routes at a fenced node (module docs);
                    # the per-buffer gossip batches into fused frames
                    with self._gossip_batch():
                        self._migrate_off(node, timeout)
                waiters = []
                for cb in self._leave_cbs:
                    try:
                        w = cb(node)
                    except Exception:  # noqa: BLE001
                        import traceback

                        traceback.print_exc()
                        continue
                    if callable(w):
                        waiters.append(w)
                if drain:
                    try:
                        for w in waiters:
                            w(timeout)
                    except TimeoutError:
                        # a handler outlived the drain budget: removal must
                        # still complete (a half-removed node — fenced but
                        # alive and attached — is worse than a failed call),
                        # so fail the stragglers through the death path and
                        # re-run the waiters, which now return immediately
                        self._announce_death(node)
                        for w in waiters:
                            w(5.0)
                else:
                    # fail the node's in-flight work through the normal
                    # death path (subscribers already fenced new submits),
                    # then run the waiters anyway — the rejected futures
                    # resolve instantly and subscribers retire node state
                    self._announce_death(node)
                    for w in waiters:
                        w(min(timeout, 5.0))
                if self.is_alive(node):
                    try:
                        self.domain.oneway(
                            node,
                            f2f("_ham/terminate",
                                registry=self.domain.registry),
                        )
                    except Exception:  # noqa: BLE001 — best-effort goodbye
                        pass
                handle.reap(min(timeout, 5.0))
                with self._lock:
                    self._workers.pop(node, None)
                    self._dead.discard(node)
                self.host.endpoint.detach_peer(node)
                for peer in self.live_nodes():
                    try:
                        self.domain.sync(
                            peer,
                            f2f("_cluster/detach_peer", node,
                                registry=self.domain.registry),
                            5.0,
                        )
                    except Exception:  # noqa: BLE001 — advisory: a peer that
                        # never talked to the node has nothing to detach
                        pass
                self.fabric.remove_node(node)
                self.domain._inproc.pop(node, None)
            finally:
                with self._lock:
                    self._removing.discard(node)

    def restart(self, node: int) -> None:
        """Replace a dead worker in place under the same node id.

        Order matters: reap the corpse, purge fabric state addressed to it
        (queued frames belong to already-failed calls), drop the host's
        cached transport toward it, then attach the replacement and announce.
        Serialised with add/remove under ``_resize_lock``: a respawn reads
        the fabric's member set, which a concurrent resize is mutating.
        """
        with self._resize_lock:
            self._restart_locked(node)

    def _restart_locked(self, node: int) -> None:
        with self._lock:
            handle = self._workers[node]
        handle.reap(1.0)
        self.fabric.prepare_restart(node)
        self.host.endpoint.reset_peer(node)
        # surviving workers may cache worker->worker transport toward the
        # corpse (relay paths); tell them to forget it too
        for peer in self.live_nodes():
            if peer != node:
                try:
                    self.domain.oneway(
                        peer,
                        f2f("_cluster/reset_peer", node,
                            registry=self.domain.registry),
                    )
                except Exception:  # noqa: BLE001 — advisory; a peer that
                    # never cached a connection has nothing to reset
                    pass
        replacement = handle.respawn()
        with self._lock:
            self._workers[node] = replacement
            self._dead.discard(node)
        for cb in self._restart_cbs:
            try:
                cb(node)
            except Exception:  # noqa: BLE001
                import traceback

                traceback.print_exc()

    # -- teardown ----------------------------------------------------------

    def close(self, timeout: float = 5.0) -> None:
        """Stop monitoring, terminate + reap every worker, tear down the
        domain/fabric (unlinking shm segments).  Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._monitor.join(timeout=2.0)
        for node in self.live_nodes():
            try:
                self.domain.oneway(
                    node, f2f("_ham/terminate", registry=self.domain.registry)
                )
            except Exception:  # noqa: BLE001 — best-effort on teardown
                pass
        for handle in self._workers.values():
            try:
                handle.reap(timeout)
            except Exception:  # noqa: BLE001
                pass
        self.domain.shutdown(timeout)

    def __enter__(self) -> "ClusterPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
