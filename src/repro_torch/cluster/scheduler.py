"""Policy-driven scheduler with credit-based flow control over a ClusterPool.

The paper's ``offload::async`` takes an explicit target node; this layer
picks the node, keeps many calls in flight per worker, and survives worker
death — the futurized, load-balanced dispatch direction of HPX ("Closing the
Performance Gap with Modern C++") and the data-centric routing of Active
Access (Besta et al.), built on HAM's unchanged message layer.

Scheduling policies
-------------------

``policy=`` selects how :meth:`Scheduler.submit` routes a call whose target
was not pinned with ``node=``:

* ``"round_robin"`` — cycle through live workers in node order.  Stateless
  and fair for uniform work; degrades when call costs vary (a slow call
  holds up its node while the cycle keeps loading it evenly).
* ``"least_outstanding"`` — pick the live worker with the lowest *load
  estimate*: host-side in-flight calls **plus** the worker's last reported
  executor queue depth (``_cluster/stats`` oneways — see
  ``NodeRuntime.enable_depth_report``).  Ties break toward the lowest node
  id.  The default: it is adaptive join-shortest-queue, and the depth term
  also covers load the host did not submit (worker-to-worker traffic,
  another scheduler sharing the pool).
* ``"locality"`` — scan the call's arguments for migratable values with a
  registered locality hook (``buffer_ptr`` reports its owning node; see
  ``migratable.register_migratable(locality=...)``) and prefer the live
  node owning the most referenced buffer *bytes* (votes are weighted by
  ``nbytes``: one node holding a 100 MB buffer outweighs one holding three
  8-byte scalars — moving the call is cheap, moving the data is not);
  calls with no locality votes (or whose owner is dead) fall back to
  least-outstanding.  This routes compute to data instead of data to
  compute.  With a pool :class:`BufferDirectory` attached, a replicated
  buffer votes for EVERY live holder — any copy can serve a read, so
  locality routing survives the primary's death — but only for handlers
  registered ``read_only=True``; a call without the declaration votes for
  (and is pinned to) the buffer's primary, because serving it from a
  replica could mutate that copy behind the write-through protocol's back
  (the read-only routing contract in ``repro_torch.offload.dataplane``).

Location-transparent pointers (the data-plane refactor)
-------------------------------------------------------

When the pool carries a ``BufferDirectory`` (it always does; see
``repro_torch.offload.dataplane``), every submit rewrites its ``BufferPtr``
arguments against the directory *before* the frame is packed: a pointer
carrying a stale ownership epoch (its buffer's primary moved — crash
promotion or drain migration) is transparently re-resolved to the current
primary, and — for handlers declared ``read_only`` — a pointer whose
chosen target holds a replica is retargeted at that copy.  Callers keep using pointers minted before a failover; they
never see a dangling-handle error for a buffer that still exists (a buffer
that is genuinely *lost* — died with no replica — raises a diagnosis at
submit).  The scheduler also subscribes to the directory's repin hooks:
when a dead worker's buffers promote onto a replica holder, the sessions
bound to them are re-pinned onto that node, so a session resumes WITH its
data rather than wherever the rendezvous hash points.

Sticky sessions
---------------

``submit(fn, session=key)`` routes through a :class:`SessionRouter`
(``Scheduler.sessions``): the first call of a session places it on a live
worker by rendezvous hash, subsequent calls stick to that worker, and the
session is re-placed only when its worker leaves the live set (see
``repro_torch.cluster.sessions`` for the invariants).  A session submit behaves
like a pinned submit for flow control — it waits on its worker's credit —
but re-routes instead of failing when the worker dies mid-wait.

Elastic resize
--------------

The scheduler subscribes to the pool's ``on_join``/``on_leave``:

* **join** (added or restarted worker): its credit pool, in-flight map and
  stats entries are created atomically under the scheduler lock, then the
  node enters the routing set;
* **leave** (``ClusterPool.remove_node``): the node leaves the routing set
  *immediately* (the fence — new submits can no longer pick it) and the
  pool receives a drain waiter; with ``drain=True`` the waiter blocks until
  the node's tracked in-flight futures resolve, then retires its
  credit/in-flight/depth state and evicts its sessions.  In-flight calls
  complete normally during a drain because the worker is only terminated
  after the waiter returns.

Small-call fusion
-----------------

``fuse_window=`` (seconds; default ``None`` = off) turns on submit-side
small-call fusion: sub-threshold static-spec calls (payload <=
``FUSE_THRESHOLD`` bytes) are parked per target and shipped as ONE
``FLAG_FUSED`` multi-call frame (see ``core/message.py``) when the batch
reaches ``fuse_max``, when a non-fusible call to the same target must not
overtake them, on an explicit :meth:`flush`, or at the latest after the
window elapses (a daemon flusher thread bounds the added latency).  Each
fused call keeps its own credit, in-flight entry and future — error/death
semantics are per call, identical to unfused submits; only the wire
framing and the worker's dispatch pass are shared.

**Adaptive window** (``fuse_adaptive=True``, the default): the batch also
closes the moment batching stops paying — when the target has nothing
else in flight (an *idle* worker gains nothing from a parked call; holding
it for the timer is pure added latency, so a lone call to an idle target
ships immediately and a burst fuses everything behind its first call), and
when the target's credit pool drains (every credit consumed: no future
submit can join the batch, so the timer buys nothing).  The drain edge is
watched from the completion path too: when a target's wire in-flight sinks
to its parked batch, the batch ships.  The fixed window remains only as
the backstop for the in-between regime.  ``fuse_adaptive=False`` restores
the pure timer (useful for measuring the window itself).

Credit-based flow control (the backpressure contract)
-----------------------------------------------------

Every worker has ``max_inflight`` *credits*.  ``submit`` consumes one
credit on its target before the frame is sent and the credit is returned
when the call's future completes (result, remote error, or node death) —
so per-node in-flight frames are bounded by construction:

* a slow worker saturates its credits and ``submit`` **blocks** the caller
  (bounded by ``submit_timeout``, then :class:`OffloadError`) instead of
  ballooning the transport queue / shm ring behind the worker;
* policy routing only considers nodes with a free credit when any exists,
  so one stuck worker does not stall traffic that other workers could
  absorb — blocking happens only when the whole pool is saturated (or the
  call is pinned);
* credits are per-scheduler state, not a wire protocol: the transport's own
  bounded rings remain the hard backstop underneath.

Failure semantics
-----------------

The pool's monitor announces a dead worker; the scheduler then (1) removes
the node from the routing set, (2) fails every tracked in-flight future on
that node with :class:`RemoteExecutionError` *through the host's future
table* — popping the table entry, so a straggler reply from a restarted
node id is dropped rather than resurrecting a failed future — and (3)
routes subsequent submits to the survivors.  On restart the node rejoins
with a fresh credit pool.

Deadlines, retries and exactly-once replay (docs/failure-model.md)
------------------------------------------------------------------

``deadline=`` (per attempt, seconds) arms a watchdog for every submit: a
call whose reply has not arrived when its attempt expires is either
**retransmitted** (up to ``retries=`` times, attempt timeouts growing by
``retry_backoff=`` per attempt and capped at ``retry_cap=`` seconds) or
**failed** with an :class:`OffloadError` diagnosis — never silently
stranded.  Both knobs have per-call overrides on :meth:`submit`.

A retransmission reuses the SAME ``msg_id`` toward the SAME worker and
carries ``FLAG_RETRYABLE`` (as did the first attempt), so the worker's
:class:`~repro_torch.offload.runtime.ReplayCache` can dedup: a duplicate of a
call still executing is dropped, a duplicate of a completed call gets the
cached reply resent — mutating handlers execute exactly once no matter how
many attempts the fabric forced.  Rerouting a retry to a *different*
worker would break that guarantee, so retries are target-sticky; a worker
death while attempts remain fails the call through the normal death path.
The watchdog also piggybacks cumulative ``_ham/replay_ack`` oneways (the
highest msg_id below every outstanding retryable call) so workers can
evict cached replies that can no longer be asked for.  Retryable calls
bypass small-call fusion — a fused segment cannot be retransmitted alone.

Fault-free cost: calls submitted without a deadline skip all of this
(no tracking entry, no flag bits, no watchdog thread until the first
deadlined submit).

Mutate-at-data (Active Access writes)
-------------------------------------

A handler registered ``mutates=True`` declares that it writes buffers
through ``deref`` in place — the Active Access write direction (Besta et
al.): ship the mutation to the data instead of round-tripping the bytes
through ``get``/modify/``put``.  The scheduler closes the coherence loop:

* **routing** — a mutating call is routed at the primary of the buffers it
  references (under EVERY policy, not just ``locality``), and its pointers
  stay pinned there, so the write lands on the authoritative copy;
* **commit** — when the call completes (success OR remote error — a
  handler may have partially mutated before raising), the scheduler calls
  ``pool.commit_mutation`` on the referenced handles from a dedicated
  commit thread: the buffer's *dirty epoch* advances and every replica
  holder is invalidated (dropped for lazy re-backfill, or refreshed down
  the replication chain when the pool was built ``mutation_refresh=True``).
  The future :meth:`submit` returns resolves only after the commit, so
  ``fut.get()`` == "replicas can no longer serve the overwritten bytes"
  (docs/failure-model.md, "Write visibility and convergence").  The commit
  runs on its own thread because completion callbacks fire on the event
  loop — a synchronous invalidation send from there would deadlock.
* **oneways are uncommitted** — :meth:`oneway` has no completion edge, so
  a mutating oneway updates the primary without invalidating replicas;
  use ``submit`` for mutations that must converge.

A handler declared neither ``read_only`` nor ``mutates`` that dereferences
a *replicated* buffer gets a one-shot warning naming the missing
declaration (hamlint HAM001 finds the same statically) — its replicas are
not invalidated and a replica-served read may observe stale bytes.
"""

from __future__ import annotations

import logging
import queue as _queue
import threading
from typing import Iterable

from repro_torch.core import migratable as mig
from repro_torch.core.closure import Function, f2f
from repro_torch.core.errors import NodeDownError, OffloadError
from repro_torch.core.future import Future, as_completed, gather
from repro_torch.core.message import FLAG_RETRYABLE
from repro_torch.cluster.pool import ClusterPool
from repro_torch.cluster.sessions import SessionRouter
from repro_torch.offload.runtime import FUSE_THRESHOLD

__all__ = ["Scheduler", "as_completed", "gather"]

POLICIES = ("round_robin", "least_outstanding", "locality")

_log = logging.getLogger("repro_torch.cluster.scheduler")


class Scheduler:
    """Routes ``submit`` calls across a :class:`ClusterPool` (module docs
    define the policy and flow-control contracts)."""

    def __init__(
        self,
        pool: ClusterPool,
        *,
        policy: str = "least_outstanding",
        max_inflight: int = 32,
        submit_timeout: float | None = 30.0,
        fuse_window: float | None = None,
        fuse_max: int = 16,
        fuse_adaptive: bool = True,
        deadline: float | None = None,
        retries: int = 0,
        retry_backoff: float = 2.0,
        retry_cap: float = 8.0,
    ):
        if policy not in POLICIES:
            raise OffloadError(f"unknown policy {policy!r}; one of {POLICIES}")
        self.pool = pool
        self.host = pool.host
        self.policy = policy
        self.max_inflight = int(max_inflight)
        self.submit_timeout = submit_timeout
        # -- deadline / retry defaults (module docs) -----------------------
        self.deadline = deadline
        self.retries = int(retries)
        self.retry_backoff = float(retry_backoff)
        self.retry_cap = float(retry_cap)
        #: msg_id -> [node, function, expires, attempts_left, timeout, retryable]
        self._tracked: dict[int, list] = {}
        #: per-node replay-ack state: [last_acked_upto, last_sent_monotonic]
        self._ack_state: dict[int, list] = {}
        #: per-node highest COMPLETED retryable msg_id (ack high-water mark)
        self._retry_hwm: dict[int, int] = {}
        self._watchdog: threading.Thread | None = None
        self._watchdog_stop = threading.Event()
        self._lock = threading.Lock()
        #: the pool's location-transparent buffer namespace (module docs);
        #: None only for pool-likes that predate the directory
        self._directory = getattr(pool, "directory", None)
        # -- small-call fusion state (module docs: Small-call fusion) ------
        self.fuse_window = fuse_window
        self.fuse_max = int(fuse_max)
        self.fuse_adaptive = bool(fuse_adaptive)
        self._fuse_pending: dict[int, list[tuple[Function, int]]] = {}
        # per-target send serialisation: every pop-and-send (and every
        # non-fusible send that must not overtake a parked batch) runs
        # under the target's send lock, so concurrent submitters and the
        # flusher thread cannot reorder frames toward one worker.  Lock
        # order: send lock, THEN self._lock — never the reverse.  Reentrant:
        # the adaptive close may flush from a completion callback that runs
        # inside a failed flush's rejection cascade (same thread).
        self._send_locks: dict[int, threading.RLock] = {}
        self._fuse_stop = threading.Event()
        self._fuse_thread: threading.Thread | None = None
        if fuse_window is not None:
            self._fuse_thread = threading.Thread(
                target=self._fuse_flusher, name="ham-sched-fuse", daemon=True
            )
            self._fuse_thread.start()
        self._live: set[int] = set(pool.worker_nodes)
        self._inflight: dict[int, dict[int, Future]] = {
            n: {} for n in pool.worker_nodes
        }
        self._credits: dict[int, threading.Semaphore] = {
            n: threading.Semaphore(self.max_inflight) for n in pool.worker_nodes
        }
        self._rr = 0
        self.stats = {
            "submitted": 0,
            "completed": 0,
            "failed_inflight": 0,
            "locality_hits": 0,
            "session_routed": 0,
            "fused_calls": 0,
            "retries": 0,
            "deadline_failed": 0,
            "replay_acks": 0,
            "oneways": 0,
            "mutations_committed": 0,
            "routed": {n: 0 for n in pool.worker_nodes},
        }
        # -- mutate-at-data state (module docs) ----------------------------
        #: handlers already warned for undeclared replicated-buffer access
        self._warned: set[str] = set()
        #: lazily-started commit pipeline: completion callbacks run on the
        #: event-loop thread, where a synchronous invalidation send would
        #: deadlock — commits hop to this daemon thread instead
        self._commit_q: _queue.SimpleQueue | None = None
        self._commit_thread: threading.Thread | None = None
        #: sticky-session affinity over this scheduler's live set
        self.sessions = SessionRouter(self.live_nodes)
        if self._directory is not None:
            # crash failover / drain migration re-pin: a session whose
            # buffers moved follows its data (fires from the directory's
            # promotion, which the pool runs BEFORE our death callback)
            self._directory.on_repin(self.sessions.repin)
        pool.on_death(self._on_worker_death)
        pool.on_restart(self._on_worker_join)
        pool.on_join(self._on_worker_join)
        pool.on_leave(self._on_worker_leave)
        # reconcile deaths announced BEFORE we subscribed (e.g. a worker
        # that crashed during pool startup): _on_worker_death is idempotent,
        # so racing a concurrent announcement is harmless
        for n in pool.worker_nodes:
            if not pool.is_alive(n):
                self._on_worker_death(n)

    # -- routing -----------------------------------------------------------

    def _load(self, node: int) -> int:
        """Load estimate: host-side in-flight plus the worker's last
        reported queue depth (0 until a report arrives).  The two overlap —
        a call the host counts may also sit in the worker's queue — but the
        estimate is monotone in both, which is all ranking needs."""
        return len(self._inflight[node]) + self.host.peer_depth.get(node, 0)

    def _pick(self, function: Function) -> int | None:
        """Choose a live target under the active policy (caller holds no
        lock; this takes it).  Returns None when no workers are live."""
        with self._lock:
            live = sorted(self._live)
            if not live:
                return None
            d = self._directory
            if d is not None and len(d) \
                    and getattr(function.record, "mutates", False):
                # mutate-at-data routing (module docs): a declared-mutating
                # call executes WHERE its buffers live, under every policy —
                # the primary holds the authoritative copy the write must
                # land on.  nbytes-weighted like locality voting.
                votes = mig.scan_locality(
                    function.args, resolver=d.primary_resolver
                )
                alive_votes = {
                    n: c for n, c in votes.items() if n in self._live
                }
                if alive_votes:
                    self.stats["locality_hits"] += 1
                    return max(
                        alive_votes,
                        key=lambda n: (alive_votes[n], -self._load(n)),
                    )
            # prefer nodes with a free credit so one saturated worker does
            # not block traffic the others could take (flow-control contract)
            uncongested = [
                n for n in live
                if len(self._inflight[n]) < self.max_inflight
            ]
            candidates = uncongested or live
            if self.policy == "locality":
                # votes are nbytes-weighted: route to where the bulk of the
                # referenced data lives, not to whoever owns the most ptrs.
                # Directory-tracked buffers vote for EVERY live holder only
                # when the handler is declared read_only (any copy can serve
                # a read); an undeclared call votes for — and will have its
                # pointers pinned to — the primary, so a buffer-mutating
                # handler can never be routed at a replica and diverge it
                d = self._directory
                resolver = None
                if d is not None and len(d):
                    resolver = (
                        d.locality_resolver if function.record.read_only
                        else d.primary_resolver
                    )
                votes = mig.scan_locality(function.args, resolver=resolver)
                alive_votes = {n: c for n, c in votes.items() if n in self._live}
                if alive_votes:
                    self.stats["locality_hits"] += 1
                    # most bytes win; break ties toward the shorter queue
                    return max(
                        alive_votes,
                        key=lambda n: (alive_votes[n], -self._load(n)),
                    )
            if self.policy == "round_robin":
                self._rr += 1
                return candidates[self._rr % len(candidates)]
            return min(candidates, key=lambda n: (self._load(n), n))

    def submit(self, function: Function, *, node: int | None = None,
               session=None, deadline: float | None = None,
               retries: int | None = None) -> Future:
        """Route ``function`` to a worker and return its future.

        ``node=`` pins the target (raises :class:`NodeDownError` if it is
        dead — pinned calls are not rerouted; reroute-on-death applies to
        policy-routed traffic).  ``session=`` routes through the sticky
        :class:`SessionRouter` instead of the policy: same worker for the
        session's lifetime, re-placed only if that worker leaves the live
        set.  Blocks for a credit when the target is saturated;
        :class:`OffloadError` after ``submit_timeout``.

        ``deadline=`` / ``retries=`` override the scheduler-wide defaults
        for this call (module docs: Deadlines, retries and exactly-once
        replay).  A deadlined call whose reply never arrives is
        retransmitted up to ``retries`` times (same msg_id, same worker,
        ``FLAG_RETRYABLE`` — the worker's replay cache keeps mutating
        handlers exactly-once), then failed with an OffloadError diagnosis
        instead of stranding its future.

        A *pinned* submit waits on its node's credit for the whole timeout
        (that node is the request).  A *policy-routed* submit must not get
        stuck behind one slow worker while another frees up, so it waits in
        short slices and re-picks between them — it blocks for the full
        timeout only when the entire pool stays saturated.  A *session*
        submit waits like a pinned one (its worker is the session), but a
        death during the wait re-places the session rather than failing.
        """
        import time

        if node is not None and session is not None:
            raise OffloadError("submit takes node= or session=, not both")
        # mutate-at-data bookkeeping (module docs): collect the directory
        # handles a declared-mutating call references — its future commits
        # their dirty epochs on completion — and warn ONCE per handler for
        # undeclared replicated-buffer access.  Cost when the directory is
        # empty or the handler is declared read_only: one attribute check.
        mutate_handles: tuple[int, ...] = ()
        d = self._directory
        if d is not None and not d.empty() and not function.record.read_only:
            if getattr(function.record, "mutates", False):
                mutate_handles = self._tracked_handles(function.args)
            else:
                self._warn_undeclared(function)
        call_deadline = self.deadline if deadline is None else deadline
        call_retries = self.retries if retries is None else int(retries)
        # the flag rides EVERY attempt including the first: the worker must
        # enter the call into its replay cache before any duplicate can land
        extra_flags = (
            FLAG_RETRYABLE
            if call_deadline is not None and call_retries > 0 else 0
        )
        bp_deadline = (
            None if self.submit_timeout is None
            else time.monotonic() + self.submit_timeout
        )
        while True:
            if node is not None:
                if not self._is_live(node):
                    raise NodeDownError(f"worker {node} is down")
                target = node
            elif session is not None:
                # data-affine first placement: a session with buffers bound
                # in the directory starts life on the node holding its
                # bytes (later failover repins keep it there); sessions
                # without bound buffers place by plain rendezvous hash
                eligible = None
                if self._directory is not None and len(self._directory) \
                        and self.sessions.lookup(session) is None:
                    home = self._directory.session_home(session)
                    if home is not None and self._is_live(home):
                        eligible = (home,)
                target = self.sessions.route(session, eligible=eligible)
                if target is None:
                    raise OffloadError("no live workers in the pool")
            else:
                target = self._pick(function)
                if target is None:
                    raise OffloadError("no live workers in the pool")
            # location transparency (module docs): rewrite stale-epoch
            # BufferPtr hints against the directory and retarget pointers
            # at the chosen node when it holds a copy — BEFORE a credit is
            # spent, so a genuinely lost buffer raises cleanly here
            function = self._resolve_for(function, target)
            sem = self._credits.get(target)
            if sem is None:
                continue  # node retired between route and credit lookup
            remaining = (
                None if bp_deadline is None
                else max(0.0, bp_deadline - time.monotonic())
            )
            if node is None:
                # policy AND session submits wait in slices: a session stays
                # on its pinned worker while it lives (route keeps returning
                # the pin), but a death mid-wait is noticed within a slice
                # and re-placed instead of burning the whole timeout
                slice_s = 0.05 if remaining is None else min(0.05, remaining)
                acquired = sem.acquire(timeout=slice_s)
            elif remaining is not None:
                acquired = sem.acquire(timeout=remaining)
            else:
                acquired = sem.acquire()
            if not acquired:
                if bp_deadline is None or time.monotonic() < bp_deadline:
                    continue  # slice expired: re-pick with fresh queue state
                raise OffloadError(
                    f"backpressure timeout: worker {target} held "
                    f"{self.max_inflight} in-flight calls for "
                    f"{self.submit_timeout}s"
                )
            # reserve the in-flight slot ATOMICALLY with the liveness check:
            # a fence (remove_node) or death between "target is live" and
            # the insert would otherwise miss this call — the drain waiter
            # would not wait for it, or a drained removal would spuriously
            # fail a call its still-alive worker was about to serve
            msg_id, fut = self.host.futures.create()
            with self._lock:
                live_now = target in self._live and target in self._inflight
                if live_now:
                    self._inflight[target][msg_id] = fut
                    self.stats["submitted"] += 1
                    if session is not None:
                        self.stats["session_routed"] += 1
                    self.stats["routed"][target] = (
                        self.stats["routed"].get(target, 0) + 1
                    )
            if live_now:
                break
            # target fenced/died between pick and credit grant: put the
            # credit back, drop the unused future, and re-route (or fail a
            # pinned call; a session submit re-places on the next iteration)
            self.host.futures.discard(msg_id)
            sem.release()
            if node is not None:
                raise NodeDownError(f"worker {node} is down")
        if call_deadline is not None:
            # armed BEFORE the send so a reply can never race an untracked
            # call; a reply that beats the insert is reconciled by _on_done's
            # pop (and the watchdog's discard() losing to the resolve)
            self._track(msg_id, target, function, call_deadline,
                        call_retries, bool(extra_flags))
        if self.fuse_window is not None and not extra_flags \
                and self._fusible(function):
            # park for fusion: the credit/in-flight reservation above holds,
            # the done-callback is registered NOW (a death or a failed fused
            # send rejects the future, which releases the credit), and the
            # flusher/batch-full/ordering/adaptive triggers ship the frame
            fut.add_done_callback(lambda f, n=target: self._on_done(n, f))
            with self._lock:
                pend = self._fuse_pending.setdefault(target, [])
                pend.append((function, msg_id))
                self.stats["fused_calls"] += 1
                full = len(pend) >= self.fuse_max
                # adaptive close (module docs): ship NOW when the target has
                # nothing in flight beyond this parked batch (an idle worker
                # gains nothing from waiting) or when its credit pool just
                # drained (no future submit can join the batch)
                inflight = len(self._inflight.get(target, ()))
                adaptive = self.fuse_adaptive and (
                    inflight <= len(pend) or inflight >= self.max_inflight
                )
            if full or adaptive:
                self._flush_target(target)
            if mutate_handles:
                return self._wrap_mutating(fut, mutate_handles)
            return fut
        if self.fuse_window is not None:
            # a non-fusible frame must not overtake parked calls to the
            # same target: drain them and send THIS frame under the same
            # send lock, so per-target submission order is preserved even
            # against the flusher thread and concurrent submitters
            with self._send_lock(target):
                self._pop_and_send(target)
                self._send_single(target, function, msg_id, sem, extra_flags)
        else:
            self._send_single(target, function, msg_id, sem, extra_flags)
        # registered after the send: if a death handler already rejected
        # the future, the callback runs immediately and returns the credit
        fut.add_done_callback(lambda f, n=target: self._on_done(n, f))
        if mutate_handles:
            return self._wrap_mutating(fut, mutate_handles)
        return fut

    def _resolve_for(self, function: Function, target: int) -> Function:
        """Directory pass over a call's arguments: stale-epoch pointers are
        rewritten to the current primary, and — for handlers declared
        ``read_only`` — pointers whose buffer has a copy ON ``target`` are
        retargeted there (the receiving node's own-address-space deref
        check must see itself).  A call NOT declared read-only keeps its
        pointers pinned to the primary even when ``target`` holds a
        replica: a handler that writes through ``deref`` must never update
        a replica copy behind the write-through protocol's back (dataplane
        module docs) — routed at a non-holder it fails the deref check
        loudly instead of diverging silently.  A no-op without a directory
        or when nothing is tracked."""
        d = self._directory
        if d is None or d.empty():
            return function
        new_args, changed = d.resolve_args(
            function.args, target if function.record.read_only else None
        )
        if not changed:
            return function
        return Function(function.record, new_args)

    # -- mutate-at-data plumbing (module docs) ------------------------------

    def _tracked_handles(self, args) -> tuple[int, ...]:
        """Directory-tracked buffer handles referenced by ``args`` (the
        handles a mutating call's commit must invalidate) — the shared
        dataplane walk, same depth bound as ``resolve_args``."""
        from repro_torch.offload.dataplane import tracked_handles

        return tracked_handles(self._directory, args)

    def _warn_undeclared(self, function: Function) -> None:
        """One-shot warning (module docs): a handler declared neither
        ``read_only`` nor ``mutates`` is touching a *replicated* buffer —
        if it writes through deref, replicas are never invalidated and a
        replica-served read may observe stale bytes.  Cost after the first
        warning: one set lookup."""
        name = function.record.stable_name
        if name in self._warned:
            return
        d = self._directory
        for h in self._tracked_handles(function.args):
            rec = d.lookup(h)
            if rec is not None and rec.replicas:
                self._warned.add(name)
                _log.warning(
                    "handler %r dereferences replicated buffer %#x but "
                    "declares neither read_only=True nor mutates=True: an "
                    "in-place write would NOT invalidate the buffer's "
                    "replicas, and a replica-served read could observe "
                    "stale bytes.  Declare the handler's intent (see "
                    "docs/failure-model.md, 'Write visibility and "
                    "convergence'; hamlint HAM001 finds this statically).",
                    name, h,
                )
                return

    def _wrap_mutating(self, fut: Future, handles: tuple[int, ...]) -> Future:
        """Outer future for a declared-mutating call: resolves with the
        inner call's result/error only AFTER ``pool.commit_mutation`` ran
        for ``handles`` on the commit thread (module docs — the commit runs
        on success AND error, because a handler may mutate before raising).
        """
        outer = Future()
        outer.msg_id = fut.msg_id
        fut.add_done_callback(
            lambda f: self._commit_enqueue(f, outer, handles)
        )
        return outer

    def _commit_enqueue(self, inner: Future, outer: Future,
                        handles: tuple[int, ...]) -> None:
        with self._lock:
            if self._commit_q is None:
                self._commit_q = _queue.SimpleQueue()
                self._commit_thread = threading.Thread(
                    target=self._commit_loop, name="ham-sched-commit",
                    daemon=True,
                )
                self._commit_thread.start()
            q = self._commit_q
        q.put((inner, outer, handles))

    def _commit_loop(self) -> None:
        while True:
            inner, outer, handles = self._commit_q.get()
            commit_error: BaseException | None = None
            try:
                commit = getattr(self.pool, "commit_mutation", None)
                if commit is not None and handles:
                    commit(handles)
                    with self._lock:
                        self.stats["mutations_committed"] += 1
            except BaseException as e:  # noqa: BLE001 — surfaces on outer
                commit_error = e
            exc = inner.exception()
            if exc is not None:
                # the call's own failure outranks a commit failure (the
                # commit still ran first — replicas are not left serving
                # a partial write)
                outer.set_exception(exc)
            elif commit_error is not None:
                outer.set_exception(OffloadError(
                    f"mutation committed on the primary but replica "
                    f"invalidation failed for handles "
                    f"{[hex(h) for h in handles]}: "
                    f"{type(commit_error).__name__}: {commit_error} — "
                    f"replicas may serve stale bytes until the next "
                    f"backfill (docs/failure-model.md, 'Write visibility "
                    f"and convergence')"
                ))
            else:
                outer.set_result(inner.get(0))

    def oneway(self, function: Function, *, node: int | None = None,
               session=None) -> None:
        """Fire-and-forget control send: no future, no credit, no reply —
        the cluster-level twin of ``NodeRuntime.send_oneway`` with this
        scheduler's routing applied.  ``session=`` follows the sticky pin
        (a cancel must land on the worker decoding the session), ``node=``
        pins, otherwise the policy picks.  Raises :class:`NodeDownError` /
        :class:`OffloadError` when no target is live; delivery past the
        send is best-effort (docs/failure-model.md: oneways are
        at-most-once)."""
        if node is not None and session is not None:
            raise OffloadError("oneway takes node= or session=, not both")
        if node is not None:
            if not self._is_live(node):
                raise NodeDownError(f"worker {node} is down")
            target = node
        elif session is not None:
            target = self.sessions.route(session)
            if target is None:
                raise OffloadError("no live workers in the pool")
        else:
            target = self._pick(function)
            if target is None:
                raise OffloadError("no live workers in the pool")
        function = self._resolve_for(function, target)
        domain = getattr(self.pool, "domain", None)
        if domain is None:
            raise OffloadError("pool exposes no oneway transport")
        if self.fuse_window is not None:
            # must not overtake calls parked for fusion toward this target
            with self._send_lock(target):
                self._pop_and_send(target)
                domain.oneway(target, function)
        else:
            domain.oneway(target, function)
        with self._lock:
            self.stats["oneways"] += 1

    def end_session(self, key) -> None:
        """End a sticky session: drop its routing pin AND free the buffers
        bound to it cluster-wide (replicas invalidated, ``live_count``
        truthful — the dataplane hygiene contract)."""
        self.sessions.end_session(key)
        release = getattr(self.pool, "release_session", None)
        if release is not None:
            release(key)

    def _send_single(self, target: int, function: Function, msg_id: int,
                     sem, extra_flags: int = 0) -> None:
        try:
            self.host._send_request(target, function, msg_id, extra_flags)
        except Exception:
            # the frame never left: withdraw the reservation.  If a death
            # handler raced us it already rejected the future (discard is
            # then a no-op) — either way no reply can arrive for the id.
            with self._lock:
                d = self._inflight.get(target)
                if d is not None:
                    d.pop(msg_id, None)
                self._tracked.pop(msg_id, None)
            self.host.futures.discard(msg_id)
            sem.release()
            raise

    # -- deadlines / retries (module docs) ----------------------------------

    def _track(self, msg_id: int, node: int, function: Function,
               timeout: float, retries: int, retryable: bool) -> None:
        """Arm the watchdog for one call.  Entry layout:
        ``[node, function, expires, attempts_left, attempt_timeout,
        retryable]`` — mutated in place by the watchdog on retransmit."""
        import time

        entry = [node, function, time.monotonic() + float(timeout),
                 int(retries), float(timeout), retryable]
        with self._lock:
            self._tracked[msg_id] = entry
            if self._watchdog is None:
                self._watchdog = threading.Thread(
                    target=self._watchdog_loop, name="ham-sched-watchdog",
                    daemon=True,
                )
                self._watchdog.start()

    def _watchdog_loop(self) -> None:
        import time

        while not self._watchdog_stop.wait(0.02):
            now = time.monotonic()
            with self._lock:
                expired = [
                    (msg_id, e) for msg_id, e in self._tracked.items()
                    if e[2] <= now
                ]
            for msg_id, e in expired:
                node = e[0]
                if e[5] and e[3] > 0 and self._is_live(node):
                    with self._lock:
                        if self._tracked.get(msg_id) is not e:
                            continue  # completed while we scanned
                        e[3] -= 1
                        # capped exponential backoff on the attempt timeout
                        e[4] = min(e[4] * self.retry_backoff, self.retry_cap)
                        e[2] = time.monotonic() + e[4]
                    try:
                        # same msg_id, same worker, FLAG_RETRYABLE: the
                        # replay cache makes this exactly-once (module docs)
                        self.host._send_request(node, e[1], msg_id,
                                                FLAG_RETRYABLE)
                        self.stats["retries"] += 1
                    except Exception:  # noqa: BLE001 — transport refused the
                        # retransmit (peer fenced/partitioned): fail now, the
                        # remaining attempts could not leave either
                        self._fail_tracked(msg_id, e, "retransmit failed")
                else:
                    self._fail_tracked(msg_id, e, "deadline exhausted")
            self._send_replay_acks(now)

    def _fail_tracked(self, msg_id: int, entry: list, why: str) -> None:
        node, function = entry[0], entry[1]
        with self._lock:
            if self._tracked.get(msg_id) is not entry:
                return
            del self._tracked[msg_id]
            fut = self._inflight.get(node, {}).get(msg_id)
        # discard() pops the table entry: winning this race means no reply
        # can resolve the future behind us AND a straggler reply is dropped
        if fut is not None and self.host.futures.discard(msg_id):
            self.stats["deadline_failed"] += 1
            fut.set_exception(OffloadError(
                f"call {function.record.stable_name!r} to worker {node} "
                f"{why}: no reply within {entry[4]:.3g}s (attempts "
                f"exhausted).  The worker may be overloaded, partitioned, "
                f"or its reply was lost — delivery guarantees per path are "
                f"in docs/failure-model.md"
            ))

    def _send_replay_acks(self, now: float) -> None:
        """Piggybacked cumulative acks: tell each worker the highest msg_id
        below every outstanding retryable call — its replay cache can evict
        everything at or below.  Best-effort oneways, at most ~1/s/worker
        (the cache's FIFO cap bounds memory even if these never arrive)."""
        domain = getattr(self.pool, "domain", None)
        if domain is None:
            return
        pending = []
        with self._lock:
            floor: dict[int, int] = {}
            for msg_id, e in self._tracked.items():
                if e[5] and (e[0] not in floor or msg_id < floor[e[0]]):
                    floor[e[0]] = msg_id
            for node, hwm in self._retry_hwm.items():
                upto = hwm if node not in floor else min(floor[node] - 1, hwm)
                st = self._ack_state.setdefault(node, [0, 0.0])
                if upto > st[0] and now - st[1] >= 1.0 and node in self._live:
                    st[0], st[1] = upto, now
                    pending.append((node, upto))
        for node, upto in pending:
            try:
                domain.oneway(node, f2f(
                    "_ham/replay_ack", self.host.node_id, upto,
                    registry=domain.registry,
                ))
                self.stats["replay_acks"] += 1
            except Exception:  # noqa: BLE001 — ack loss only delays eviction
                pass

    # -- small-call fusion (module docs) -----------------------------------

    def _fusible(self, function: Function) -> bool:
        try:
            key = self.host.table.key_of(function.record.stable_name)
        except Exception:  # noqa: BLE001 — let _send_request raise properly
            return False
        plan = self.host._arg_plans[key]
        if plan is not None:
            return plan.nbytes <= FUSE_THRESHOLD
        # dynamic handler: a shape-cacheable call packs through a cached
        # WirePlan (FLAG_SHAPED segment) with known size — fuse it under the
        # same threshold; non-speccable shapes stay unfused (size unknown
        # without a TLV measuring walk, which defeats the point)
        cache = self.host._shape_cache
        if cache is None:
            return False
        shaped = cache.for_values(function.args, "A")
        return (shaped is not None
                and shaped[1].nbytes + len(shaped[0]) <= FUSE_THRESHOLD)

    def _send_lock(self, target: int) -> threading.RLock:
        with self._lock:
            lock = self._send_locks.get(target)
            if lock is None:
                lock = self._send_locks[target] = threading.RLock()
            return lock

    def _send_fused(self, target: int, entries: list) -> None:
        """Ship one parked batch; a failed send fails exactly its calls."""
        try:
            self.host._send_fused_request(target, entries)
        except Exception as e:  # noqa: BLE001 — reject -> done-callback
            # returns each credit and pops each in-flight entry
            for _, msg_id in entries:
                self.host.futures.reject(
                    msg_id, f"fused send to worker {target} failed: "
                    f"{type(e).__name__}: {e}", ""
                )

    def _pop_and_send(self, target: int) -> None:
        """Pop and ship a parked batch; caller holds the target's send lock
        (pop and send must be atomic per target, or two flushers could
        reorder batches between the pop and the wire)."""
        with self._lock:
            entries = self._fuse_pending.pop(target, None)
        if entries:
            self._send_fused(target, entries)

    def _flush_target(self, target: int) -> None:
        with self._send_lock(target):
            self._pop_and_send(target)

    def flush(self) -> None:
        """Ship every parked fused batch now (also runs on the window)."""
        with self._lock:
            targets = list(self._fuse_pending)
        for target in targets:
            self._flush_target(target)

    def _fuse_flusher(self) -> None:
        while not self._fuse_stop.wait(self.fuse_window):
            self.flush()

    def close(self) -> None:
        """Stop the fusion flusher and deadline watchdog, and ship any
        parked calls.  Idempotent; only needed when the scheduler was built
        with ``fuse_window=`` or has submitted deadlined calls."""
        self._fuse_stop.set()
        if self._fuse_thread is not None:
            self._fuse_thread.join(timeout=2.0)
            self._fuse_thread = None
        self._watchdog_stop.set()
        if self._watchdog is not None:
            self._watchdog.join(timeout=2.0)
            self._watchdog = None
        self.flush()

    def map(self, functions: Iterable[Function]) -> list[Future]:
        """Submit a batch; completions pipeline (harvest via as_completed)."""
        return [self.submit(fn) for fn in functions]

    def drain(self, timeout: float | None = 60.0) -> None:
        """Block until every tracked in-flight call completes."""
        with self._lock:
            futs = [f for d in self._inflight.values() for f in d.values()]
        for _ in as_completed(futs, timeout):
            pass

    # -- introspection -----------------------------------------------------

    def _is_live(self, node: int) -> bool:
        with self._lock:
            return node in self._live

    def live_nodes(self) -> list[int]:
        with self._lock:
            return sorted(self._live)

    def outstanding(self, node: int | None = None) -> int:
        with self._lock:
            if node is not None:
                return len(self._inflight.get(node, ()))
            return sum(len(d) for d in self._inflight.values())

    # -- completion / failure plumbing ------------------------------------

    def _on_done(self, node: int, fut: Future) -> None:
        with self._lock:
            d = self._inflight.get(node)
            if d is not None:
                d.pop(fut.msg_id, None)
            entry = self._tracked.pop(fut.msg_id, None)
            if entry is not None and entry[5] \
                    and fut.msg_id > self._retry_hwm.get(node, 0):
                # completed retryable call: raise the replay-ack HWM so the
                # worker's cached reply for it becomes evictable
                self._retry_hwm[node] = fut.msg_id
            sem = self._credits.get(node)
            self.stats["completed"] += 1
        if sem is not None:
            sem.release()
        if self.fuse_window is not None and self.fuse_adaptive:
            # adaptive close, completion edge: the target's wire in-flight
            # just sank to (at most) its parked batch — the worker is about
            # to go idle, so holding the batch for the timer is pure latency
            with self._lock:
                pend = self._fuse_pending.get(node)
                drained = bool(pend) and \
                    len(self._inflight.get(node, ())) <= len(pend)
            if drained:
                self._flush_target(node)

    def _on_worker_death(self, node: int) -> None:
        """Pool monitor callback: fail this node's in-flight calls and stop
        routing to it (failure-semantics contract in the module docs).
        Sessions pinned to the node re-place lazily on their next submit."""
        with self._lock:
            self._live.discard(node)
            stale = self._inflight.get(node, {})
            if node in self._inflight:
                self._inflight[node] = {}
            self.stats["failed_inflight"] += len(stale)
            self.host.peer_depth.pop(node, None)  # stale busy signal
        for msg_id in list(stale):
            # reject -> RemoteExecutionError at every waiter, and the popped
            # table entry drops any straggler reply for this msg_id
            self.host.futures.reject(
                msg_id, f"worker {node} died with this call in flight", ""
            )

    def _on_worker_join(self, node: int) -> None:
        """Pool callback for an added *or restarted* worker: create (or
        reset) its routing state atomically, then admit it (resize contract
        in the module docs)."""
        with self._lock:
            self._inflight[node] = {}
            self._credits[node] = threading.Semaphore(self.max_inflight)
            self.stats["routed"].setdefault(node, 0)
            self.host.peer_depth.pop(node, None)
            self._live.add(node)

    def _on_worker_leave(self, node: int):
        """Pool callback at the start of ``remove_node``: fence the node
        (out of the routing set immediately) and hand back a drain waiter
        that retires its state once its in-flight futures resolve."""
        with self._lock:
            self._live.discard(node)

        def _drain_and_retire(timeout: float | None = 30.0) -> None:
            with self._lock:
                futs = list(self._inflight.get(node, {}).values())
            for _ in as_completed(futs, timeout):
                pass
            self._retire_node(node)

        return _drain_and_retire

    def _retire_node(self, node: int) -> None:
        """Atomically drop a removed node's credit/in-flight/depth state and
        evict its sessions (their next submit re-places them).  The id is
        never reused, so nothing can resurrect the entries."""
        with self._lock:
            self._live.discard(node)
            self._inflight.pop(node, None)
            self._credits.pop(node, None)
            self.host.peer_depth.pop(node, None)
        self.sessions.evict_node(node)
