"""Location-transparent buffer namespace: directory, epochs, replication.

HAM's address-translation layer made *handlers* location-transparent; this
module does the same for the *data plane*.  The design follows HPX's AGAS
(global ids decoupled from placement — Heller et al.) and Active Access
(Besta & Hoefler: the runtime, not the caller, resolves where data lives):

* A buffer's identity is its **global handle** (``BufferPtr.handle``,
  minted node-namespaced so it is unique cluster-wide and survives any
  move).  The pointer's ``node`` field is only a placement *hint*.
* The host-side :class:`BufferDirectory` is the source of truth: it maps
  ``handle -> (primary, replicas, epoch, shape/dtype, session)``.
* The **ownership epoch** makes hints safely cacheable: every primary move
  bumps the buffer's epoch, so a pointer carrying an older epoch is *stale*
  and is transparently rewritten by :meth:`BufferDirectory.resolve` /
  :meth:`resolve_args` — a current-epoch pointer skips the directory.

Ownership / epoch / replication protocol
----------------------------------------

``allocate`` (through :class:`~repro_torch.cluster.pool.ClusterPool`):
  the primary node mints the handle and zero-fills the array; each of the
  ``replicas=N`` holder nodes installs an empty copy under the SAME handle
  via ``_ham/buf_adopt``; the directory records the set at epoch 0.

``put`` (chain-replicated write-through):
  the host sends the payload ONCE — to the primary, over the existing
  zero-copy chunked path — and the primary streams it on to the replicas
  over worker->worker links (the chain-replication write protocol below),
  so copies never diverge and promotion needs no data movement, without
  the host paying one wire transfer per holder.

**Crash** (pool monitor announces a death):
  :meth:`BufferDirectory.on_node_death` runs *metadata-only* promotion —
  for every buffer whose primary died and that has a live replica, the
  lowest-id replica becomes primary and the epoch bumps; a buffer with no
  replica is recorded **lost** (later resolves raise, they do not hang).
  Sessions bound to moved buffers are re-pinned onto the node now holding
  their bytes (``on_repin`` hooks — the scheduler's SessionRouter
  subscribes), so a dead worker's sessions resume WITH their data.

**Drain shrink** (``ClusterPool.remove_node(drain=True)``):
  before the scheduler fence, every primary on the leaving node is migrated
  — promoted in place when a replica already holds the bytes (zero copy),
  else streamed to a survivor via adopt + chunked put — and every replica
  it held is backfilled elsewhere; each move bumps the epoch.  Shrink is
  lossless by construction.

**Join** (``ClusterPool.add_node``):
  lazy backfill — buffers left under-replicated by earlier deaths copy one
  replica onto the joiner.

**Free / session end**:
  freeing anywhere frees the logical buffer everywhere: the directory drops
  the record and every other holder gets ``_ham/buf_invalidate`` (idempotent
  discard), so ``live_count`` stays truthful cluster-wide and replicas do
  not leak when a session completes.  A worker-side ``_ham/free`` announces
  itself to the host with a ``_ham/buf_freed`` oneway for the same reason.

Stale-pointer re-resolution happens at the *submit boundary* (the
scheduler rewrites ``BufferPtr`` args against the directory and may
retarget them at any live holder it routes to), so handler code and the
per-node :class:`~repro_torch.offload.buffer.BufferRegistry` keep the paper's
strict own-address-space dereference rule.

Directory gossip / durable directory (host crash recovery)
----------------------------------------------------------

The directory is host-side state — and PR 5 made every *worker* crash
recoverable, which left the host as the last unprotected failure domain: a
host crash used to take the placement map (and with it every tracked
buffer) down even though the bytes were still sitting in worker memory.
The durable-directory protocol journals the map to its own data:

* **Journal (gossip-out)**: every directory mutation fires ``on_change``
  hooks outside the lock; the pool subscribes and pushes the updated record
  to each *holder* of the buffer as a ``_ham/dir_gossip`` oneway.  A worker
  keeps only the shard of directory state for buffers it holds
  (``NodeRuntime.dir_shard``) — per-worker memory is proportional to the
  worker's own data, not the cluster's.  Entries are installed
  epoch-monotonically (``>=`` — holder-set changes do not bump epochs, and
  per-link FIFO orders same-epoch updates); a tombstone (``primary < 0``,
  sent on free/lost) or an entry that no longer names the worker as holder
  deletes the shard entry.
* **Rebuild (gossip-in)**: ``ClusterPool.restart_host`` replaces the host
  runtime, then sync-calls ``_ham/dir_dump`` on every survivor and merges
  the shards — highest epoch wins, ties prefer the entry whose dumper is
  its own primary (a holder always has the freshest view of a buffer it
  serves).  An entry whose primary did not survive promotes onto its
  lowest live replica (epoch + 1, exactly the crash-promotion rule); an
  entry with no live holder is recorded lost.  The merged set is
  :meth:`BufferDirectory.install`-ed into a fresh directory without
  re-firing the hooks (the state *came from* the shards).
* **Guarantee**: gossip oneways are best-effort, but a lost gossip frame
  can only lose *metadata newer than the bytes' placement changed* — and
  placement changes are host-driven, so the host that crashed was the only
  writer.  Any buffer whose holders survive the host crash is recoverable;
  ``BENCH_cluster.json`` ``recovery.host_restart`` asserts ``lost = 0``.

Chain replication (the write protocol)
--------------------------------------

Contract: docs/failure-model.md, "Write visibility and convergence".

A replicated write moves bytes exactly once per link: host -> primary ->
replica 1 -> replica 2 -> ...  Three handlers implement it:

* ``_ham/chain_put(handle, offset, chunk, hops, dirty)`` — store one chunk
  locally, then forward it to ``hops[0]`` (with ``hops[1:]``) as a
  *oneway*, pushed onto the wire before the next inbound chunk is handled,
  so chunk k travels down-chain while chunk k+1 is still arriving
  (pipelining — the chain costs ~one link of latency, not one transfer
  per holder).  Forwards deliberately carry no reply: a handler blocking
  on per-chunk acks can deadlock against its own event loop's drain batch
  (an ack drained *behind* the blocking frame is unreachable), and the
  flush's chunk count subsumes them.
* ``_ham/chain_flush(handle, hops, dirty, nchunks)`` — the write's tail:
  verify all ``nchunks`` chunks of write epoch ``dirty`` landed here
  (per-link FIFO puts the flush behind every forwarded chunk), record
  ``applied_dirty[handle] = dirty`` (this node's bytes now reflect that
  write), then flush the rest of the chain synchronously.  Returns the
  list of node ids that confirmed the complete write — a crash or
  partition mid-chain truncates the list at the break, never hides it.
* ``_ham/chain_push(handle, hops, dirty, chunk_nbytes, adopt)`` — the
  source-driven form (migration, backfill, post-mutation refresh): the
  node holding the bytes streams its own copy down ``hops`` with a bounded
  send window, no host staging.

Sequencing: every write carries a **dirty epoch** minted by the host
directory (:meth:`BufferDirectory.begin_write` — distinct from the
*ownership* epoch, which tracks placement).  A holder's ``applied_dirty``
is dumped next to its shard entry (``_ham/dir_dump``), so a host rebuild
can detect a chain tail that missed a write (its applied epoch trails a
surviving peer's) and drop it from the promotable set — a crash mid-chain
leaves a *detectable* stale tail, healed by the ordinary promotion and
lazy-backfill machinery, never a silently promotable stale copy.

Read-only routing contract (what keeps copies from diverging)
-------------------------------------------------------------

Chain-replicated ``put`` and declared-``mutates`` handler commits (below)
are the only sanctioned ways to change a replicated buffer's bytes.  An
*undeclared* handler write through ``deref`` updates exactly one copy — so
serving such a call from a replica would silently diverge it from the
primary, and a later crash could promote either version.  The guard is
declarative: only handlers registered with ``read_only=True``
(:class:`~repro_torch.core.registry.HandlerRecord`) may have their pointers
retargeted at a replica holder or widen their locality votes to every
holder; every other call has its pointers pinned to the *primary* (and
votes for the primary only), so an undeclared mutation can only ever land
on the authoritative copy.  Replica-routed reads additionally **fence on
the write epoch**: while a chain write is in flight
(:meth:`BufferDirectory.writing`), reads pin to the primary instead of a
replica whose bytes are mid-overwrite.

Mutate-at-data (Active Access writes)
-------------------------------------

A handler registered ``mutates=True`` is the declared write-side twin of
``read_only``: the scheduler routes it to the primary, lets it mutate the
authoritative bytes in place (the operation ships to the data — no
get/mutate/put round trip), and **commits** the mutation afterwards:
:meth:`BufferDirectory.commit_write` bumps the buffer's dirty epoch and
the pool either *invalidates* the replica holders (they drop their copy
and re-backfill lazily — the default, metadata-only) or *refreshes* them
(the primary chain-pushes the new bytes down the same chain).  Either way
no reader can silently observe a pre-mutation replica after the commit:
the copy is gone from the holder set, or it holds the new bytes.  The
bare primitive — route at primary, execute, commit, nothing queued in
between — is ``ClusterPool.mutate``; the scheduler path layers
deadlines/retries on the same contract for scheduled traffic.  A
handler that is *neither* ``read_only`` nor ``mutates`` and derefs a
replicated buffer gets a one-shot warning pointing at the contract
(docs/failure-model.md) — its in-place writes are invisible to replicas
until the caller re-puts.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Hashable

from repro_torch.core.errors import OffloadError, RegistrySealedError
from repro_torch.core.migratable import MAX_SCAN_DEPTH
from repro_torch.offload.buffer import BufferPtr


@dataclasses.dataclass
class BufferRecord:
    """Directory entry: current placement of one logical buffer."""

    handle: int
    primary: int
    replicas: tuple[int, ...]
    epoch: int
    nbytes: int
    shape: tuple
    dtype: str
    session: Hashable | None = None
    #: write (dirty) epoch — bumped per committed write/mutation, sequenced
    #: by the directory (module docs, "Chain replication").  Orthogonal to
    #: ``epoch``, which tracks *placement* (primary moves).
    dirty: int = 0

    @property
    def holders(self) -> tuple[int, ...]:
        return (self.primary, *self.replicas)

    def ptr(self) -> BufferPtr:
        return BufferPtr(self.primary, self.handle, self.nbytes, self.epoch)


class BufferDirectory:
    """Host-side id -> (primary, replicas, epoch) map with stale-pointer
    resolution and crash promotion (protocol in the module docstring).

    Thread-safe; promotion runs on the pool monitor thread and is metadata
    only (the replica already holds the bytes).  ``on_repin`` hooks fire
    outside the lock with ``(session_key, new_node)`` whenever a primary
    move strands a session's pin — the scheduler's SessionRouter subscribes
    and moves the session to its data.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._records: dict[int, BufferRecord] = {}
        self._lost: dict[int, str] = {}  # handle -> why
        #: handles with a chain write in flight (begin_write .. commit_write)
        #: — replica-routed reads fence on this (module docs)
        self._writing: dict[int, int] = {}
        self._repin_hooks: list[Callable[[Hashable, int], None]] = []
        #: gossip journal subscribers (module docs, durable directory):
        #: cb(handle, record_snapshot_or_None, holders_to_notify)
        self._change_hooks: list[Callable] = []
        self.stats = {"promoted": 0, "lost": 0, "migrated": 0,
                      "backfilled": 0, "stale_resolved": 0, "freed": 0}

    # -- registration ------------------------------------------------------

    def register(self, ptr: BufferPtr, shape, dtype,
                 replicas=(), session: Hashable | None = None) -> BufferPtr:
        rec = BufferRecord(
            handle=ptr.handle, primary=ptr.node,
            replicas=tuple(int(r) for r in replicas), epoch=0,
            nbytes=ptr.nbytes, shape=tuple(int(d) for d in shape),
            dtype=str(dtype), session=session,
        )
        with self._lock:
            self._records[ptr.handle] = rec
        self._fire_change(ptr.handle, rec, rec.holders)
        return rec.ptr()

    def on_repin(self, cb: Callable[[Hashable, int], None]) -> None:
        self._repin_hooks.append(cb)

    def on_change(self, cb: Callable) -> None:
        """Subscribe to the directory journal: ``cb(handle, record, holders)``
        after every mutation, OUTSIDE the lock — ``record`` is a snapshot
        (None = the buffer is gone: freed or lost) and ``holders`` names the
        nodes whose gossip shard the change concerns (for a tombstone, the
        *previous* holders).  The pool's gossip fan-out subscribes here."""
        self._change_hooks.append(cb)

    def _fire_change(self, handle: int, rec: BufferRecord | None,
                     holders) -> None:
        if not self._change_hooks:
            return
        snap = None if rec is None else dataclasses.replace(rec)
        for cb in self._change_hooks:
            try:
                cb(int(handle), snap, tuple(holders))
            except Exception:  # noqa: BLE001 — a bad journal subscriber must
                # not block the mutation (gossip is best-effort by contract)
                import traceback

                traceback.print_exc()

    def install(self, records, lost: dict[int, str] | None = None) -> None:
        """Bulk-install ``records`` (host-crash rebuild from worker shards —
        module docs): replaces the tracked set; ``lost`` maps handles that
        did not survive to their diagnosis (resolves raise it).  Does NOT
        fire change hooks: the installed state came *from* the shards,
        re-gossiping it would be a no-op round trip."""
        with self._lock:
            self._records = {int(r.handle): r for r in records}
            if lost:
                self._lost.update({int(h): str(w) for h, w in lost.items()})
                self.stats["lost"] += len(lost)

    # -- lookup / resolution -----------------------------------------------

    def __len__(self) -> int:
        return len(self._records)

    def empty(self) -> bool:
        """True when a submit-path resolution pass cannot possibly matter:
        nothing tracked AND nothing lost (a lost handle must still raise)."""
        return not self._records and not self._lost

    def lookup(self, handle: int) -> BufferRecord | None:
        """Snapshot of a buffer's current record (promotion/migration keep
        mutating the live entry — callers get a stable copy)."""
        with self._lock:
            rec = self._records.get(int(handle))
            return None if rec is None else dataclasses.replace(rec)

    def lost_reason(self, handle: int) -> str | None:
        with self._lock:
            return self._lost.get(int(handle))

    def resolve(self, ptr: BufferPtr) -> BufferPtr:
        """Current pointer for ``ptr``'s buffer.  A stale epoch is rewritten
        to the live primary; an unknown handle passes through untouched (the
        directory only speaks for buffers it registered); a lost buffer
        raises — callers get a diagnosis, not a dangling-handle error on
        some arbitrary node."""
        with self._lock:
            rec = self._records.get(ptr.handle)
            if rec is None:
                why = self._lost.get(ptr.handle)
                if why is not None:
                    raise OffloadError(
                        f"buffer {ptr.handle:#x} lost: {why} (no replica held "
                        "its bytes; allocate with replicas>=1 to survive a "
                        "crash)"
                    )
                return ptr
            if ptr.epoch == rec.epoch and ptr.node == rec.primary:
                return ptr
            self.stats["stale_resolved"] += 1
            return rec.ptr()

    def resolve_args(self, args, target: int | None = None):
        """Rewrite every ``BufferPtr`` in a shallow pytree of call args.

        Each pointer resolves to its *current* placement; when ``target`` is
        given and holds a copy (primary OR replica), the hint is retargeted
        at ``target`` so the receiving node's own-address-space dereference
        check passes — this is what lets locality routing serve a read from
        any live replica.  Callers must only pass ``target`` for calls
        declared ``read_only`` (module docs, read-only routing contract);
        with ``target=None`` every pointer pins to the primary.  Returns
        ``(new_args, changed)``; the original structure is returned
        untouched when nothing needed rewriting.

        Containers are descended to the same depth-32 bound
        ``scan_locality`` enforces (``migratable.MAX_SCAN_DEPTH``) — a
        pointer deep enough to vote is always deep enough to rewrite, so
        locality routing can never ship a frame whose hint fails the
        holder's own-address-space check.
        """

        def walk(v, depth=0):
            if isinstance(v, BufferPtr):
                rec = self.lookup(v.handle)
                if rec is None:
                    return self.resolve(v)  # raises for lost buffers
                # replica-read fence: while a chain write is in flight the
                # replica's bytes are mid-overwrite — pin to the primary
                node = target if (target is not None and target in rec.holders
                                  and not self.writing(v.handle)) \
                    else rec.primary
                if v.node == node and v.epoch == rec.epoch:
                    return v
                self.stats["stale_resolved"] += v.epoch != rec.epoch
                return v.at(node, rec.epoch)
            if depth >= MAX_SCAN_DEPTH:  # same bound as scan_locality's walk
                return v
            if isinstance(v, (list, tuple)):
                out = [walk(i, depth + 1) for i in v]
                if all(a is b for a, b in zip(out, v)):
                    return v
                return type(v)(out)
            if isinstance(v, dict):
                out = {k: walk(i, depth + 1) for k, i in v.items()}
                if all(out[k] is v[k] for k in v):
                    return v
                return out
            return v

        new = tuple(walk(a) for a in args)
        changed = any(a is not b for a, b in zip(new, args))
        return (new if changed else tuple(args)), changed

    def locality_resolver(self, value):
        """``scan_locality`` resolver for READ-ONLY calls: a registered
        buffer votes for EVERY live holder (any copy can serve a read),
        nbytes-weighted; unknown values fall back to the codec's
        single-node hint (return None).  Calls not declared read-only must
        use :meth:`primary_resolver` instead — routing a mutating call at
        a replica would diverge the copies (module docs)."""
        if not isinstance(value, BufferPtr):
            return None
        rec = self.lookup(value.handle)
        if rec is None:
            return None
        w = max(1, rec.nbytes)
        if self.writing(value.handle):
            # replica-read fence (module docs): votes narrow to the primary
            # so _resolve_for's pin and the routing choice agree
            return {rec.primary: w}
        return {n: w for n in rec.holders}

    def primary_resolver(self, value):
        """``scan_locality`` resolver for calls NOT declared read-only: a
        registered buffer votes for its current *primary* only (fixing a
        stale ``ptr.node`` hint in passing); unknown values fall back to
        the codec (return None)."""
        if not isinstance(value, BufferPtr):
            return None
        rec = self.lookup(value.handle)
        if rec is None:
            return None
        return {rec.primary: max(1, rec.nbytes)}

    # -- write sequencing (dirty epochs; module docs, chain replication) ----

    def begin_write(self, handle: int) -> int:
        """Open a chain write: mint and return the buffer's next dirty
        epoch.  No gossip fires here — the bytes are not anywhere yet; the
        matching :meth:`commit_write` journals the final state.  While open,
        replica-routed reads fence to the primary (:meth:`writing`)."""
        with self._lock:
            rec = self._records[int(handle)]
            rec.dirty += 1
            self._writing[int(handle)] = self._writing.get(int(handle), 0) + 1
            return rec.dirty

    def commit_write(self, handle: int, stale=()) -> BufferRecord | None:
        """Close a chain write: drop the ``stale`` holders (replicas that
        did not confirm the write — a copy that may be torn must never be
        promotable) and fire ONE gossip journal entry carrying the new
        dirty epoch.  Returns a snapshot of the committed record (None if
        the buffer was freed mid-write)."""
        handle = int(handle)
        with self._lock:
            n = self._writing.get(handle, 0) - 1
            if n > 0:
                self._writing[handle] = n
            else:
                self._writing.pop(handle, None)
            rec = self._records.get(handle)
            if rec is None:
                return None
            dropped = [int(r) for r in stale if r in rec.replicas]
            if dropped:
                rec.replicas = tuple(
                    r for r in rec.replicas if r not in dropped
                )
            holders = (*rec.holders, *dropped)
            snap = dataclasses.replace(rec)
        # dropped holders are notified too: their shard entry must go
        self._fire_change(handle, rec, holders)
        return snap

    def writing(self, handle: int) -> bool:
        """True while a chain write to ``handle`` is in flight — the
        replica-read fence (module docs, read-only routing contract)."""
        with self._lock:
            return int(handle) in self._writing

    # -- placement mutation (epoch bumps) ----------------------------------

    def set_primary(self, handle: int, node: int) -> BufferPtr:
        """Move a buffer's primary (drain migration); bumps the epoch."""
        changed = False
        with self._lock:
            rec = self._records[int(handle)]
            if node != rec.primary:
                rec.replicas = tuple(
                    r for r in rec.replicas if r != node
                )
                rec.primary, rec.epoch = int(node), rec.epoch + 1
                self.stats["migrated"] += 1
                changed = True
            ptr = rec.ptr()
        if changed:
            self._fire_change(handle, rec, rec.holders)
        return ptr

    def remove_replica(self, handle: int, node: int) -> None:
        """Forget one replica (its copy failed to update or its node is
        unreachable): a holder that may be stale must never be promoted."""
        changed = False
        with self._lock:
            rec = self._records.get(int(handle))
            if rec is not None and node in rec.replicas:
                rec.replicas = tuple(r for r in rec.replicas if r != node)
                changed = True
        if changed:
            # the dropped holder is notified too: its shard entry must go
            self._fire_change(handle, rec, (*rec.holders, int(node)))

    def add_replica(self, handle: int, node: int) -> None:
        changed = False
        with self._lock:
            rec = self._records.get(int(handle))
            if rec is not None and node != rec.primary \
                    and node not in rec.replicas:
                rec.replicas = (*rec.replicas, int(node))
                self.stats["backfilled"] += 1
                changed = True
        if changed:
            self._fire_change(handle, rec, rec.holders)

    def detach_node(self, node: int) -> None:
        """Forget ``node`` as a holder everywhere (it left cleanly; its
        primaries must already have been migrated off)."""
        touched = []
        with self._lock:
            for rec in self._records.values():
                if node in rec.replicas:
                    rec.replicas = tuple(r for r in rec.replicas if r != node)
                    touched.append(rec)
        for rec in touched:
            self._fire_change(rec.handle, rec, rec.holders)

    def primaries_on(self, node: int) -> list[BufferRecord]:
        with self._lock:
            return [dataclasses.replace(r) for r in self._records.values()
                    if r.primary == node]

    def replicas_on(self, node: int) -> list[BufferRecord]:
        with self._lock:
            return [dataclasses.replace(r) for r in self._records.values()
                    if node in r.replicas]

    def under_replicated(self, factor: int, live: set[int]) -> list[BufferRecord]:
        """Records holding fewer than ``factor`` live replicas (join-time
        lazy backfill scans this)."""
        with self._lock:
            return [
                dataclasses.replace(r) for r in self._records.values()
                if len([n for n in r.replicas if n in live]) < factor
            ]

    # -- crash promotion ---------------------------------------------------

    def on_node_death(self, node: int) -> dict[int, int]:
        """Metadata-only failover for every buffer ``node`` held.  Returns
        ``{handle: new_primary}`` for the promoted buffers; buffers with no
        surviving replica are recorded lost.  Fires ``on_repin`` hooks (see
        class docs) after the lock is released."""
        moved: dict[int, int] = {}
        sessions: set = set()
        touched: list = []  # (handle, rec_or_None, holders_to_notify)
        with self._lock:
            for handle, rec in list(self._records.items()):
                if rec.primary == node:
                    live_reps = [r for r in rec.replicas if r != node]
                    if live_reps:
                        rec.primary = min(live_reps)
                        rec.replicas = tuple(
                            r for r in live_reps if r != rec.primary
                        )
                        rec.epoch += 1
                        moved[handle] = rec.primary
                        self.stats["promoted"] += 1
                        touched.append((handle, rec, rec.holders))
                        if rec.session is not None:
                            sessions.add(rec.session)
                    else:
                        del self._records[handle]
                        self._lost[handle] = f"primary node {node} died"
                        self.stats["lost"] += 1
                        touched.append((handle, None, ()))
                elif node in rec.replicas:
                    rec.replicas = tuple(r for r in rec.replicas if r != node)
                    touched.append((handle, rec, rec.holders))
        for handle, rec, holders in touched:
            self._fire_change(handle, rec, holders)
        for key in sessions:
            self._fire_repin(key)
        return moved

    # -- sessions ----------------------------------------------------------

    def bind_session(self, handle: int, session: Hashable) -> None:
        with self._lock:
            rec = self._records.get(int(handle))
            if rec is not None:
                rec.session = session
        if rec is not None:
            self._fire_change(handle, rec, rec.holders)

    def session_records(self, session: Hashable) -> list[BufferRecord]:
        with self._lock:
            return [dataclasses.replace(r) for r in self._records.values()
                    if r.session == session]

    def session_home(self, session: Hashable) -> int | None:
        """Node holding the most bytes of a session's buffers (primary
        placement) — where the session should live."""
        votes: dict[int, int] = {}
        for rec in self.session_records(session):
            votes[rec.primary] = votes.get(rec.primary, 0) + max(1, rec.nbytes)
        if not votes:
            return None
        return max(votes, key=lambda n: (votes[n], -n))

    def _fire_repin(self, session: Hashable) -> None:
        home = self.session_home(session)
        if home is None:
            return
        for cb in self._repin_hooks:
            try:
                cb(session, home)
            except Exception:  # noqa: BLE001 — a bad subscriber must not
                # stop failover for the remaining sessions
                import traceback

                traceback.print_exc()

    def repin_sessions_moved(self, handles) -> None:
        """Fire repin hooks for the sessions of explicitly moved buffers
        (drain migration calls this after its copies land)."""
        sessions = set()
        with self._lock:
            for h in handles:
                rec = self._records.get(int(h))
                if rec is not None and rec.session is not None:
                    sessions.add(rec.session)
        for key in sessions:
            self._fire_repin(key)

    # -- free --------------------------------------------------------------

    def mark_lost(self, handle: int, why: str) -> None:
        """Record a buffer unrecoverable (e.g. its drain-migration copy
        failed and its only holder is being retired): the record is dropped
        and later resolves raise the diagnosis instead of routing at a
        retired node."""
        with self._lock:
            rec = self._records.pop(int(handle), None)
            if rec is not None:
                self._lost[int(handle)] = why
                self.stats["lost"] += 1
        if rec is not None:
            # tombstone to the previous holders: their shard entries must go
            self._fire_change(handle, None, rec.holders)

    def drop(self, handle: int) -> BufferRecord | None:
        """Forget a buffer (it is being freed); returns the final record so
        the caller can invalidate the remaining holders."""
        with self._lock:
            rec = self._records.pop(int(handle), None)
            if rec is not None:
                self.stats["freed"] += 1
        if rec is not None:
            self._fire_change(handle, None, rec.holders)
        return rec

    def live_handles(self) -> list[int]:
        with self._lock:
            return sorted(self._records)

    def lost_handles(self) -> list[int]:
        with self._lock:
            return sorted(self._lost)


def tracked_handles(directory: BufferDirectory, args) -> tuple[int, ...]:
    """Directory-tracked buffer handles referenced by ``args`` — the
    handles a mutating call's commit must invalidate (module docs,
    "Mutate-at-data").  Same shallow pytree walk and depth bound as
    :meth:`BufferDirectory.resolve_args` / ``scan_locality``: a pointer
    deep enough to route on is deep enough to commit."""
    found: list[int] = []

    def walk(v, depth=0):
        if isinstance(v, BufferPtr):
            if directory.lookup(v.handle) is not None:
                found.append(int(v.handle))
            return
        if depth >= MAX_SCAN_DEPTH:
            return
        if isinstance(v, (list, tuple)):
            for i in v:
                walk(i, depth + 1)
        elif isinstance(v, dict):
            for i in v.values():
                walk(i, depth + 1)

    for a in args:
        walk(a)
    return tuple(dict.fromkeys(found))


# --------------------------------------------------------------------------
# control handlers (dynamic payloads; registered at import = static init)
# --------------------------------------------------------------------------


def _h_buf_adopt(handle, shape, dtype):
    """Install an empty copy of a foreign buffer under its global handle
    (replica creation / migration target); the bytes follow over the
    ordinary chunked ``_ham/put`` path."""
    from repro_torch.offload.runtime import current_node

    current_node().buffers.adopt_empty(int(handle), shape, dtype)


def _h_buf_invalidate(handle):
    """Drop this node's copy of a buffer (idempotent — an invalidate may
    race a local free; both outcomes are 'copy gone')."""
    from repro_torch.offload.runtime import current_node

    node = current_node()
    node.dir_shard.pop(int(handle), None)  # gossip hygiene: copy is gone
    return node.buffers.discard(int(handle))


def _h_buf_count():
    """This node's live buffer count — lets tests and benchmarks assert
    cluster-wide replica hygiene (no leaks after free/session end)."""
    from repro_torch.offload.runtime import current_node

    return current_node().buffers.live_count()


def _h_buf_freed(node_id, handle):
    """Host-side half of worker-initiated frees: a worker that freed its
    copy announces it here (oneway); the directory drops the record and the
    remaining holders get ``_ham/buf_invalidate`` oneways, keeping
    ``live_count`` truthful cluster-wide."""
    from repro_torch.core.closure import Function
    from repro_torch.offload.runtime import current_node

    node = current_node()
    directory = getattr(node, "buffer_directory", None)
    if directory is None:
        return
    rec = directory.drop(int(handle))
    if rec is None:  # already dropped (e.g. a host-side free raced us)
        return
    record = node.table.record_of("_ham/buf_invalidate")
    for holder in rec.holders:
        if holder == int(node_id):
            continue  # the announcer already dropped its copy
        try:
            node.send_oneway(holder, Function(record, (int(handle),)))
        except Exception:  # noqa: BLE001 — best effort; the holder may be
            # mid-removal, and a leaked replica is recovered at its teardown
            pass


#: per-hop wait bound for the chain write protocol — how long a node waits
#: on its downstream neighbour before declaring the tail unconfirmable and
#: truncating the confirmation list there (tests shrink this to exercise
#: mid-chain partitions without real-time 30 s stalls)
CHAIN_HOP_TIMEOUT = 30.0

# -- chain replication handlers (module docs, "Chain replication";
# contract in docs/failure-model.md, "Write visibility and convergence") --


def _h_chain_put(handle, offset, chunk, hops, dirty):
    """One chunk of a chain-replicated write: store it locally, then
    forward it to ``hops[0]`` as a *oneway* before returning — chunk k
    rides the next link while chunk k+1 is still arriving here, so the
    whole chain costs ~one link of extra latency, not one transfer per
    holder.  The forward carries no reply on purpose: confirmation flows
    through ``_ham/chain_flush``, which travels the same link (per-link
    FIFO orders it behind every chunk) and checks the receiver's own
    chunk count — waiting on per-chunk acks from handler context can
    deadlock against the event loop's drain batch (an ack drained into
    the same batch *behind* the blocking frame is unreachable until
    timeout)."""
    from repro_torch.core.closure import Function
    from repro_torch.offload.buffer import BufferPtr
    from repro_torch.offload.runtime import current_node

    node = current_node()
    handle, dirty = int(handle), int(dirty)
    flat = node.buffers.flat(BufferPtr(node.node_id, handle))
    n = chunk.size
    flat[offset : offset + n] = chunk.reshape(-1).astype(flat.dtype,
                                                         copy=False)
    seen = node.chain_seen.get(handle)
    if seen is None or seen[0] != dirty:
        node.chain_seen[handle] = seen = [dirty, 0]  # a new write epoch
        # restarts the count; chunks of an abandoned earlier write drop
    seen[1] += 1
    if hops:
        # send_oneway packs (= copies) the chunk into the outbound frame
        # before returning, so a frame-aliasing inbound view is safe here
        record = node.table.record_of("_ham/chain_put")
        node.send_oneway(int(hops[0]), Function(
            record, (handle, int(offset), chunk,
                     [int(h) for h in hops[1:]], dirty)))
        # push the forward out NOW, not at end-of-drain-batch: the next
        # hop must store chunk k while chunk k+1 is still crossing the
        # host->primary link, else the chain serialises into recv-all-
        # then-forward-all and the pipelining win evaporates
        node._flush_egress()


def _h_chain_flush(handle, hops, dirty, nchunks):
    """Tail of one chain write: verify every chunk of write epoch ``dirty``
    landed here, mark this node's bytes as reflecting ``dirty``
    (``applied_dirty``), then flush the rest of the chain synchronously.
    The downstream flush rides the same link as the forwarded chunks, so
    per-link FIFO guarantees the next hop counted every chunk before it
    answers — its own ``got != nchunks`` check subsumes per-chunk acks.
    Returns the node ids holding the COMPLETE write — a crash/partition
    mid-chain truncates the list at the break, so the caller sees exactly
    which tail is stale."""
    from repro_torch.core.closure import Function
    from repro_torch.offload.runtime import current_node

    node = current_node()
    handle, dirty, nchunks = int(handle), int(dirty), int(nchunks)
    seen = node.chain_seen.pop(handle, None)
    got = seen[1] if seen is not None and seen[0] == dirty else 0
    if got != nchunks:
        return []  # torn local copy — and the tail only saw what we forwarded
    node.applied_dirty[handle] = dirty
    if not hops:
        return [node.node_id]
    record = node.table.record_of("_ham/chain_flush")
    try:
        downstream = node.wait(node.send_async(int(hops[0]), Function(
            record, (handle, [int(h) for h in hops[1:]], dirty, nchunks))),
            CHAIN_HOP_TIMEOUT)
    except Exception:  # noqa: BLE001 — next hop unreachable: the chain is
        # confirmed up to and including this node only
        return [node.node_id]
    return [node.node_id, *[int(n) for n in downstream]]


def _h_chain_push(handle, hops, dirty, chunk_nbytes, adopt):
    """Source-driven chain write (migration / backfill / post-mutation
    refresh): stream THIS node's copy of ``handle`` down ``hops`` with a
    bounded send window — the host never stages the bytes.  ``adopt=True``
    first installs an empty copy on each hop (idempotent).  Returns the
    confirmed node ids, exactly as ``_ham/chain_flush``."""
    from repro_torch.core.closure import Function
    from repro_torch.offload.buffer import BufferPtr
    from repro_torch.offload.runtime import current_node

    node = current_node()
    handle, dirty = int(handle), int(dirty)
    hops = [int(h) for h in hops]
    arr = node.buffers.deref(BufferPtr(node.node_id, handle))
    if adopt:
        rec_adopt = node.table.record_of("_ham/buf_adopt")
        for h in hops:
            node.wait(node.send_async(h, Function(
                rec_adopt, (handle, [int(d) for d in arr.shape],
                            str(arr.dtype)))), CHAIN_HOP_TIMEOUT)
    flat = arr.reshape(-1)
    limit = int(chunk_nbytes)
    cap = getattr(node.endpoint, "max_frame_nbytes", None)
    if cap:
        limit = min(limit, cap - 4096)
    step = max(1, limit // max(1, flat.dtype.itemsize))
    rec_put = node.table.record_of("_ham/chain_put")
    window: list = []
    nchunks = 0
    if flat.size:
        for o in range(0, flat.size, step):
            window.append(node.send_async(hops[0], Function(
                rec_put, (handle, int(o), flat[o : o + step], hops[1:],
                          dirty))))
            nchunks += 1
            if len(window) >= 4:  # bounded window: overlap without
                # unbounded frames in flight on a long chain
                node.wait(window.pop(0), CHAIN_HOP_TIMEOUT)
    for fut in window:
        node.wait(fut, CHAIN_HOP_TIMEOUT)
    rec_flush = node.table.record_of("_ham/chain_flush")
    confirmed = node.wait(node.send_async(hops[0], Function(
        rec_flush, (handle, hops[1:], dirty, nchunks))), CHAIN_HOP_TIMEOUT)
    node.applied_dirty[handle] = dirty
    return [node.node_id, *[int(n) for n in confirmed]]


def register_dataplane_handlers(registry=None) -> None:
    """Register the ``_ham/buf_*`` control plane and the ``_ham/chain_*``
    write protocol.  Safe to call repeatedly; silently skipped on an
    already-sealed registry (as with the cluster handlers — then callers
    must have registered these before ``init()``)."""
    from repro_torch.core.registry import default_registry

    # adopt/invalidate/freed mutate the replica map; the chain handlers
    # write buffer bytes; buf_count is a pure read of the local buffer
    # registry (read_only => replica-servable)
    reg = registry or default_registry()
    for name, fn, read_only in (
        ("_ham/buf_adopt", _h_buf_adopt, False),
        ("_ham/buf_invalidate", _h_buf_invalidate, False),
        ("_ham/buf_count", _h_buf_count, True),
        ("_ham/buf_freed", _h_buf_freed, False),
        ("_ham/chain_put", _h_chain_put, False),
        ("_ham/chain_flush", _h_chain_flush, False),
        ("_ham/chain_push", _h_chain_push, False),
    ):
        try:
            reg.register(fn, name=name, read_only=read_only)
        except RegistrySealedError:
            return


register_dataplane_handlers()
