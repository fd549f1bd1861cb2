"""Per-node active-message runtime: the "minimal runtime" of HAM-Offload.

One :class:`NodeRuntime` per process/thread-node:

* pulls frames from its comm endpoint,
* replies are routed to the sender's :class:`FutureTable` (the
  ``offload_result_msg`` path of paper Fig. 5),
* requests are executed through the node's :class:`ExecutionPolicy`; if the
  frame carries a ``msg_id`` the result is packed and sent back as a REPLY
  frame (errors as REPLY|ERROR with the remote traceback).

Hot path (the paper's Fig. 3 metric is this module's cost):

* the event loop drains frames in *batches* via ``recv_many`` — on
  zero-copy transports (shm rings) the frames are leased views into the
  receive window, decoded in place and only copied when something outlives
  the dispatch (a reply resolving a future, a non-direct execution policy);
* dispatch drives off **dense key-indexed plan arrays** compiled at
  ``HandlerTable`` init (``repro_torch.core.wireplan``): a static-spec handler's
  request is packed by its precompiled :class:`WirePlan` into a
  ``FLAG_STATIC`` frame (one fused struct call for scalar leaves, fixed
  extents for arrays) and its result travels back as a plan-packed
  ``FLAG_STATIC`` reply — no TLV, no per-message spec walk, no
  ``HandlerRecord`` attribute chasing; dynamic TLV stays as the fallback
  for ``arg_specs=None`` handlers, selected per frame via the header bits;
* **small-call fusion** (``FLAG_FUSED``): sub-threshold same-destination
  frames produced while draining a batch are folded into one multi-call
  frame (see ``core/message.py`` for the segment layout), and
  :meth:`send_fused` packs a caller-side batch the same way — one header,
  one transport publication, one dispatch pass for N calls, with replies
  fused symmetrically on the way back;
* replies and oneway sends produced while draining a batch are parked in an
  egress queue and flushed as one coalesced ``send_many`` per destination —
  one transport publication per drain iteration instead of per message;
* frames are packed at their exact final size (header + measured payload)
  so multi-megabyte put/get payloads see a single copy into the frame.

Handlers receive argument views that alias the inbound frame.  On leased
transports those views die when the batch is released, so a handler that
*retains* a payload (stores an array, returns it by reference) must copy —
everything else rides the bitwise fast path copy-free.

Internal handlers (registered at import, i.e. "static initialisation", with
explicit names so they sort deterministically — cf. the paper's
``terminate_functor`` appearing in its Fig. 7 dump):

* ``_ham/alloc``, ``_ham/free``, ``_ham/put``, ``_ham/get`` — buffer plane
* ``_ham/ping`` — liveness/barrier
* ``_ham/forward`` — one-hop relay (offload-over-fabric routing)
* ``_ham/terminate`` — stops the event loop

Handlers executing on a node can access "their" node via
:func:`current_node` (contextvar set around execution) — this is how
offloaded user code dereferences :class:`BufferPtr` arguments and how
*reverse offload* (worker calling back into the host) gets a sender.
"""

from __future__ import annotations

import contextvars
import os
import sys
import threading
import time
import traceback
from typing import Any

import numpy as np

from repro_torch.comm.base import CommBackend
from repro_torch.core import migratable as mig
from repro_torch.core.closure import Function
from repro_torch.core.errors import MessageFormatError, NodeDownError, OffloadError
from repro_torch.core.flags import MSG_ID_FLUSH
from repro_torch.core.future import Future, FutureTable
from repro_torch.core.executor import DirectPolicy, ExecutionPolicy
from repro_torch.core.message import (
    FLAG_DYNAMIC,
    FLAG_ERROR,
    FLAG_FUSED,
    FLAG_REPLY,
    FLAG_RETRYABLE,
    FLAG_SEG_SRC,
    FLAG_SHAPED,
    FLAG_STATIC,
    FUSED_COUNT_STRUCT,
    HEADER_NBYTES,
    HEADER_STRUCT,
    MAGIC,
    SEG_NBYTES,
    SEG_SRC_NBYTES,
    SEG_SRC_STRUCT,
    SEG_STRUCT,
    VERSION,
    decode_fast,
    iter_fused,
)
from repro_torch.core.registry import HandlerTable, default_registry
from repro_torch.core.wireplan import SIG_LEN_NBYTES, SIG_LEN_STRUCT, ShapeCache
from repro_torch.offload.buffer import BufferPtr, BufferRegistry

_current_node: contextvars.ContextVar["NodeRuntime | None"] = contextvars.ContextVar(
    "ham_current_node", default=None
)

_DRAIN_BATCH = 64  # frames pulled per recv_many in the event loop
_BIG_FRAME = 1 << 16  # above this, frames come from the pooled allocator

#: small-call fusion: frames with payloads at or below this fold into one
#: FLAG_FUSED frame when they share a destination (the ≤256 B static-args
#: regime of the Fig. 3 claim, with headroom for small dynamic replies)
FUSE_THRESHOLD = 512
#: segments per fused frame — bounds decode scratch and keeps one poison
#: batch from dominating a drain iteration
FUSE_MAX_SEGMENTS = 64


class _FramePool:
    """Refcount-checked reuse of large frame buffers.

    Freshly ``np.empty``-allocated multi-megabyte frames pay a page-fault
    storm on first touch (~40 us/MB); reusing warm buffers removes it.  A
    pooled buffer is handed out again only when *nothing outside the pool*
    references its backing array — transports drop their reference once the
    frame is delivered, while a reply frame pinned by a zero-copy result
    array stays referenced (and therefore un-reusable) until the caller
    drops the result.  The refcount check makes reuse safe without any
    explicit free protocol.
    """

    def __init__(self, max_items: int = 8):
        self._items: list[np.ndarray] = []
        self._max = max_items
        self._lock = threading.Lock()

    def take(self, nbytes: int) -> memoryview:
        with self._lock:
            # index-based scan: enumerate() would reuse its yield tuple and
            # keep a hidden extra reference to the candidate, breaking the
            # refcount test.  A free buffer is referenced exactly by the pool
            # list, the local `arr`, and getrefcount's argument => 3.
            for i in range(len(self._items)):
                arr = self._items[i]
                if arr.nbytes >= nbytes and sys.getrefcount(arr) == 3:
                    self._items.append(self._items.pop(i))  # LRU to the back
                    return memoryview(arr)[:nbytes]
        # round up so slightly-different frame sizes share buffers
        alloc = (nbytes + 0xFFFF) & ~0xFFFF
        arr = np.empty(alloc, dtype=np.uint8)
        with self._lock:
            self._items.append(arr)
            if len(self._items) > self._max:
                # evict the oldest *free* buffer (busy ones must stay tracked)
                for i in range(len(self._items)):
                    old = self._items[i]
                    if sys.getrefcount(old) == 3:
                        del self._items[i]
                        break
        return memoryview(arr)[:nbytes]


_frame_pool = _FramePool()


class ReplayCache:
    """Exactly-once dedup for retransmitted requests (docs/failure-model.md).

    Keyed by ``(src_node, msg_id)`` — msg_ids are per-sender monotonic, so
    the pair names one logical call forever.  Entries move through three
    states: *in progress* (first arrival is executing — a duplicate arriving
    mid-execution on a pooled policy is dropped, the original will reply),
    *cached* (the packed reply frame — a retransmit re-sends it instead of
    re-executing, which is what keeps mutating handlers exactly-once under
    retry), and *evicted*.

    Memory is bounded two ways: the sender's scheduler piggybacks cumulative
    acks (``_ham/replay_ack(src, upto)`` — every msg_id <= ``upto`` is
    complete at the sender, so its cached reply can never be asked for
    again), and a FIFO cap is the backstop for senders that never ack.
    The ack watermark is also a *suppression floor*: a duplicate at or
    below it (a retransmit reordered behind the ack that evicted its cached
    reply) is dropped outright instead of re-executed — eviction must never
    reopen the exactly-once window.  An ack of ``upto >= FLUSH`` announces
    a NEW msg_id space (host restart): the cache forgets everything from
    that sender, watermark included, so low new ids neither alias old
    cached replies nor get floor-suppressed.
    Only requests carrying ``FLAG_RETRYABLE`` enter the cache — the default
    fault-free path never touches it (the <=5% hot-path overhead contract).
    """

    IN_PROGRESS = object()
    #: ack threshold meaning "sender reset its msg_id space — flush";
    #: value lives in the centralized wire-constant registry, which asserts
    #: it stays out of live msg_id space (repro_torch.core.flags)
    FLUSH = MSG_ID_FLUSH

    def __init__(self, cap: int = 4096):
        import collections

        self._lock = threading.Lock()
        self._entries: dict[tuple[int, int], Any] = {}
        self._order: "collections.deque[tuple[int, int]]" = collections.deque()
        self._cap = int(cap)
        self._acked: dict[int, int] = {}  # src -> cumulative ack watermark
        self.stats = {"replayed": 0, "suppressed": 0, "acked": 0}

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def begin(self, src: int, msg_id: int):
        """First sight of ``(src, msg_id)`` returns None (caller executes);
        a duplicate returns IN_PROGRESS or the cached reply frame."""
        key = (src, msg_id)
        with self._lock:
            if msg_id <= self._acked.get(src, 0):
                # already complete at the sender; its cached reply may be
                # evicted, so executing again would break exactly-once —
                # drop the straggler (IN_PROGRESS: no execute, no reply)
                self.stats["suppressed"] += 1
                return self.IN_PROGRESS
            cur = self._entries.get(key)
            if cur is not None:
                # duplicate bookkeeping lives here so every dedup outcome
                # is visible in one stats dict: suppressed = swallowed
                # without reply (still executing), replayed = cached reply
                # about to be re-sent by the caller
                if cur is self.IN_PROGRESS:
                    self.stats["suppressed"] += 1
                else:
                    self.stats["replayed"] += 1
                return cur
            self._entries[key] = self.IN_PROGRESS
            self._order.append(key)
            scan = 0
            while len(self._order) > self._cap and scan < 8:
                old = self._order.popleft()
                entry = self._entries.get(old)
                if entry is self.IN_PROGRESS:
                    self._order.append(old)  # never evict a running call
                    scan += 1
                elif entry is not None:
                    del self._entries[old]
            return None

    def commit(self, src: int, msg_id: int, frame: bytes) -> None:
        """Store the packed reply frame for a call that just executed (the
        entry may have been acked/evicted concurrently — then drop it)."""
        key = (src, msg_id)
        with self._lock:
            if key in self._entries:
                self._entries[key] = frame

    def ack(self, src: int, upto: int) -> int:
        """Cumulative ack from ``src``: every msg_id <= ``upto`` is complete
        at the sender — evict their cached replies and raise the suppression
        floor.  ``upto >= FLUSH`` is the msg_id-space-reset sentinel (host
        restart): forget *everything* from ``src``, even in-progress entries
        (their commit then no-ops) and the floor itself, so the new space's
        low ids start clean.  ``_order`` keeps stale keys; eviction
        tolerates them (entries.get returns None)."""
        with self._lock:
            if upto >= self.FLUSH:
                dead = [k for k in self._entries if k[0] == src]
                self._acked.pop(src, None)
            else:
                self._acked[src] = max(self._acked.get(src, 0), int(upto))
                dead = [
                    k for k, v in self._entries.items()
                    if k[0] == src and k[1] <= upto
                    and v is not self.IN_PROGRESS
                ]
            for k in dead:
                del self._entries[k]
            self.stats["acked"] += len(dead)
        return len(dead)


def _alloc_frame(nbytes: int):
    """Writable frame buffer of ``nbytes``.

    ``bytearray(n)`` zero-fills — a full extra memory pass on multi-megabyte
    put/get payloads that the packer immediately overwrites.  Large frames
    therefore come from the (uninitialised, refcount-pooled) numpy allocator,
    wrapped in a memoryview so every consumer sees a flat byte buffer; small
    frames stay bytearray (lower constant cost).
    """
    if nbytes >= _BIG_FRAME:
        return _frame_pool.take(nbytes)
    return bytearray(nbytes)


def current_node() -> "NodeRuntime":
    node = _current_node.get()
    if node is None:
        raise OffloadError("no HAM node runtime active in this context")
    return node


# --------------------------------------------------------------------------
# internal handlers (dynamic payloads; explicit stable names)
# --------------------------------------------------------------------------


def _h_alloc(shape, dtype):
    node = current_node()
    ptr = node.buffers.allocate(shape, dtype)
    return ("ptr", ptr.node, ptr.handle, ptr.nbytes)


def _h_free(node_id, handle):
    node = current_node()
    node.buffers.free(BufferPtr(node_id, handle))
    node.dir_shard.pop(int(handle), None)  # gossip hygiene: copy is gone
    node._announce_buffer_freed(handle)


def _h_put(node_id, handle, offset, array):
    # `array` may alias the inbound frame (zero-copy unpack); the slice
    # assignment below is the single payload copy of the put path
    flat = current_node().buffers.flat(BufferPtr(node_id, handle))
    n = array.size
    flat[offset : offset + n] = array.reshape(-1).astype(flat.dtype, copy=False)


def _h_get(node_id, handle, offset, count):
    node = current_node()
    # return VIEWS: the reply is packed (= copied) before this handler's
    # dispatch ends, so the get path pays exactly one payload copy
    if count < 0 and not offset:
        return node.buffers.deref(BufferPtr(node_id, handle))  # keeps shape
    flat = node.buffers.flat(BufferPtr(node_id, handle))
    if count < 0:
        return flat[offset:]
    return flat[offset : offset + count]


def _h_ping(token):
    return token


def _h_forward(dst, frame_bytes):
    """Relay an embedded frame one hop (offload over fabric).  The final
    target replies straight to the origin recorded in the inner header."""
    node = current_node()
    node._send_frame(dst, frame_bytes)


def _h_terminate():
    current_node().request_stop()


def _h_replay_ack(src_node, upto):
    """Cumulative replay-cache ack (oneway): every msg_id <= ``upto`` from
    ``src_node`` is complete at the sender — its cached replies can go."""
    current_node().replay.ack(int(src_node), int(upto))


def _h_dir_gossip(entries):
    """Install directory-shard entries on this node (oneway; the gossip
    half of the durable directory — protocol in ``offload/dataplane``).

    Each entry is ``[handle, primary, replicas, epoch, nbytes, shape,
    dtype, session, dirty]`` (``dirty`` — the buffer's write epoch, chain
    protocol — was appended in v2; peers sending 8-element entries are
    read as ``dirty = 0``).  Installation is epoch-monotonic (``>=`` —
    holder-set changes do not bump the epoch, and per-link FIFO orders
    same-epoch updates); an entry whose holder set no longer includes this
    node — or a tombstone (``primary < 0``, the buffer was freed/lost) —
    drops the shard entry instead.
    """
    node = current_node()
    me = node.node_id
    shard = node.dir_shard
    for e in entries:
        handle, primary, replicas, epoch, nbytes, shape, dtype, session = e[:8]
        handle, primary, epoch = int(handle), int(primary), int(epoch)
        dirty = int(e[8]) if len(e) > 8 else 0
        replicas = [int(r) for r in replicas]
        if primary < 0 or (me != primary and me not in replicas):
            shard.pop(handle, None)
            node.applied_dirty.pop(handle, None)  # copy gone — the applied
            # watermark must not outlive it and vouch for a future re-adopt
            continue
        cur = shard.get(handle)
        if cur is None or epoch >= cur[2]:
            shard[handle] = (primary, replicas, epoch, int(nbytes),
                             [int(d) for d in shape], str(dtype), session,
                             dirty)


def _h_dir_dump():
    """This node's directory shard, for a restarting host's rebuild: the
    ``_ham/dir_gossip`` entry layout plus a 10th element — this node's
    ``applied_dirty`` watermark for the handle, so the rebuild can drop a
    chain tail whose bytes trail a surviving peer's write epoch (chain
    protocol, docs/failure-model.md).  Read-only: replica serving is safe,
    and a rebuild may query any survivor."""
    node = current_node()
    out = []
    for h, entry in sorted(node.dir_shard.items()):
        p, r, e, n, s, d, sess = entry[:7]
        dirty = entry[7] if len(entry) > 7 else 0
        out.append([h, p, r, e, n, s, d, sess, dirty,
                    node.applied_dirty.get(h, 0)])
    return out


def register_internal_handlers(registry=None) -> None:
    # read_only is the replica-serving contract (see HandlerRecord): True
    # only for handlers that never mutate node/buffer state.  alloc/free/put
    # mutate the buffer registry; forward re-injects traffic; terminate,
    # replay_ack and dir_gossip mutate runtime state.  get/ping/dir_dump
    # are pure reads and may be served by any replica.
    reg = registry or default_registry()
    for name, fn, read_only in (
        ("_ham/alloc", _h_alloc, False),
        ("_ham/free", _h_free, False),
        ("_ham/put", _h_put, False),
        ("_ham/get", _h_get, True),
        ("_ham/ping", _h_ping, True),
        ("_ham/forward", _h_forward, False),
        ("_ham/terminate", _h_terminate, False),
        ("_ham/replay_ack", _h_replay_ack, False),
        ("_ham/dir_gossip", _h_dir_gossip, False),
        ("_ham/dir_dump", _h_dir_dump, True),
    ):
        reg.register(fn, name=name, read_only=read_only)


# module import = static initialisation (paper §4.3)
register_internal_handlers()


# --------------------------------------------------------------------------
# the runtime
# --------------------------------------------------------------------------


class NodeRuntime:
    def __init__(
        self,
        node_id: int,
        endpoint: CommBackend,
        table: HandlerTable,
        policy: ExecutionPolicy | None = None,
        *,
        inline: bool = False,
        shape_cache: bool | None = None,
    ):
        self.node_id = node_id
        self.endpoint = endpoint
        self.table = table
        # shape-keyed WirePlan cache for dynamic payloads (FLAG_SHAPED).
        # ``None`` defers to HAM_SHAPE_CACHE (workers inherit the host's
        # environment at fork/spawn, so one env var flips both sides — the
        # benchmark's forced-TLV comparison leg relies on this).
        if shape_cache is None:
            shape_cache = os.environ.get("HAM_SHAPE_CACHE", "1") != "0"
        self._shape_cache = ShapeCache() if shape_cache else None
        # dense key-indexed fast-path arrays (compiled at HandlerTable init):
        # one list index per message instead of record attribute walks
        self._records = table.records
        self._arg_plans = table.arg_plans
        self._result_plans = table.result_plans
        #: fold sub-threshold same-destination egress frames into FLAG_FUSED
        #: multi-call frames at flush time (off => plain send_many batches).
        #: HAM_FUSE_EGRESS=0 disables it process-wide — forked workers inherit
        #: the env, which is how the relay benchmark measures the unfused leg.
        self.fuse_egress = os.environ.get("HAM_FUSE_EGRESS", "1") != "0"
        self.policy = policy or DirectPolicy()
        self.buffers = BufferRegistry(node_id)
        self.futures = FutureTable()
        self.inline = inline
        #: transport frame cap, hoisted off the endpoint once — _send_frame
        #: runs per message and must not pay a getattr per call
        self._frame_cap = getattr(endpoint, "max_frame_nbytes", None)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._sync_seq = 0  # inline futureless-sync sequence counter
        # egress coalescing: replies/oneways emitted while the event-loop
        # thread drains a batch are grouped into one send_many per dst
        self._egress: list[tuple[int, Any]] = []
        self._draining = False
        self._loop_tid: int | None = None
        self.stats = {"handled": 0, "replies": 0, "errors": 0, "sent": 0,
                      "batches": 0, "fused": 0, "replayed": 0}
        #: exactly-once dedup of FLAG_RETRYABLE requests (docs/failure-model.md)
        self.replay = ReplayCache()
        #: this node's shard of the cluster BufferDirectory — entries for
        #: buffers this node holds, installed by _ham/dir_gossip oneways and
        #: dumped to a restarting host via _ham/dir_dump (see
        #: repro_torch.offload.dataplane for the protocol)
        self.dir_shard: dict[int, tuple] = {}
        # -- chain-replication write protocol (repro_torch.offload.dataplane,
        # "Chain replication"; contract in docs/failure-model.md) ---------
        #: write epoch this node's bytes reflect, per handle — dumped next
        #: to the shard so a host rebuild can spot a stale chain tail
        self.applied_dirty: dict[int, int] = {}
        #: per-handle [dirty, chunks_received] for the write in flight —
        #: chunk forwards are oneways; _ham/chain_flush confirms via this
        #: count (per-link FIFO puts the flush behind every chunk)
        self.chain_seen: dict[int, list] = {}
        # -- queue-depth feedback (scheduler's remote-load signal) ---------
        #: last depth reported BY each peer via _cluster/stats oneways
        #: (populated on the node peers report to — normally the host)
        self.peer_depth: dict[int, int] = {}
        self._depth_dst: int | None = None       # report target (None = off)
        self._depth_interval = 0.05
        self._depth_record = None                # _cluster/stats HandlerRecord
        self._depth_last_sent = 0
        self._depth_last_t = 0.0
        self._batch_remaining = 0                # frames left in current drain
        #: host only: the cluster's BufferDirectory (set by ClusterPool) —
        #: _ham/buf_freed and local frees report here so replicas are
        #: invalidated cluster-wide (see repro_torch.offload.dataplane)
        self.buffer_directory = None

    # -- queue-depth feedback ----------------------------------------------

    def enable_depth_report(self, dst: int = 0,
                            interval: float = 0.05) -> "NodeRuntime":
        """Report this node's queue depth to ``dst`` (normally the host) as
        ``_cluster/stats`` oneways — at most one per ``interval`` while busy,
        plus an immediate zero report when the queue drains, so the receiver
        never acts on a stale busy signal.  Silently disabled when the
        handler table has no ``_cluster/stats`` entry (non-cluster domains).
        """
        try:
            self._depth_record = self.table.record_of("_cluster/stats")
        except Exception:  # noqa: BLE001 — UnknownHandlerError et al.
            self._depth_record = None
            return self
        self._depth_dst = dst
        self._depth_interval = interval
        return self

    def note_peer_depth(self, node_id: int, depth: int) -> None:
        """Receiver side of the depth protocol (called by _cluster/stats)."""
        self.peer_depth[int(node_id)] = int(depth)

    def queue_depth(self) -> int:
        """Requests this node has accepted but not finished executing: the
        rest of the current drain batch plus what the transport has queued.
        The remote half of the scheduler's join-shortest-queue signal."""
        try:
            pending = self.endpoint.pending_frames()
        except Exception:  # noqa: BLE001 — estimate only, never fail dispatch
            pending = 0
        return self._batch_remaining + pending

    def _maybe_report_depth(self, force_zero: bool = False) -> None:
        """Emit a depth report if one is due.  Sends bypass the egress queue
        (a depth report parked behind the batch it describes is useless)."""
        if self._depth_dst is None:
            return
        now = time.monotonic()
        if not force_zero and now - self._depth_last_t < self._depth_interval:
            # rate limit busy reports — and skip the depth walk entirely
            # between ticks (this runs per frame on the hot path); the
            # busy->idle edge is caught by the force_zero call from the
            # loop's idle branch, which bypasses the limit
            return
        depth = 0 if force_zero else self.queue_depth()
        if depth == self._depth_last_sent:
            return
        record = self._depth_record
        args = (self.node_id, depth)
        n = mig.dynamic_nbytes(list(args))
        frame = bytearray(HEADER_NBYTES + n)
        mig.pack_dynamic_into(frame, HEADER_NBYTES, list(args))
        HEADER_STRUCT.pack_into(frame, 0, MAGIC, VERSION, FLAG_DYNAMIC,
                                self.table.key_of(record.stable_name),
                                self.node_id, 0, n)
        try:
            self.endpoint.send(self._depth_dst, frame)
        except Exception:  # noqa: BLE001 — advisory traffic must never kill
            # the loop (e.g. the host endpoint is tearing down)
            return
        self._depth_last_sent = depth
        self._depth_last_t = now

    # -- data-plane hygiene --------------------------------------------------

    def _announce_buffer_freed(self, handle: int) -> None:
        """Cluster-wide free hygiene (dataplane module docs): after this
        node drops a buffer copy, whoever tracks the directory must drop
        the record and invalidate the remaining replicas — otherwise
        ``live_count`` lies and replicas leak.  On the directory holder
        (the host) this runs in-process; a worker sends its depth-report
        destination (the host) a ``_ham/buf_freed`` oneway.  A no-op in
        non-cluster domains (no directory, no report destination)."""
        if self.buffer_directory is not None:
            from repro_torch.offload.dataplane import _h_buf_freed

            token = _current_node.set(self)
            try:
                _h_buf_freed(self.node_id, handle)
            finally:
                _current_node.reset(token)
            return
        if self._depth_dst is None:
            return
        try:
            record = self.table.record_of("_ham/buf_freed")
        except Exception:  # noqa: BLE001 — table without the dataplane set
            return
        try:
            self.send_oneway(
                self._depth_dst, Function(record, (self.node_id, int(handle)))
            )
        except Exception:  # noqa: BLE001 — advisory traffic; the directory
            # reconciles at the holder's teardown
            pass

    # -- sending ------------------------------------------------------------

    def send_async(self, dst: int, function: Function) -> Future:
        msg_id, fut = self.futures.create()
        self._send_request(dst, function, msg_id)
        return fut

    def send_oneway(self, dst: int, function: Function) -> None:
        """Fire-and-forget (msg_id 0 => no reply)."""
        self._send_request(dst, function, 0)

    def _send_frame(self, dst: int, frame) -> None:
        """Transport egress: coalesced while the loop thread drains a batch,
        immediate otherwise (user threads never see queueing)."""
        cap = self._frame_cap
        if cap is not None and len(frame) > cap:
            # fail fast, HERE: parking an oversized frame in the egress queue
            # would defer the error past the handler's error-reply wrapping
            from repro_torch.core.errors import CommError

            raise CommError(
                f"frame of {len(frame)} bytes exceeds transport frame "
                f"capacity {cap}"
            )
        if self._draining and threading.get_ident() == self._loop_tid:
            self._egress.append((dst, frame))
        else:
            self.endpoint.send(dst, frame)

    def _flush_egress(self) -> None:
        if not self._egress or threading.get_ident() != self._loop_tid:
            return
        egress, self._egress = self._egress, []
        if len(egress) == 1:
            dst, frame = egress[0]
            self.endpoint.send(dst, frame)
            return
        by_dst: dict[int, list] = {}
        for dst, frame in egress:
            by_dst.setdefault(dst, []).append(frame)
        for dst, frames in by_dst.items():
            if self.fuse_egress and len(frames) > 1:
                frames = self._fuse_runs(frames)
            if len(frames) == 1:
                self.endpoint.send(dst, frames[0])
            else:
                self.endpoint.send_many(dst, frames)

    def _fusible(self, frame) -> bool:
        """May this packed egress frame fold into a fused batch?  Small and
        not itself fused.  A relayed ``_ham/forward`` inner frame (foreign
        src_node) IS fusible: its true origin travels as a ``FLAG_SEG_SRC``
        payload prefix so multi-hop topologies keep the fused win."""
        if len(frame) > HEADER_NBYTES + FUSE_THRESHOLD:
            return False
        _, _, flags, _, _, _, _ = HEADER_STRUCT.unpack_from(frame, 0)
        return not flags & FLAG_FUSED

    def _fuse_runs(self, frames: list) -> list:
        """Fold consecutive runs of fusible frames (length >= 2) into
        FLAG_FUSED frames, preserving per-destination frame order."""
        out: list = []
        run: list = []
        for frame in frames:
            if self._fusible(frame):
                run.append(frame)
                if len(run) == FUSE_MAX_SEGMENTS:
                    out.append(self._fuse_frames(run))
                    run = []
                continue
            if len(run) == 1:
                out.append(run[0])
            elif run:
                out.append(self._fuse_frames(run))
            run = []
            out.append(frame)
        if len(run) == 1:
            out.append(run[0])
        elif run:
            out.append(self._fuse_frames(run))
        return out

    def _fuse_frames(self, frames: list):
        """Rewrite N packed frames into one FLAG_FUSED frame (segment layout
        in ``core/message.py``): N-1 headers and N-1 transport publications
        amortised into one, decoded by the receiver in a single pass.

        Frames whose src_node is not this node (relayed ``_ham/forward``
        inner frames re-emitted at the forwarder) become ``FLAG_SEG_SRC``
        segments carrying their true origin as a u32 payload prefix — the
        receiver dispatches and replies against the origin, preserving the
        forward contract (final target answers the origin directly)."""
        me = self.node_id
        heads = [HEADER_STRUCT.unpack_from(f, 0) for f in frames]
        total = 4 + sum(
            len(f) - HEADER_NBYTES + SEG_NBYTES
            + (SEG_SRC_NBYTES if h[4] != me else 0)
            for f, h in zip(frames, heads)
        )
        fused = _alloc_frame(HEADER_NBYTES + total)
        HEADER_STRUCT.pack_into(fused, 0, MAGIC, VERSION, FLAG_FUSED, 0,
                                me, 0, total)
        FUSED_COUNT_STRUCT.pack_into(fused, HEADER_NBYTES, len(frames))
        off = HEADER_NBYTES + 4
        for f, (_, _, flags, key, src, msg_id, plen) in zip(frames, heads):
            if src != me:
                SEG_STRUCT.pack_into(fused, off, key, flags | FLAG_SEG_SRC,
                                     msg_id, plen + SEG_SRC_NBYTES)
                off += SEG_NBYTES
                SEG_SRC_STRUCT.pack_into(fused, off, src)
                off += SEG_SRC_NBYTES
            else:
                SEG_STRUCT.pack_into(fused, off, key, flags, msg_id, plen)
                off += SEG_NBYTES
            end = HEADER_NBYTES + plen
            fused[off : off + plen] = (
                f[HEADER_NBYTES:end] if isinstance(f, (bytes, bytearray))
                else memoryview(f)[HEADER_NBYTES:end]
            )
            off += plen
        self.stats["fused"] += len(frames)
        return fused

    def _send_request(self, dst: int, function: Function, msg_id: int,
                      extra_flags: int = 0) -> None:
        # zero-extra-copy frame assembly: the frame is allocated at its exact
        # final size and the payload packed straight in after the 32-byte
        # header.  Static-spec handlers ride the compiled WirePlan (exact
        # nbytes known up front, one fused struct call for scalar leaves);
        # dynamic handlers fall back to measured TLV.  ``extra_flags`` ORs in
        # caller bits (FLAG_RETRYABLE for deadline/retry calls).
        key = self.table.key_of(function.record.stable_name)
        plan = self._arg_plans[key]
        if plan is not None:
            n = plan.nbytes
            frame = _alloc_frame(HEADER_NBYTES + n)
            plan.pack_args(frame, HEADER_NBYTES, function.args)
            flags = FLAG_STATIC | extra_flags
        else:
            frame = n = None
            # dynamic handler: repeat shapes ride a cached WirePlan
            # (FLAG_SHAPED) — straight-line pack instead of the TLV walk
            shaped = (self._shape_cache.for_values(function.args, "A")
                      if self._shape_cache is not None else None)
            if shaped is not None:
                sig, splan = shaped
                n = SIG_LEN_NBYTES + len(sig) + splan.nbytes
                frame = _alloc_frame(HEADER_NBYTES + n)
                SIG_LEN_STRUCT.pack_into(frame, HEADER_NBYTES, len(sig))
                body = HEADER_NBYTES + SIG_LEN_NBYTES
                frame[body : body + len(sig)] = sig
                try:
                    splan.pack_args(frame, body + len(sig), function.args)
                    flags = FLAG_SHAPED | extra_flags
                except Exception:  # noqa: BLE001 — e.g. a misbehaving opaque
                    # codec; the TLV path below is always a valid encoding
                    frame = None
            if frame is None:
                args = list(function.args)
                n = mig.dynamic_nbytes(args)
                frame = _alloc_frame(HEADER_NBYTES + n)
                mig.pack_dynamic_into(frame, HEADER_NBYTES, args)
                flags = FLAG_DYNAMIC | extra_flags
        HEADER_STRUCT.pack_into(frame, 0, MAGIC, VERSION, flags, key,
                                self.node_id, msg_id, n)
        self._send_frame(dst, frame)
        self.stats["sent"] += 1

    def send_fused(self, dst: int, functions) -> list[Future]:
        """Submit many calls as ONE ``FLAG_FUSED`` frame; futures in order.

        The caller-side half of small-call fusion: one header, one transport
        publication and one receiver dispatch pass for the whole batch.  Any
        registered handler may appear (static calls plan-pack, dynamic calls
        TLV-pack into their segments); batches larger than
        ``FUSE_MAX_SEGMENTS`` split into multiple fused frames.  Replies
        resolve each call's future individually — an error in one call
        rejects only that future.

        All-or-nothing on failure: every frame is packed BEFORE anything is
        sent, and any pack/send error discards every created future (so a
        spec-violating call cannot strand earlier sub-batches' replies on
        futures the caller never received) and re-raises to the caller.
        """
        functions = list(functions)
        created = [self.futures.create() for _ in functions]
        calls = [(fn, msg_id) for fn, (msg_id, _) in zip(functions, created)]
        try:
            frames = [
                self._pack_fused_frame(calls[start : start + FUSE_MAX_SEGMENTS])
                for start in range(0, len(calls), FUSE_MAX_SEGMENTS)
            ]
            for frame in frames:
                self._send_frame(dst, frame)
        except Exception:
            # popped table entries drop any straggler reply for these ids
            for msg_id, _ in created:
                self.futures.discard(msg_id)
            raise
        self.stats["sent"] += len(calls)
        return [fut for _, fut in created]

    def _send_fused_request(self, dst: int, calls) -> None:
        """Pack ``[(function, msg_id), ...]`` into one fused frame and send."""
        self._send_frame(dst, self._pack_fused_frame(calls))
        self.stats["sent"] += len(calls)

    def send_oneway_fused(self, dst: int, functions) -> None:
        """Fire-and-forget batch as ``FLAG_FUSED`` frames: one header and
        one transport publication per ``FUSE_MAX_SEGMENTS`` calls, zero
        replies (every segment carries ``msg_id = 0``).  The oneway half of
        :meth:`send_fused` — an invalidation/gossip storm to one
        destination collapses to one frame instead of one send per call."""
        calls = [(fn, 0) for fn in functions]
        if len(calls) == 1:
            self.send_oneway(dst, calls[0][0])
            return
        for start in range(0, len(calls), FUSE_MAX_SEGMENTS):
            self._send_fused_request(dst, calls[start : start + FUSE_MAX_SEGMENTS])

    def _pack_fused_frame(self, calls):
        """One FLAG_FUSED frame for ``[(function, msg_id), ...]``."""
        key_of = self.table.key_of
        plans = self._arg_plans
        cache = self._shape_cache
        metas = []
        total = 4
        for fn, msg_id in calls:
            key = key_of(fn.record.stable_name)
            plan = plans[key]
            sig = None
            if plan is not None:
                n, flags = plan.nbytes, FLAG_STATIC
            else:
                shaped = (cache.for_values(fn.args, "A")
                          if cache is not None else None)
                if shaped is not None:
                    sig, plan = shaped
                    n = SIG_LEN_NBYTES + len(sig) + plan.nbytes
                    flags = FLAG_SHAPED
                else:
                    n, flags = mig.dynamic_nbytes(list(fn.args)), FLAG_DYNAMIC
            metas.append((key, flags, msg_id, n, plan, sig, fn.args))
            total += SEG_NBYTES + n
        frame = _alloc_frame(HEADER_NBYTES + total)
        HEADER_STRUCT.pack_into(frame, 0, MAGIC, VERSION, FLAG_FUSED, 0,
                                self.node_id, 0, total)
        FUSED_COUNT_STRUCT.pack_into(frame, HEADER_NBYTES, len(metas))
        off = HEADER_NBYTES + 4
        for key, flags, msg_id, n, plan, sig, args in metas:
            SEG_STRUCT.pack_into(frame, off, key, flags, msg_id, n)
            off += SEG_NBYTES
            if sig is not None:
                SIG_LEN_STRUCT.pack_into(frame, off, len(sig))
                frame[off + SIG_LEN_NBYTES : off + SIG_LEN_NBYTES + len(sig)] = sig
                plan.pack_args(frame, off + SIG_LEN_NBYTES + len(sig), args)
            elif plan is not None:
                plan.pack_args(frame, off, args)
            else:
                mig.pack_dynamic_into(frame, off, list(args))
            off += n
        return frame

    def send_sync(self, dst: int, function: Function, timeout: float | None = 30.0):
        if self.inline:
            return self._send_sync_inline(dst, function, timeout)
        fut = self.send_async(dst, function)
        return fut.get(timeout)

    def _send_sync_inline(self, dst: int, function: Function,
                          timeout: float | None):
        """Futureless fast path (the Fig. 3 configuration): the caller
        thread polls its endpoint for the reply — no Future allocation, no
        Event wakeup, no table lock.  Interleaved requests still execute."""
        self._sync_seq += 1
        msg_id = 0x8000_0000_0000_0000 | self._sync_seq
        self._send_request(dst, function, msg_id)
        recv = self.endpoint.recv
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            frame = recv(timeout=0.1)
            if frame is None:
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError("inline sync offload timed out")
                continue
            key, flags, src, mid, payload = decode_fast(frame)
            if flags & FLAG_FUSED:
                # our reply may ride a fused batch (the responder coalesces
                # same-destination replies): peel our segment, dispatch the
                # rest through the normal path
                mine = None
                for skey, sflags, smid, seg in iter_fused(payload):
                    if sflags & FLAG_SEG_SRC:  # relayed segment: strip prefix
                        (sseg_src,) = SEG_SRC_STRUCT.unpack_from(seg, 0)
                        seg = seg[SEG_SRC_NBYTES:]
                        sflags &= ~FLAG_SEG_SRC
                    else:
                        sseg_src = src
                    if mine is None and sflags & FLAG_REPLY and smid == msg_id:
                        mine = (skey, sflags, seg)
                    else:
                        self._handle_one(skey, sflags, sseg_src, smid, seg, True)
                if mine is None:
                    continue
                return self._finish_sync_reply(*mine)
            if flags & FLAG_REPLY and mid == msg_id:
                return self._finish_sync_reply(key, flags, payload)
            self._handle_frame(frame)

    def _finish_sync_reply(self, key, flags, payload):
        """Inline-sync tail: same decode as the event loop (_decode_reply),
        raised instead of routed through a future."""
        value, err = self._decode_reply(key, flags, payload)
        if err is not None:
            from repro_torch.core.errors import RemoteExecutionError

            raise RemoteExecutionError(err[0], err[1])
        return value

    def _inline_wait(self, fut: Future, timeout: float | None):
        """Caller-thread polling: the lowest-latency mode (no wakeup hop).
        Interleaved inbound requests are still served, so reverse offload
        works even in inline mode."""
        # a handler waiting mid-batch must not deadlock on its own parked
        # egress (e.g. a request it just sent): push it out before blocking
        self._flush_egress()
        deadline = None if timeout is None else time.monotonic() + timeout
        while not fut.done():
            frame = self.endpoint.recv(timeout=0.1)
            if frame is not None:
                self._handle_frame(frame)
                self._flush_egress()
            elif deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("inline sync offload timed out")
        return fut.get(0)

    def wait(self, fut: Future, timeout: float | None = 30.0):
        """Cooperatively wait on a future *from handler context*.

        With the Direct execution policy the handler runs on the event-loop
        thread; plain ``fut.get()`` there would deadlock (the loop cannot pump
        the reply).  ``wait`` keeps servicing inbound frames while blocked —
        the cooperative-runtime pattern the paper's execution policies enable.
        With a thread-pool policy, plain ``fut.get()`` is also fine.
        """
        return self._inline_wait(fut, timeout)

    # -- receiving ------------------------------------------------------------

    def _handle_frame(self, frame, owned: bool = True) -> None:
        # hot path: the paper's metric is exactly this function's cost.
        # ``owned=False`` marks a leased transport view: anything escaping
        # this call (futures, deferred execution) must copy first.
        key, flags, src, msg_id, payload = decode_fast(frame)
        if flags & FLAG_FUSED:
            self._handle_fused(src, payload, owned)
        else:
            self._handle_one(key, flags, src, msg_id, payload, owned)

    def _handle_one(self, key, flags, src, msg_id, payload, owned) -> None:
        """Dispatch one logical message (a standalone frame's decode or one
        fused segment)."""
        if flags & FLAG_REPLY:
            self.stats["replies"] += 1
            if not owned:
                payload = bytes(payload)  # escapes into the future table
            value, err = self._decode_reply(key, flags, payload)
            if err is None:
                self.futures.resolve(msg_id, value)
            else:
                self.futures.reject(msg_id, err[0], err[1])
            return
        try:
            record = self._records[key]
            plan = self._arg_plans[key]
        except IndexError:
            self.table.handler_at(key)  # raises the same-source diagnostic
            raise
        if type(self.policy) is DirectPolicy:  # skip the closure on the hot path
            # executes before the lease is released — views are safe in place
            self._execute(record, plan, key, flags, src, msg_id, payload)
        else:
            if not owned:
                payload = bytes(payload)  # outlives the drain iteration
            self.policy.submit(lambda: self._execute(record, plan, key, flags,
                                                     src, msg_id, payload))

    def _handle_fused(self, src, payload, owned) -> None:
        """One FLAG_FUSED frame => N logical messages, one dispatch pass.

        Replies resolve inline (cheap, and futures are thread-safe);
        request segments execute in order — for a pooled policy all of them
        ride a single ``submit`` (the single-executor-pass contract), so a
        fused batch costs one task switch, not N.
        """
        direct = type(self.policy) is DirectPolicy
        if not owned and not direct:
            # one copy for the whole batch (deferred segments outlive the
            # lease); direct execution stays in place and reply segments
            # are copied individually by _handle_one
            payload = memoryview(bytes(payload))
            owned = True
        # a fused frame often arrives as a singleton drain batch (which runs
        # undrained for latency): park this batch's replies regardless so
        # they flush as ONE fused reply frame — fusion's return half
        restore_drain = (
            direct and not self._draining
            and threading.get_ident() == self._loop_tid
        )
        if restore_drain:
            self._draining = True
        deferred = None
        # one contextvar bracket for the whole batch (direct policy executes
        # segments inline here) — ~0.4 us per call saved at fusion densities
        token = _current_node.set(self) if direct else None
        try:
            for key, flags, msg_id, seg in iter_fused(payload):
                if flags & FLAG_SEG_SRC:
                    # relayed segment: true origin rides a u32 payload prefix
                    # (relay-aware fusion — see core/message.py); dispatch
                    # and reply against the origin, exactly as the unfused
                    # _ham/forward inner frame would have
                    (seg_src,) = SEG_SRC_STRUCT.unpack_from(seg, 0)
                    seg = seg[SEG_SRC_NBYTES:]
                    flags &= ~FLAG_SEG_SRC
                else:
                    seg_src = src
                if flags & FLAG_REPLY:
                    self._handle_one(key, flags, seg_src, msg_id, seg, owned)
                    continue
                try:
                    record = self._records[key]
                    plan = self._arg_plans[key]
                except IndexError:
                    self.table.handler_at(key)
                    raise
                if direct:
                    self._execute_gated(record, plan, key, flags, seg_src,
                                        msg_id, seg)
                else:
                    if deferred is None:
                        deferred = []
                    deferred.append((record, plan, key, flags, seg_src,
                                     msg_id, seg))
        finally:
            if token is not None:
                _current_node.reset(token)
            if restore_drain:
                self._draining = False
                self._flush_egress()
        if deferred:
            def _run_batch(batch=deferred):
                for item in batch:
                    self._execute(*item)
            self.policy.submit(_run_batch)

    def _decode_reply(self, key, flags, payload):
        """Shared reply decode (event loop AND inline-sync path): returns
        ``(value, None)`` or ``(None, (msg, tb))`` for an error reply.

        ``FLAG_STATIC`` selects the handler's compiled result plan;
        ``FLAG_SHAPED`` decodes through the shape cache (signature-keyed
        plan); error replies and un-flagged replies (pre-plan peers) are
        dynamic TLV.
        """
        if flags & FLAG_ERROR:
            err = mig.unpack_dynamic(payload)
            return None, (err["msg"], err.get("tb", ""))
        if flags & FLAG_SHAPED:
            cache = self._shape_cache
            if cache is None:
                cache = self._shape_cache = ShapeCache()
            return cache.unpack_shaped(payload, expect_args=False), None
        if flags & FLAG_STATIC:
            try:
                plan = self._result_plans[key]
            except IndexError:
                plan = None
            if plan is None:
                raise MessageFormatError(
                    f"STATIC reply for key {key} but no local result plan; "
                    "peer key maps diverge (same-source assumption violated)"
                )
            return plan.unpack_result(payload), None
        return mig.unpack_dynamic(payload), None

    def _execute(self, record, plan, key, flags, src, msg_id, payload) -> None:
        token = _current_node.set(self)  # policy may run on a pool thread
        try:
            self._execute_gated(record, plan, key, flags, src, msg_id, payload)
        finally:
            _current_node.reset(token)

    def _execute_gated(self, record, plan, key, flags, src, msg_id,
                       payload) -> None:
        """:meth:`_execute` minus the contextvar bracket (a fused batch sets
        the contextvar once around its whole segment loop)."""
        # exactly-once gate: a FLAG_RETRYABLE request may be a sender
        # retransmission.  First sighting marks the key in-progress and
        # executes; a duplicate with the reply already cached resends that
        # frame verbatim; a duplicate still in flight is dropped (the reply
        # of the in-progress execution answers both).  Fault-free cost is
        # one flags test — non-retryable calls never touch the cache.
        retry_key = None
        if flags & FLAG_RETRYABLE and msg_id:
            cached = self.replay.begin(src, msg_id)
            if cached is not None:
                if cached is not ReplayCache.IN_PROGRESS:
                    self.stats["replayed"] += 1
                    self._send_frame(src, cached)
                return
            retry_key = (src, msg_id)
        self._execute_in_ctx(record, plan, key, flags, src, msg_id,
                             payload, retry_key)

    def _execute_in_ctx(self, record, plan, key, flags, src, msg_id, payload,
                        retry_key) -> None:
        """Decode, run the handler, and reply — the innermost execute step
        (contextvar and replay gate handled by the callers above)."""
        self.stats["handled"] += 1
        try:
            # wire compat: a pre-plan peer sends static payloads with no
            # flag bits — the plan decodes them regardless (identical
            # layout); FLAG_DYNAMIC forces the TLV path either way
            if flags & FLAG_SHAPED:
                args = self._shaped_args(payload)
            elif plan is not None and not flags & FLAG_DYNAMIC:
                args = plan.unpack_args(payload)
            else:
                args = tuple(mig.unpack_dynamic(payload))
            result = record.fn(*args)
        except Exception as e:  # noqa: BLE001 — remote errors must travel
            self.stats["errors"] += 1
            if msg_id:
                frame = self._send_reply(
                    src, key, msg_id,
                    {"msg": f"{type(e).__name__}: {e}",
                     "tb": traceback.format_exc()},
                    FLAG_REPLY | FLAG_ERROR)
                if retry_key:
                    self.replay.commit(src, msg_id, bytes(frame))
            return
        if msg_id:
            try:
                frame = self._send_reply(src, key, msg_id, result,
                                         FLAG_REPLY,
                                         self._result_plans[key])
            except Exception as e:  # noqa: BLE001 — e.g. reply exceeds the
                # transport frame limit, or the result violates the
                # handler's declared result spec: the caller must get an
                # error, not a dead worker and a timeout
                self.stats["errors"] += 1
                frame = self._send_reply(
                    src, key, msg_id,
                    {"msg": f"{type(e).__name__}: {e}",
                     "tb": traceback.format_exc()},
                    FLAG_REPLY | FLAG_ERROR,
                )
            if retry_key:
                self.replay.commit(src, msg_id, bytes(frame))

    def _shaped_args(self, payload) -> tuple:
        """Decode a FLAG_SHAPED request payload to an args tuple.  A receiver
        with the cache disabled still decodes shaped frames (the flag is a
        wire format, not a capability negotiation) through a lazily created
        cache."""
        cache = self._shape_cache
        if cache is None:
            cache = self._shape_cache = ShapeCache()
        return cache.unpack_shaped(payload, expect_args=True)

    def _send_reply(self, dst: int, key: int, msg_id: int, result, flags,
                    plan=None):
        if plan is not None and not flags & FLAG_ERROR:
            # static result fast path: exact-size frame, plan-packed payload
            n = plan.nbytes
            frame = _alloc_frame(HEADER_NBYTES + n)
            plan.pack_result(frame, HEADER_NBYTES, result)
            flags |= FLAG_STATIC
        else:
            frame = None
            if not flags & FLAG_ERROR and self._shape_cache is not None:
                # dynamic-handler reply: repeat shapes ride a cached plan
                # (FLAG_SHAPED) exactly like shaped requests
                shaped = self._shape_cache.for_result(result)
                if shaped is not None:
                    sig, splan = shaped
                    values = result if isinstance(result, tuple) else (result,)
                    n = SIG_LEN_NBYTES + len(sig) + splan.nbytes
                    frame = _alloc_frame(HEADER_NBYTES + n)
                    SIG_LEN_STRUCT.pack_into(frame, HEADER_NBYTES, len(sig))
                    body = HEADER_NBYTES + SIG_LEN_NBYTES
                    frame[body : body + len(sig)] = sig
                    try:
                        splan.pack_args(frame, body + len(sig), values)
                        flags |= FLAG_SHAPED
                    except Exception:  # noqa: BLE001 — fall back to TLV
                        frame = None
            if frame is None:
                n = mig.dynamic_nbytes(result)
                frame = _alloc_frame(HEADER_NBYTES + n)
                mig.pack_dynamic_into(frame, HEADER_NBYTES, result)
                flags |= FLAG_DYNAMIC
        HEADER_STRUCT.pack_into(frame, 0, MAGIC, VERSION, flags,
                                key, self.node_id, msg_id, n)
        self._send_frame(dst, frame)
        return frame

    # -- event loop -----------------------------------------------------------

    def run(self, poll_timeout: float = 0.1) -> None:
        """Batch-drain event loop: pull up to ``_DRAIN_BATCH`` frames per
        ``recv_many``, dispatch them (decoding in place from leased views on
        zero-copy transports), release the lease, then flush the coalesced
        egress — one transport publication per drain iteration."""
        ep = self.endpoint
        leased = getattr(ep, "zero_copy_recv", False)
        self._loop_tid = threading.get_ident()
        while not self._stop.is_set():
            frames = ep.recv_many(_DRAIN_BATCH, timeout=poll_timeout)
            if not frames:
                # idle: retract any stale busy signal so the scheduler does
                # not keep routing around a worker that already drained
                self._maybe_report_depth(force_zero=True)
                continue
            self.stats["batches"] += 1
            # singleton batches (the latency-sensitive ping-pong case) skip
            # the egress parking: there is nothing to coalesce a lone reply
            # with, and the park+flush detour costs ~1us per round trip
            self._draining = len(frames) > 1
            self._batch_remaining = len(frames)
            report_depth = self._depth_dst is not None
            try:
                for frame in frames:
                    if report_depth:
                        # report BEFORE executing: a long handler must not
                        # hide the queue that is forming behind it
                        self._maybe_report_depth()
                    try:
                        self._handle_frame(frame, owned=not leased)
                    except Exception:  # noqa: BLE001 — a poison frame must
                        # not kill the event loop (remaining frames, futures
                        # and peers all depend on it staying alive)
                        self.stats["errors"] += 1
                        traceback.print_exc()
                    self._batch_remaining -= 1
            finally:
                self._draining = False
                self._batch_remaining = 0
                # drop frame refs BEFORE blocking in the next recv_many:
                # holding them would pin pooled frame buffers (and leased
                # ring space) across the idle wait
                frame = frames = None
                ep.release()  # return window space before the egress flush
                try:
                    self._flush_egress()
                except Exception:  # noqa: BLE001 — a failed send must not
                    # take down the loop; peers/futures depend on it
                    self.stats["errors"] += 1
                    traceback.print_exc()

    def start(self) -> "NodeRuntime":
        if self.inline:
            raise OffloadError("inline runtimes poll from the caller thread")
        self._thread = threading.Thread(
            target=self.run, name=f"ham-node-{self.node_id}", daemon=True
        )
        self._thread.start()
        return self

    def request_stop(self) -> None:
        self._stop.set()

    def stop(self, timeout: float = 5.0) -> None:
        self.request_stop()
        if self._thread is not None:
            self._thread.join(timeout)
        n = self.futures.fail_all(NodeDownError(f"node {self.node_id} stopped"))
        if n:
            self.stats["errors"] += n
