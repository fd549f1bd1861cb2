"""Shared-memory fabric: SPSC byte rings between processes.

The analogue of the paper's SCIF / VEO-DMA backends: a pre-mapped shared
window written with plain stores, no per-message syscalls, no serialisation
beyond HAM's own bitwise payload copy.  One directed ring per ordered node
pair; single producer, single consumer.

Ring layout in the shared segment::

    [ head u64 | head' u64 | tail u64 | tail' u64 | data bytes ... ]

``head``/``tail`` are *monotonic* byte counters (never wrapped), which makes
full/empty unambiguous: used = head - tail.  The producer writes payload
first, then publishes by storing ``head``.

Counter stores are NOT assumed atomic.  CPython's ``struct.pack_into`` /
``unpack_from`` on a shared mapping can tear an 8-byte value (measured: a
cross-process reader spinning on a counter observes mixed-byte values a few
times per million updates — a native host port would use C++ atomics with
release/acquire).  Each counter is therefore published twice — primary then
confirm copy (``head'``/``tail'``) — and a reader rereads until confirm ==
primary.  Because the counters are monotonic, accepting a stale matching
pair is always conservative (the consumer sees less data, the producer sees
less free space — never the unsafe direction), and a torn read cannot match
its independently-loaded confirm copy.

Frames inside the ring are ``u64 length || bytes`` with wrap-around; a
coalesced batch is just the concatenation of such segments (see
``repro_torch.core.message`` for the batched-frame layout).

Zero-copy hot path and the lease protocol
-----------------------------------------

The per-frame copying API (``push`` of caller bytes, ``try_pop`` returning a
fresh ``bytes``) is kept for compatibility, but the hot path is copy-free in
both directions:

* **push / push_many** write straight from any buffer-protocol object into
  the mapped window (length prefix packed in place, payload memcpy'd via
  memoryview slice assignment — no intermediate ``bytes(frame)``).
  ``push_many`` writes N frames and publishes ``head`` once.

* **try_pop_view / pop_many** return :class:`RingLease` objects whose
  ``views`` are memoryviews *into the ring* (frames that straddle the wrap
  boundary are the one exception: they are reassembled into a scratch
  buffer, since a Python memoryview cannot be discontiguous).  The consumed
  region is NOT returned to the producer until the lease is explicitly
  ``release()``d — that is the entire contract: a view is valid exactly as
  long as its lease.  ``pop_many`` covers N frames with a single lease, so
  ``tail`` is stored once per batch.

Leases must be released in pop order (FIFO): releasing a younger lease while
an older one is outstanding raises :class:`CommError` — out-of-order release
would either tear a hole in the ring or silently re-expose unread bytes.
Internally the copying ``try_pop`` may run while leases are outstanding
(e.g. a handler doing a nested recv during a batch drain); it reads at the
ring's private read cursor and defers its own tail advance until the older
leases resolve.

Memory-ordering assumptions of the zero-copy path (documented, not checked):

* SPSC — exactly one producer and one consumer attach to each ring, so
  ``head`` is only stored by the producer and ``tail`` only by the consumer.
* TSO (x86-64): stores become visible in program order, so frame bytes are
  visible before the ``head`` primary, which is visible before the confirm
  copy; a reader that observes ``head' == head`` therefore observes every
  byte below it.  The double-word protocol above covers the one assumption
  TSO does not give pure Python: single-store atomicity of the counters.
* The consumer additionally sanity-checks every frame boundary against the
  accepted ``head`` (length nonzero, within capacity, frame fully below
  ``head``) and treats violations as "not yet published" — a belt-and-
  braces stop rather than a walk into unwritten memory.
* A leased view is stable because the producer cannot advance past ``tail``,
  and ``tail`` only moves on release.
"""

from __future__ import annotations

import struct
import time
from collections import deque
from dataclasses import dataclass, field
from multiprocessing import shared_memory

from repro_torch.comm.base import CommBackend, Fabric, as_byte_view as _as_view
from repro_torch.comm.doorbell import Doorbell, bell_name, futex_available
from repro_torch.core.errors import CommError

# Counter block layout and publication discipline.  Single source of truth
# shared with the exhaustive-interleaving model (the reference's
# ``repro.analysis.models.ring_counters``): the model's load/store routines
# are generated from this discipline, so weakening it here (e.g. dropping the
# confirm copy that closes the torn-counter window) weakens the model and the
# checker reports the frame-boundary corruption.
HEAD_OFF = 0
HEAD_CONFIRM_OFF = 8
TAIL_OFF = 16
TAIL_CONFIRM_OFF = 24
#: byte distance from a counter's primary word to its confirm copy
COUNTER_CONFIRM_STRIDE = 8
#: reader re-reads until primary == confirm, up to this many times, then
#: falls back to min(primary, confirm) — conservative for monotonic counters
COUNTER_STABLE_RETRIES = 10000
#: writer order in ``_store_counter``: primary word first, confirm last
COUNTER_STORE_ORDER = ("primary", "confirm")
#: reader order in ``_load_counter``: the confirm copy (stored last) is
#: loaded FIRST, so primary == confirm proves the pair was stable across
#: both loads; the model executes its loads in exactly this order
COUNTER_LOAD_ORDER = ("confirm", "primary")

_HDR = 32  # head u64 + head-confirm u64 + tail u64 + tail-confirm u64
_U64 = struct.Struct("<Q")

# segments whose close() found still-exported lease views; kept alive so the
# stdlib finaliser does not raise into the void (see ShmRing.close)
_leaked_segments: list = []


class RingLease:
    """Consumer-side lease over one contiguous run of popped frames.

    ``views`` hold the frame bytes (zero-copy into the ring except for
    wrap-straddling frames).  ``release()`` returns the region to the
    producer; it must be called in pop order.
    """

    __slots__ = ("_ring", "end", "views", "released")

    def __init__(self, ring: "ShmRing", end: int, views: list):
        self._ring = ring
        self.end = end  # monotonic ring offset one past the last frame
        self.views = views
        self.released = False

    @property
    def view(self) -> memoryview:
        """The single frame of a one-frame lease (try_pop_view result)."""
        return self.views[0]

    def release(self) -> None:
        self._ring._release(self, strict=True)


class ShmRing:
    """One directed SPSC ring over a named shared-memory segment."""

    def __init__(self, name: str, capacity: int = 1 << 24, create: bool = False):
        self.capacity = capacity
        if create:
            self._shm = shared_memory.SharedMemory(
                name=name, create=True, size=_HDR + capacity
            )
            self._shm.buf[:_HDR] = b"\x00" * _HDR
        else:
            self._shm = shared_memory.SharedMemory(name=name)
            self.capacity = self._shm.size - _HDR
        self._buf = self._shm.buf
        self.name = name
        # consumer-side lease state: outstanding leases in pop order, plus a
        # private read cursor (>= tail) marking the next unread frame
        self._segments: deque[RingLease] = deque()
        self._next_read = 0

    # -- counters ----------------------------------------------------------
    # Double-word publication (see module docstring): primary at `off`,
    # confirm copy at `off + 8`.  pack_into/unpack_from on shared memory can
    # tear 8-byte values, so a value only counts once primary == confirm.

    def _load_counter(self, off: int) -> int:
        buf = self._buf
        stride = COUNTER_CONFIRM_STRIDE
        for _ in range(COUNTER_STABLE_RETRIES):
            (confirm,) = _U64.unpack_from(buf, off + stride)  # stored last
            (primary,) = _U64.unpack_from(buf, off)           # stored first
            if primary == confirm:
                return primary
            time.sleep(0)  # writer mid-publish: sub-microsecond window
        # writer stalled between the two stores (e.g. preempted for a long
        # time): the smaller of the pair is the older value — conservative
        # in both directions for monotonic counters
        return min(primary, confirm)

    def _store_counter(self, off: int, v: int) -> None:
        _U64.pack_into(self._buf, off, v)
        _U64.pack_into(self._buf, off + COUNTER_CONFIRM_STRIDE, v)

    def _head(self) -> int:
        return self._load_counter(HEAD_OFF)

    def _tail(self) -> int:
        return self._load_counter(TAIL_OFF)

    def _set_head(self, v: int) -> None:
        self._store_counter(HEAD_OFF, v)

    def _set_tail(self, v: int) -> None:
        self._store_counter(TAIL_OFF, v)

    def _read_pos(self) -> int:
        """Next unread offset: the cursor while leases are outstanding,
        otherwise the shared ``tail`` (cursor == tail at quiescence)."""
        return self._next_read if self._segments else self._tail()

    # -- data movement -----------------------------------------------------

    def _write_view(self, pos: int, mv: memoryview) -> int:
        """memcpy ``mv`` at ring offset pos (monotonic), handling wrap."""
        off = pos % self.capacity
        n = mv.nbytes
        first = min(n, self.capacity - off)
        base = _HDR
        self._buf[base + off : base + off + first] = mv[:first]
        if first < n:
            self._buf[base : base + n - first] = mv[first:]
        return pos + n

    def _write_u64(self, pos: int, value: int) -> int:
        off = pos % self.capacity
        if off + 8 <= self.capacity:
            _U64.pack_into(self._buf, _HDR + off, value)
            return pos + 8
        return self._write_view(pos, memoryview(_U64.pack(value)))

    def _read_u64(self, pos: int) -> int:
        off = pos % self.capacity
        if off + 8 <= self.capacity:
            return _U64.unpack_from(self._buf, _HDR + off)[0]
        return _U64.unpack(bytes(self._read_copy(pos, 8)))[0]

    def _read_copy(self, pos: int, n: int) -> bytearray:
        off = pos % self.capacity
        base = _HDR
        first = min(n, self.capacity - off)
        out = bytearray(n)
        out[:first] = self._buf[base + off : base + off + first]
        if first < n:
            out[first:] = self._buf[base : base + n - first]
        return out

    def _frame_view(self, start: int, n: int) -> memoryview:
        """Zero-copy view of [start, start+n) when contiguous; a scratch copy
        when the frame straddles the wrap boundary."""
        off = start % self.capacity
        if off + n <= self.capacity:
            return self._buf[_HDR + off : _HDR + off + n]
        return memoryview(self._read_copy(start, n))

    # -- producer side -----------------------------------------------------

    def _wait_space(self, head: int, need: int, deadline) -> None:
        while self.capacity - (head - self._tail()) < need:
            if deadline is not None and time.monotonic() > deadline:
                raise CommError("ring full: consumer stalled")
            time.sleep(0)  # yield; SPSC spin

    def push(self, frame, timeout: float | None = None) -> None:
        mv = _as_view(frame)
        need = 8 + mv.nbytes
        if need > self.capacity:
            raise CommError(
                f"frame of {mv.nbytes} bytes exceeds ring capacity {self.capacity}"
            )
        deadline = None if timeout is None else time.monotonic() + timeout
        head = self._head()
        self._wait_space(head, need, deadline)
        pos = self._write_u64(head, mv.nbytes)
        pos = self._write_view(pos, mv)
        self._set_head(pos)  # publish

    def push_many(self, frames, timeout: float | None = None) -> None:
        """Write N frames, publishing ``head`` once per sub-batch.

        Batches larger than the ring are split greedily; each sub-batch is
        one counter store.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        batch: list[memoryview] = []
        batch_need = 0
        for frame in frames:
            mv = _as_view(frame)
            need = 8 + mv.nbytes
            if need > self.capacity:
                raise CommError(
                    f"frame of {mv.nbytes} bytes exceeds ring capacity "
                    f"{self.capacity}"
                )
            if batch and batch_need + need > self.capacity:
                self._push_batch(batch, batch_need, deadline)
                batch, batch_need = [], 0
            batch.append(mv)
            batch_need += need
        if batch:
            self._push_batch(batch, batch_need, deadline)

    # below this total size a batch is joined into one contiguous segment
    # before the ring write: for small frames one join + one memcpy beats
    # 2N slice-assigns (the join copy is noise next to the saved Python ops)
    _JOIN_LIMIT = 1 << 16

    def _push_batch(self, views: list[memoryview], need: int, deadline) -> None:
        head = self._head()
        self._wait_space(head, need, deadline)
        if need <= self._JOIN_LIMIT and len(views) > 1:
            parts: list = []
            append = parts.append
            pack = _U64.pack
            for mv in views:
                append(pack(mv.nbytes))
                append(mv)
            pos = self._write_view(head, memoryview(b"".join(parts)))
        else:
            pos = head
            for mv in views:
                pos = self._write_u64(pos, mv.nbytes)
                pos = self._write_view(pos, mv)
        self._set_head(pos)  # single publish for the whole batch

    # -- consumer side -----------------------------------------------------

    def _frame_len_checked(self, pos: int, head: int) -> int | None:
        """Length of the frame at ``pos``, or None if the bytes there do not
        describe a fully-published frame below ``head`` (belt-and-braces
        against counter tears; see module docstring)."""
        n = self._read_u64(pos)
        if n == 0 or n > self.capacity - 8 or pos + 8 + n > head:
            return None
        return n

    def try_pop_view(self) -> RingLease | None:
        """Zero-copy pop: a one-frame lease, or ``None`` if empty."""
        pos = self._read_pos()
        head = self._head()
        if head == pos:
            return None
        n = self._frame_len_checked(pos, head)
        if n is None:
            return None
        end = pos + 8 + n
        lease = RingLease(self, end, [self._frame_view(pos + 8, n)])
        self._segments.append(lease)
        self._next_read = end
        return lease

    def pop_many(self, max_frames: int = 64) -> RingLease | None:
        """Pop up to ``max_frames`` under ONE lease (one eventual tail store)."""
        pos = self._read_pos()
        head = self._head()
        if pos == head:
            return None
        # hot loop: locals + inlined view slicing (no per-frame method calls)
        buf = self._buf
        cap = self.capacity
        unpack_from = _U64.unpack_from
        views: list[memoryview] = []
        append = views.append
        while pos != head and len(views) < max_frames:
            off = pos % cap
            if off + 8 <= cap:
                (n,) = unpack_from(buf, _HDR + off)
            else:
                (n,) = _U64.unpack(bytes(self._read_copy(pos, 8)))
            if n == 0 or n > cap - 8 or pos + 8 + n > head:
                break  # not a fully-published frame: stop, retry next poll
            start = pos + 8
            soff = start % cap
            if soff + n <= cap:
                append(buf[_HDR + soff : _HDR + soff + n])
            else:
                append(memoryview(self._read_copy(start, n)))
            pos = start + n
        if not views:
            return None
        lease = RingLease(self, pos, views)
        self._segments.append(lease)
        self._next_read = pos
        return lease

    def _release(self, lease: RingLease, strict: bool) -> None:
        if lease.released:
            raise CommError("ring lease released twice")
        if strict and (not self._segments or self._segments[0] is not lease):
            raise CommError(
                "ring lease released out of order: an older lease is still "
                "outstanding (leases are FIFO)"
            )
        lease.released = True
        # advance tail over the longest released prefix (deferred releases
        # from nested copying pops resolve here)
        new_tail = None
        while self._segments and self._segments[0].released:
            new_tail = self._segments.popleft().end
        if new_tail is not None:
            self._set_tail(new_tail)

    def try_pop(self):
        """Compatibility pop: one owned frame (copied out of the ring)."""
        if not self._segments:
            # fast path: no outstanding leases, advance tail directly
            pos = self._tail()
            head = self._head()
            if head == pos:
                return None
            n = self._frame_len_checked(pos, head)
            if n is None:
                return None
            off = (pos + 8) % self.capacity
            if off + n <= self.capacity:
                frame = bytes(self._buf[_HDR + off : _HDR + off + n])
            else:
                frame = bytes(self._read_copy(pos + 8, n))
            self._set_tail(pos + 8 + n)
            return frame
        # leases outstanding (nested pop during a batch drain): read at the
        # cursor and defer the tail advance behind the older leases
        lease = self.try_pop_view()
        if lease is None:
            return None
        frame = bytes(lease.view)
        self._release(lease, strict=False)
        return frame

    def pending_frame_count(self, max_count: int = 32) -> int:
        """Consumer-side count of fully-published, unread frames (capped at
        ``max_count`` — this feeds queue-depth *estimates*, not accounting).
        Read-only walk over the length prefixes; safe under SPSC."""
        pos = self._read_pos()
        head = self._head()
        count = 0
        while pos != head and count < max_count:
            n = self._frame_len_checked(pos, head)
            if n is None:
                break
            pos += 8 + n
            count += 1
        return count

    def drop_pending(self) -> None:
        """Discard every queued-but-unconsumed frame (tail := head).

        Only safe while the ring's consumer is not running — used by the
        fabric before attaching a *replacement* consumer process: frames
        addressed to the dead worker were already failed by the failure
        detector, so redelivering them would resurrect cancelled calls.
        """
        self._segments.clear()
        self._next_read = 0
        self._set_tail(self._head())

    def close(self) -> None:
        self._segments.clear()
        self._buf = None
        try:
            self._shm.close()
        except BufferError:
            # a leased view still references the mapping; keep the segment
            # object alive (the OS reclaims the mapping at process exit)
            # rather than crash teardown or warn from a doomed __del__
            _leaked_segments.append(self._shm)

    def unlink(self) -> None:
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass


def _ring_name(prefix: str, src: int, dst: int) -> str:
    return f"{prefix}_{src}_{dst}"


def _default_spin_budget() -> int:
    # On a single-core host hot-spinning only delays the sender (time.sleep(0)
    # does not yield the GIL-holder's core), so park almost immediately; with
    # real parallelism a short spin window converts same-core-park latency
    # into sub-microsecond pickup for back-to-back frames.
    import os

    return 2048 if (os.cpu_count() or 1) > 1 else 64


@dataclass(frozen=True)
class RingConfig:
    """Tunables for the receiver wakeup path (one home for the former
    hardcoded ``2048`` spin / ``1e-4`` sleep constants).

    ``spin_budget`` polls happen before the endpoint either parks on its
    doorbell (futex available) or falls back to sleeping ``sleep_quantum``
    per miss.  ``park_timeout`` bounds each futex park so the documented
    lost-wakeup races degrade to latency, never to a hang.  Tests force the
    park path deterministically with ``spin_budget=0``.
    """

    spin_budget: int = field(default_factory=_default_spin_budget)
    sleep_quantum: float = 1e-4
    park_timeout: float = 2e-3
    use_doorbell: bool = True

    def as_dict(self) -> dict:
        """JSON-serialisable form for worker spawn specs."""
        return {
            "spin_budget": self.spin_budget,
            "sleep_quantum": self.sleep_quantum,
            "park_timeout": self.park_timeout,
            "use_doorbell": self.use_doorbell,
        }

    @classmethod
    def from_dict(cls, d: dict | None) -> "RingConfig":
        return cls(**d) if d else cls()


class ShmEndpoint(CommBackend):
    """Attaches to the rings of one node: n-1 inbound, n-1 outbound.

    ``recv_many`` hands out leased zero-copy views (``zero_copy_recv`` is
    set); callers return the window space with ``release()``.

    ``peers`` names the member node ids to attach rings for (defaults to the
    dense ``range(num_nodes)``); an elastic fabric with holes after
    ``remove_node`` must pass its live set, since rings for retired ids no
    longer exist.  ``attach_peer``/``detach_peer`` adjust the ring set of a
    *running* endpoint when membership changes.
    """

    zero_copy_recv = True

    def __init__(self, prefix: str, node_id: int, num_nodes: int, peers=None,
                 config: RingConfig | None = None):
        self.node_id = node_id
        self.num_nodes = num_nodes
        self._prefix = prefix
        self.config = config or RingConfig()
        if peers is None:
            peers = range(num_nodes)
        peers = [p for p in peers if p != node_id]
        self._out = {dst: ShmRing(_ring_name(prefix, node_id, dst)) for dst in peers}
        self._in = {src: ShmRing(_ring_name(prefix, src, node_id)) for src in peers}
        self._rr = sorted(self._in)  # round-robin poll order
        self._leases: list[RingLease] = []  # issued by recv_many, unreleased
        # Doorbells: ours to park on, one per peer to ring after a push.
        # Attach-by-name so forked and fresh-interpreter workers both work;
        # a fabric predating doorbells has no segments and we degrade to the
        # adaptive-spin path (bell is None).
        self._bell = self._attach_bell(node_id)
        self._peer_bells = {dst: self._attach_bell(dst) for dst in peers}
        self._refresh_frame_cap()

    def _attach_bell(self, node: int) -> Doorbell | None:
        if not (self.config.use_doorbell and futex_available()):
            return None
        try:
            return Doorbell(bell_name(self._prefix, node))
        except FileNotFoundError:
            return None

    def _refresh_frame_cap(self) -> None:
        # a frame must fit one ring (8-byte length prefix included)
        self.max_frame_nbytes = (
            min(r.capacity for r in self._out.values()) - 8 if self._out else None
        )

    def _check_dst(self, dst: int) -> None:
        if dst == self.node_id or dst not in self._out:
            raise CommError(
                f"invalid destination {dst} (node {self.node_id}; peers "
                f"{sorted(self._out)})"
            )

    def attach_peer(self, node_id: int) -> None:
        """Open the ring pair toward a newly added member (the fabric owner
        must have created the segments already)."""
        if node_id == self.node_id or node_id in self._out:
            return
        self._out[node_id] = ShmRing(_ring_name(self._prefix, self.node_id, node_id))
        self._in[node_id] = ShmRing(_ring_name(self._prefix, node_id, self.node_id))
        self._peer_bells[node_id] = self._attach_bell(node_id)
        self._rr = sorted(self._in)
        self.num_nodes = max(self.num_nodes, node_id + 1)
        self._refresh_frame_cap()

    def detach_peer(self, node_id: int) -> None:
        """Close this endpoint's ring pair toward a retired member.  Later
        sends toward the id fail fast (``_check_dst``)."""
        out = self._out.pop(node_id, None)
        inn = self._in.pop(node_id, None)
        bell = self._peer_bells.pop(node_id, None)
        self._rr = sorted(self._in)
        for ring in (out, inn):
            if ring is not None:
                ring.close()
        if bell is not None:
            bell.close()
        if out is not None:
            self._refresh_frame_cap()

    def _out_ring(self, dst: int) -> ShmRing:
        """Outbound ring for ``dst``, raising CommError (the documented
        retired-peer contract) when a concurrent detach_peer removed or
        closed it between the destination check and the push."""
        self._check_dst(dst)
        ring = self._out.get(dst)
        if ring is None or ring._buf is None:
            raise CommError(f"destination {dst} was removed from the fabric")
        return ring

    def send(self, dst: int, frame) -> None:
        try:
            self._out_ring(dst).push(frame)
        except (TypeError, ValueError) as e:  # ring closed mid-push
            raise CommError(f"peer {dst} detached during send") from e
        bell = self._peer_bells.get(dst)
        if bell is not None:
            bell.ring()

    def send_many(self, dst: int, frames) -> None:
        try:
            self._out_ring(dst).push_many(frames)
        except (TypeError, ValueError) as e:
            raise CommError(f"peer {dst} detached during send") from e
        bell = self._peer_bells.get(dst)
        if bell is not None:
            bell.ring()

    def recv(self, timeout: float | None = None) -> bytes | None:
        deadline = None if timeout is None else time.monotonic() + timeout
        cfg = self.config
        bell = self._bell
        spins = 0
        armed = False
        try:
            while True:
                # When armed, snapshot seq BEFORE polling: a publish after
                # this poll bumps seq and FUTEX_WAIT refuses to sleep.
                seq = bell.read_seq() if armed else 0
                for src in self._rr:
                    # detach_peer (another thread) may retire a ring
                    # mid-poll: a missing/closed ring reads as empty,
                    # never as an error
                    ring = self._in.get(src)
                    if ring is None or ring._buf is None:
                        continue
                    try:
                        frame = ring.try_pop()
                    except (TypeError, ValueError):  # closed under our feet
                        continue
                    if frame is not None:
                        return frame
                spins += 1
                if deadline is not None and time.monotonic() > deadline:
                    return None
                if bell is not None and spins >= cfg.spin_budget:
                    if not armed:
                        bell.arm()
                        armed = True
                        continue  # mandatory re-poll between arm and park
                    park = cfg.park_timeout
                    if deadline is not None:
                        park = min(park, deadline - time.monotonic())
                        if park <= 0:
                            return None
                    bell.wait(seq, park)
                else:
                    # adaptive backoff: hot-spin briefly (latency), then
                    # yield — the doorbell-less fallback path
                    time.sleep(0 if spins < cfg.spin_budget else cfg.sleep_quantum)
        finally:
            if armed:
                bell.disarm()

    def recv_many(self, max_frames: int = 64, timeout: float | None = None) -> list:
        """Up to ``max_frames`` leased frame views, ``[]`` on timeout.

        One ``pop_many`` (= one eventual tail store) per non-empty inbound
        ring; views stay valid until :meth:`release`.  Waiting follows the
        same spin-then-park protocol as :meth:`recv`.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        cfg = self.config
        bell = self._bell
        spins = 0
        armed = False
        try:
            while True:
                seq = bell.read_seq() if armed else 0
                views: list = []
                for src in self._rr:
                    ring = self._in.get(src)
                    if ring is None or ring._buf is None:
                        continue  # retired by detach_peer mid-poll
                    try:
                        lease = ring.pop_many(max_frames - len(views))
                    except (TypeError, ValueError):  # closed under our feet
                        continue
                    if lease is not None:
                        self._leases.append(lease)
                        views.extend(lease.views)
                        if len(views) >= max_frames:
                            break
                if views:
                    return views
                spins += 1
                if deadline is not None and time.monotonic() > deadline:
                    return []
                if bell is not None and spins >= cfg.spin_budget:
                    if not armed:
                        bell.arm()
                        armed = True
                        continue  # mandatory re-poll between arm and park
                    park = cfg.park_timeout
                    if deadline is not None:
                        park = min(park, deadline - time.monotonic())
                        if park <= 0:
                            return []
                    bell.wait(seq, park)
                else:
                    time.sleep(0 if spins < cfg.spin_budget else cfg.sleep_quantum)
        finally:
            if armed:
                bell.disarm()

    def release(self) -> None:
        leases, self._leases = self._leases, []
        for lease in leases:
            if not lease.released:
                lease.release()

    def pending_frames(self) -> int:
        """Published-but-unread frames across the inbound rings (capped per
        ring; an estimate for queue-depth reports, not accounting)."""
        total = 0
        for src in self._rr:
            ring = self._in.get(src)
            if ring is None or ring._buf is None:
                continue
            try:
                total += ring.pending_frame_count()
            except (TypeError, ValueError):
                continue
        return total

    def close(self) -> None:
        self._leases.clear()
        for r in self._out.values():
            r.close()
        for r in self._in.values():
            r.close()
        if self._bell is not None:
            self._bell.close()
            self._bell = None
        for bell in self._peer_bells.values():
            if bell is not None:
                bell.close()
        self._peer_bells = {}


class ShmFabric(Fabric):
    """Creates all directed rings; parent process owns segment lifetime.

    Segment lifetime is guarded twice: an explicit :meth:`close` (the normal
    path) and an ``atexit`` hook — so a host that errors out between fabric
    creation and teardown (or a test that aborts mid-run while a child is
    dead) still unlinks its ``/dev/shm`` segments instead of leaking them
    until reboot.

    Elastic membership: :meth:`add_node` creates the new node's ring pairs
    toward every current member (segments exist before any endpoint attaches
    them); :meth:`remove_node` unlinks a retired node's rings.  Node ids are
    monotonic and never reused.  Already-running *remote* endpoints map the
    new rings via their own ``attach_peer`` (broadcast by the cluster
    layer) — the fabric owner only manages segment lifetime.
    """

    def __init__(self, num_nodes: int, capacity: int = 1 << 24, prefix: str | None = None,
                 config: RingConfig | None = None):
        import atexit
        import os
        import uuid

        self.num_nodes = num_nodes
        self.capacity = capacity
        self.config = config or RingConfig()
        self.prefix = prefix or f"ham{os.getpid()}_{uuid.uuid4().hex[:8]}"
        self._rings: dict[tuple[int, int], ShmRing] = {}
        self._bells: dict[int, Doorbell] = {}
        self._nodes: set[int] = set(range(num_nodes))
        self._next_id = num_nodes
        self._closed = False
        for src in range(num_nodes):
            for dst in range(num_nodes):
                if src != dst:
                    self._rings[(src, dst)] = ShmRing(
                        _ring_name(self.prefix, src, dst),
                        capacity=capacity,
                        create=True,
                    )
        if self.config.use_doorbell and futex_available():
            for node in range(num_nodes):
                self._bells[node] = Doorbell(
                    bell_name(self.prefix, node), create=True
                )
        atexit.register(self.close)

    def endpoint(self, node_id: int) -> ShmEndpoint:
        return ShmEndpoint(self.prefix, node_id, self.num_nodes,
                           peers=sorted(self._nodes), config=self.config)

    def nodes(self) -> list[int]:
        return sorted(self._nodes)

    def add_node(self) -> int:
        node_id = self._next_id
        self._next_id += 1
        for peer in sorted(self._nodes):
            self._rings[(node_id, peer)] = ShmRing(
                _ring_name(self.prefix, node_id, peer),
                capacity=self.capacity, create=True,
            )
            self._rings[(peer, node_id)] = ShmRing(
                _ring_name(self.prefix, peer, node_id),
                capacity=self.capacity, create=True,
            )
        if self.config.use_doorbell and futex_available():
            self._bells[node_id] = Doorbell(
                bell_name(self.prefix, node_id), create=True
            )
        self._nodes.add(node_id)
        self.num_nodes = max(self.num_nodes, node_id + 1)
        return node_id

    def remove_node(self, node_id: int) -> None:
        self._nodes.discard(node_id)
        for pair in [p for p in self._rings if node_id in p]:
            ring = self._rings.pop(pair)
            ring.close()
            ring.unlink()
        bell = self._bells.pop(node_id, None)
        if bell is not None:
            bell.close()
            bell.unlink()

    def prepare_restart(self, node_id: int) -> None:
        """Clear the dead node's inbound rings so a replacement consumer
        starts from an empty queue (see Fabric.prepare_restart)."""
        for (_, dst), ring in self._rings.items():
            if dst == node_id:
                ring.drop_pending()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        import atexit

        atexit.unregister(self.close)
        for r in self._rings.values():
            r.close()
            r.unlink()
        for bell in self._bells.values():
            bell.close()
            bell.unlink()
        self._bells = {}
