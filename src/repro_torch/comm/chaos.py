"""Seeded, deterministic fault injection over any Fabric/CommBackend.

The fault-tolerance layer (scheduler deadlines/retries, the worker replay
cache, directory recovery — see ``docs/failure-model.md``) is only
trustworthy if it is *tested against* the failures it claims to absorb.
:class:`ChaosFabric` wraps a real fabric and injects, per frame:

* **drop** — the frame never arrives;
* **dup** — the frame arrives twice (the retry path's dedup test);
* **delay** — the frame arrives ``delay_s`` later (re-sent by a timer, so
  it can overtake everything sent in between — delayed-delivery reordering);
* **reorder** — the frame is moved behind the frames that follow it in the
  same batch (or degrades to a short delay when it travels alone);
* **one-way partition** — :meth:`ChaosFabric.block` force-drops every frame
  on one ``src -> dst`` link until :meth:`ChaosFabric.unblock`.

Determinism contract
--------------------

Every link (an ordered ``src -> dst`` pair, per direction of injection)
owns a private ``random.Random`` seeded from ``(seed, src, dst)`` and a
monotonically increasing per-link frame sequence number.  The fault decided
for a frame is a pure function of ``(seed, link, link_seq, config)`` — NOT
of wall-clock time or thread interleaving — so the same seed and per-link
schedule produce the *identical fault sequence* on every run and on every
transport.  :attr:`ChaosFabric.fault_log` records each non-deliver decision
as ``(src, dst, link_seq, action, where)``; tests assert two same-seed runs
produce equal logs (``tests/test_chaos.py``).

Per-link **schedules** override the probabilistic draw for a window of the
link's sequence numbers: ``ChaosConfig(schedule=((3, 6, "drop"),))`` drops
exactly frames 3, 4 and 5 of that link, whatever the probabilities say.
The RNG is still advanced for scheduled frames, so a schedule does not
shift the fault pattern of the frames after its window.

Injection sides
---------------

Faults are injected at the **send boundary** of every wrapped endpoint and
(for HAM frames, whose 32-byte header names the true sender) at the
**receive boundary** keyed by the frame's ``src_node``.  Recv-side
injection exists because process fabrics (shm fork children, socket
subprocess workers) build their endpoints *inside the child* — only the
host's endpoint can be wrapped, so a lost worker->host reply is simulated
by dropping it on arrival at the host.  Non-HAM frames (bad magic) pass
the receive side untouched.

``arm()`` / ``disarm()`` gate injection globally: pools are built and torn
down fault-free, and verification reads (side-effect counters, directory
dumps) run with chaos disarmed.
"""

from __future__ import annotations

import dataclasses
import heapq
import random
import struct
import threading

from repro_torch.comm.base import CommBackend, Fabric
from repro_torch.core.message import HEADER_STRUCT, MAGIC

_DELIVER = "deliver"
_ACTIONS = ("drop", "dup", "delay", "reorder")


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Per-link fault probabilities and forced-fault schedule.

    Probabilities are cumulative-exclusive (at most one fault per frame):
    a uniform draw lands in the drop, dup, delay, reorder or deliver band.
    ``schedule`` is a tuple of ``(lo, hi, action)`` windows over the link's
    frame sequence numbers; a frame whose seq falls in ``[lo, hi)`` takes
    ``action`` unconditionally (``"deliver"`` forces clean delivery — the
    way to protect a handshake window on an otherwise lossy link).
    """

    drop: float = 0.0
    dup: float = 0.0
    delay: float = 0.0
    reorder: float = 0.0
    #: held time for delayed frames (and the alone-frame reorder fallback)
    delay_s: float = 0.005
    schedule: tuple = ()

    def validate(self) -> "ChaosConfig":
        total = self.drop + self.dup + self.delay + self.reorder
        if not 0.0 <= total <= 1.0:
            raise ValueError(f"fault probabilities sum to {total}, not [0, 1]")
        for lo, hi, action in self.schedule:
            if action != _DELIVER and action not in _ACTIONS:
                raise ValueError(f"unknown scheduled action {action!r}")
            if lo >= hi:
                raise ValueError(f"empty schedule window [{lo}, {hi})")
        return self


class _Link:
    """Deterministic decision stream for one directed (src, dst) link."""

    __slots__ = ("rng", "seq", "config", "blocked")

    def __init__(self, seed: int, src: int, dst: int, config: ChaosConfig):
        # string-seeded so (seed, src, dst) mix without collisions like
        # seed ^ src ^ dst would produce
        self.rng = random.Random(f"{seed}:{src}->{dst}")
        self.seq = 0
        self.config = config
        self.blocked = False

    def decide(self) -> tuple[int, str]:
        """Next (link_seq, action).  The RNG advances on EVERY frame —
        including blocked and scheduled ones — so partitions toggled at
        test-dependent times never shift the fault pattern that follows."""
        seq, self.seq = self.seq, self.seq + 1
        r = self.rng.random()
        if self.blocked:
            return seq, "drop"
        c = self.config
        for lo, hi, action in c.schedule:
            if lo <= seq < hi:
                return seq, action
        edge = c.drop
        if r < edge:
            return seq, "drop"
        edge += c.dup
        if r < edge:
            return seq, "dup"
        edge += c.delay
        if r < edge:
            return seq, "delay"
        edge += c.reorder
        if r < edge:
            return seq, "reorder"
        return seq, _DELIVER


class ChaosEndpoint(CommBackend):
    """Fault-injecting wrapper around one endpoint (see module docs)."""

    def __init__(self, chaos: "ChaosFabric", inner: CommBackend):
        self._chaos = chaos
        self._inner = inner
        #: inbound frames held by delay/reorder faults: (due, tiebreak, frame)
        self._in_held: list = []
        self._in_seq = 0
        self._in_lock = threading.Lock()

    # -- delegation ----------------------------------------------------------

    @property
    def node_id(self) -> int:
        return self._inner.node_id

    @property
    def num_nodes(self) -> int:
        return self._inner.num_nodes

    @property
    def zero_copy_recv(self) -> bool:
        return getattr(self._inner, "zero_copy_recv", False)

    @property
    def max_frame_nbytes(self):
        return getattr(self._inner, "max_frame_nbytes", None)

    def release(self) -> None:
        self._inner.release()

    def reset_peer(self, dst: int) -> None:
        self._inner.reset_peer(dst)

    def attach_peer(self, node_id: int) -> None:
        self._inner.attach_peer(node_id)

    def detach_peer(self, node_id: int) -> None:
        self._inner.detach_peer(node_id)

    def pending_frames(self) -> int:
        return self._inner.pending_frames()

    def close(self) -> None:
        self._inner.close()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    # -- send side -----------------------------------------------------------

    def send(self, dst: int, frame) -> None:
        chaos = self._chaos
        if not chaos.armed:
            self._inner.send(dst, frame)
            return
        out = self._apply_send(dst, frame, None)
        if len(out) == 1:
            self._inner.send(dst, out[0])
        elif out:
            self._inner.send_many(dst, out)

    def send_many(self, dst: int, frames) -> None:
        chaos = self._chaos
        if not chaos.armed:
            self._inner.send_many(dst, frames)
            return
        out: list = []
        held: list = []
        for frame in frames:
            self._apply_send(dst, frame, out, held)
        out.extend(held)  # reordered frames land behind the batch
        if len(out) == 1:
            self._inner.send(dst, out[0])
        elif out:
            self._inner.send_many(dst, out)

    def _apply_send(self, dst: int, frame, out, held=None):
        """Decide and apply one outbound frame's fate; surviving frames go
        to ``out`` (created when None), reordered ones to ``held`` (behind
        the batch) or — with no batch to fall behind — a short delay."""
        chaos = self._chaos
        if out is None:
            out = []
        seq, action = chaos._decide(self.node_id, dst)
        if action == _DELIVER:
            out.append(frame)
            return out
        chaos._log(self.node_id, dst, seq, action, "send")
        if action == "drop":
            return out
        if action == "dup":
            # the copy matters: `frame` may be a pooled/leased buffer the
            # caller reuses once the send returns
            out.append(frame)
            out.append(bytes(frame))
            return out
        delay_s = chaos._link_config(self.node_id, dst).delay_s
        if action == "reorder" and held is not None:
            held.append(bytes(frame))
            return out
        # delay (and alone-frame reorder): a timer re-sends through the
        # inner endpoint, overtaken by everything sent in between
        chaos._later(delay_s, self._inner.send, dst, bytes(frame))
        return out

    # -- receive side --------------------------------------------------------

    def recv(self, timeout: float | None = None):
        chaos = self._chaos
        if not chaos.armed and not self._in_held:
            return self._inner.recv(timeout=timeout)
        got = self.recv_many(1, timeout=timeout)
        return got[0] if got else None

    def recv_many(self, max_frames: int = 64, timeout: float | None = None) -> list:
        chaos = self._chaos
        inner = self._inner
        if not chaos.armed and not self._in_held:
            return inner.recv_many(max_frames, timeout=timeout)
        frames = inner.recv_many(max_frames, timeout=timeout)
        out: list = []
        with self._in_lock:
            # release previously held frames whose due time passed
            now = chaos._now()
            while self._in_held and self._in_held[0][0] <= now:
                out.append(heapq.heappop(self._in_held)[2])
        if not chaos.armed:
            out.extend(frames)
            return out
        tail: list = []
        for frame in frames:
            src = self._frame_src(frame)
            if src is None:  # not a HAM frame: never touched
                out.append(frame)
                continue
            seq, action = chaos._decide(src, self.node_id, side="recv")
            if action == _DELIVER:
                out.append(frame)
                continue
            chaos._log(src, self.node_id, seq, action, "recv")
            if action == "drop":
                continue
            if action == "dup":
                out.append(frame)
                out.append(bytes(frame))
                continue
            if action == "reorder":
                tail.append(bytes(frame))  # behind the rest of this batch
                continue
            # delay: hold an owned copy until due, delivered by a later recv
            due = chaos._now() + chaos._link_config(src, self.node_id).delay_s
            with self._in_lock:
                self._in_seq += 1
                heapq.heappush(self._in_held, (due, self._in_seq, bytes(frame)))
        out.extend(tail)
        return out

    @staticmethod
    def _frame_src(frame):
        """The HAM header's src_node, or None for a non-HAM frame."""
        try:
            magic, _, _, _, src, _, _ = HEADER_STRUCT.unpack_from(frame, 0)
        except struct.error:
            return None
        return src if magic == MAGIC else None


class ChaosFabric(Fabric):
    """Fabric wrapper: every endpoint it hands out injects faults.

    ``default`` is the :class:`ChaosConfig` for links without an explicit
    :meth:`set_link` override.  Starts **disarmed** — wrap the fabric, build
    the pool fault-free, then :meth:`arm`.
    """

    def __init__(self, inner: Fabric, *, seed: int = 0,
                 default: ChaosConfig | None = None):
        self.inner = inner
        self.seed = int(seed)
        self.default = (default or ChaosConfig()).validate()
        self.armed = False
        self.fault_log: list[tuple[int, int, int, str, str]] = []
        self.faults = {a: 0 for a in _ACTIONS}
        self._lock = threading.Lock()
        #: (src, dst, side) -> _Link; send- and recv-side streams are
        #: separate links so host-side recv injection cannot desync the
        #: send-side sequence of the same pair
        self._links: dict[tuple[int, int, str], _Link] = {}
        self._overrides: dict[tuple[int, int], ChaosConfig] = {}
        self._endpoints: dict[int, ChaosEndpoint] = {}
        self._timers: list[threading.Timer] = []

    # -- chaos control -------------------------------------------------------

    def arm(self) -> "ChaosFabric":
        self.armed = True
        return self

    def disarm(self) -> "ChaosFabric":
        self.armed = False
        return self

    def set_link(self, src: int, dst: int,
                 config: ChaosConfig) -> "ChaosFabric":
        """Override the fault config of one directed link (both sides)."""
        with self._lock:
            self._overrides[(src, dst)] = config.validate()
            for side in ("send", "recv"):
                link = self._links.get((src, dst, side))
                if link is not None:
                    link.config = config
        return self

    def block(self, src: int, dst: int) -> "ChaosFabric":
        """One-way partition: force-drop every src->dst frame (both
        injection sides) until :meth:`unblock`."""
        return self._set_blocked(src, dst, True)

    def unblock(self, src: int, dst: int) -> "ChaosFabric":
        return self._set_blocked(src, dst, False)

    def _set_blocked(self, src: int, dst: int, blocked: bool) -> "ChaosFabric":
        with self._lock:
            for side in ("send", "recv"):
                self._link(src, dst, side, locked=True).blocked = blocked
        return self

    def _link_config(self, src: int, dst: int) -> ChaosConfig:
        return self._overrides.get((src, dst), self.default)

    def _link(self, src: int, dst: int, side: str, locked: bool = False) -> _Link:
        key = (src, dst, side)
        link = self._links.get(key)
        if link is None:
            if not locked:
                with self._lock:
                    return self._link(src, dst, side, locked=True)
            link = self._links.get(key)
            if link is None:
                link = _Link(self.seed, src, dst, self._link_config(src, dst))
                self._links[key] = link
        return link

    def _decide(self, src: int, dst: int, side: str = "send") -> tuple[int, str]:
        with self._lock:
            return self._link(src, dst, side, locked=True).decide()

    def _log(self, src: int, dst: int, seq: int, action: str, where: str) -> None:
        with self._lock:
            self.fault_log.append((src, dst, seq, action, where))
            self.faults[action] += 1

    def _later(self, delay_s: float, fn, *args) -> None:
        """Deliver a held frame after ``delay_s`` (daemon timer; best-effort
        — a delayed frame racing fabric teardown is just a dropped frame,
        which chaos is allowed to do anyway)."""

        def _fire():
            try:
                fn(*args)
            except Exception:  # noqa: BLE001 — see docstring
                pass

        t = threading.Timer(delay_s, _fire)
        t.daemon = True
        with self._lock:
            self._timers = [x for x in self._timers if x.is_alive()]
            self._timers.append(t)
        t.start()

    @staticmethod
    def _now() -> float:
        import time

        return time.monotonic()

    # -- Fabric delegation ---------------------------------------------------

    @property
    def num_nodes(self) -> int:
        return self.inner.num_nodes

    def endpoint(self, node_id: int) -> ChaosEndpoint:
        ep = self._endpoints.get(node_id)
        if ep is None:
            ep = self._endpoints[node_id] = ChaosEndpoint(
                self, self.inner.endpoint(node_id)
            )
        return ep

    def nodes(self) -> list[int]:
        return self.inner.nodes()

    def add_node(self) -> int:
        return self.inner.add_node()

    def remove_node(self, node_id: int) -> None:
        self._endpoints.pop(node_id, None)
        self.inner.remove_node(node_id)

    def prepare_restart(self, node_id: int) -> None:
        self.inner.prepare_restart(node_id)

    def close(self) -> None:
        with self._lock:
            timers, self._timers = self._timers, []
        for t in timers:
            t.cancel()
        self.inner.close()

    def __getattr__(self, name):
        # pool constructors read fabric-specific attrs (base_port, prefix)
        return getattr(self.inner, name)
