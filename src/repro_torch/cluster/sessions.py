"""Sticky-session routing: rendezvous (HRW) hashing over live workers.

Long-running services route *sessions* (a serving request's KV cache, a
user's conversation, a shard of state) rather than independent calls: every
message of a session must land on the worker holding its state.  This
module supplies that affinity layer for the scheduler, generalising the
admission-time stickiness ``ClusterServingEngine`` used to hand-roll.

Why rendezvous hashing (highest random weight)
----------------------------------------------

For each session key the router scores every candidate node with a stable
64-bit hash of ``(key, node)`` and picks the maximum.  Two properties make
this the right tool for an *elastic* pool:

* **Minimal disruption** — adding a node remaps only the keys whose new
  top-scorer is that node (an expected ``1/n`` share); removing a node
  remaps only the keys it owned.  Every other key's winner is untouched,
  with no token ring to rebalance and no state to migrate.
* **Determinism without coordination** — scores depend only on (key, node
  id), so any process with the same live set derives the same placement;
  nothing needs to be broadcast when a session is first seen.

Stickiness contract (the routing table on top of HRW)
-----------------------------------------------------

``route(key)`` consults a pinned-placement table first; HRW only runs for
keys with no live pin.  The resulting invariants, which the tests assert:

* a session stays on its worker across *unrelated* membership changes —
  resizes never move a pinned live session (HRW alone would remap its fair
  share; the pin table is what turns "minimal disruption" into "zero
  disruption for established sessions");
* a pin *survives worker restart*: the table maps to the node id, and a
  restarted worker rejoins under the same id (callers re-establish any
  node-local state, as with restarts generally);
* a session is **re-placed only when its own worker leaves the live set**
  (death or removal): the next ``route`` falls back to HRW over the
  survivors and re-pins — the fallback-on-death contract.

Node ids are never reused (pool invariant), so a stale pin can never
accidentally match an unrelated future worker.
"""

from __future__ import annotations

import hashlib
import struct
import threading
from typing import Callable, Hashable, Iterable

__all__ = ["SessionRouter", "rendezvous_hash"]

_U64 = struct.Struct(">Q")


def _score(key_bytes: bytes, node: int) -> int:
    h = hashlib.blake2b(key_bytes, digest_size=8, salt=_U64.pack(node))
    return _U64.unpack(h.digest())[0]


def _key_bytes(key: Hashable) -> bytes:
    if isinstance(key, bytes):
        return key
    if isinstance(key, str):
        return key.encode("utf-8")
    return repr(key).encode("utf-8")


def rendezvous_hash(key: Hashable, nodes: Iterable[int]) -> int | None:
    """Highest-random-weight winner for ``key`` among ``nodes`` (None when
    empty).  Stable across processes and runs: blake2b, not Python hash."""
    kb = _key_bytes(key)
    best, best_score = None, -1
    for node in sorted(nodes):
        s = _score(kb, node)
        if s > best_score:
            best, best_score = node, s
    return best


class SessionRouter:
    """Pin table + HRW fallback over a live-node view (module docs define
    the stickiness contract).

    ``live_nodes`` is a callable returning the current routable node ids —
    normally ``Scheduler.live_nodes``, so fencing a node for removal
    immediately stops new placements on it.
    """

    def __init__(self, live_nodes: Callable[[], Iterable[int]]):
        self._live_nodes = live_nodes
        self._pins: dict[Hashable, int] = {}
        self._lock = threading.Lock()
        self.stats = {"placed": 0, "replaced": 0, "hits": 0, "recovered": 0,
                      "ended": 0}

    def route(self, key: Hashable, *, eligible: Iterable[int] | None = None) -> int | None:
        """Worker for ``key``: the live pin if one exists, else a fresh HRW
        placement (re-placement when the pinned worker left the live set).

        ``eligible`` restricts *fresh* placements (e.g. to workers with free
        serving slots); a live pin always wins over it — stickiness is the
        point.  Returns None when no candidate node is live.
        """
        live = set(self._live_nodes())
        with self._lock:
            pinned = self._pins.get(key)
            if pinned is not None and pinned in live:
                self.stats["hits"] += 1
                return pinned
            candidates = live if eligible is None else live & set(eligible)
            node = rendezvous_hash(key, candidates)
            if node is None:
                return None
            if pinned is None:
                self.stats["placed"] += 1
            else:
                self.stats["replaced"] += 1  # fallback-on-death re-placement
            self._pins[key] = node
            return node

    def repin(self, key: Hashable, node: int) -> None:
        """Data-directed re-placement: force ``key``'s pin to ``node``.

        The crash-recovery override of the HRW fallback: when a session's
        worker dies but a replica of its buffers survives elsewhere, the
        BufferDirectory (through the scheduler) repins the session onto the
        node now holding its bytes — the session follows its data, not the
        hash.  Also used by drain migration on ``remove_node``.
        """
        with self._lock:
            if self._pins.get(key) != node:
                self._pins[key] = node
                self.stats["recovered"] += 1

    def lookup(self, key: Hashable) -> int | None:
        """Current pin (may point at a dead node — ``route`` re-places)."""
        with self._lock:
            return self._pins.get(key)

    def end_session(self, key: Hashable) -> None:
        with self._lock:
            if self._pins.pop(key, None) is not None:
                self.stats["ended"] += 1

    def sessions_on(self, node: int) -> list:
        with self._lock:
            return [k for k, n in self._pins.items() if n == node]

    def evict_node(self, node: int) -> list:
        """Drop every pin on ``node`` (worker retired — its state is gone);
        returns the evicted keys.  Their next ``route`` re-places them."""
        with self._lock:
            evicted = [k for k, n in self._pins.items() if n == node]
            for k in evicted:
                del self._pins[k]
        return evicted

    def __len__(self) -> int:
        with self._lock:
            return len(self._pins)
