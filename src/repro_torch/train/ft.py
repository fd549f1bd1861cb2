"""Fault tolerance over active messages: heartbeats, stragglers, elasticity
(a copy of ``repro.train.ft`` over the port's ``OffloadDomain``).

Everything here is built from the paper's primitives — no side channels:

* **Heartbeats** are ``_ham/ping`` round-trips; a missed deadline marks the
  node dead, fails its outstanding futures, and fires the rescale callback.
* **Straggler detection** aggregates per-node step timings (reported as
  active messages by workers) and flags nodes slower than
  ``factor × median``; the mitigation hook can reroute their shards or pad
  their serving steps with the ``serve/noop`` handler (device-table branch).
* **Elastic membership** is where the paper's key insight pays off at pod
  scale: keys are derived *locally* from sorted stable names, so a joining
  or surviving fleet agrees on every handler key with zero negotiation —
  rescaling is: verify digest (32 bytes), reassign data shards, continue
  from the latest checkpoint.  No global re-registration round.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from repro_torch.core.closure import f2f
from repro_torch.core.errors import KeyMapMismatchError, NodeDownError


class HeartbeatMonitor:
    """Host-side liveness tracking for a set of worker nodes."""

    def __init__(
        self,
        domain,
        nodes: list[int],
        *,
        interval: float = 0.2,
        timeout: float = 1.0,
        on_failure: Callable[[int], None] | None = None,
    ):
        self.domain = domain
        self.nodes = set(nodes)
        self.interval = interval
        self.timeout = timeout
        self.on_failure = on_failure
        self.last_seen: dict[int, float] = {n: time.monotonic() for n in nodes}
        self.dead: set[int] = set()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _beat_once(self) -> None:
        now = time.monotonic()
        for n in sorted(self.nodes - self.dead):
            fut = self.domain.async_(n, f2f("_ham/ping", 0,
                                            registry=self.domain.registry))

            def made(node):
                def cb(f):
                    try:
                        f.get(0)
                        self.last_seen[node] = time.monotonic()
                    except Exception:  # noqa: BLE001 — failure == missed beat
                        pass
                return cb

            fut.add_done_callback(made(n))
        for n in sorted(self.nodes - self.dead):
            if now - self.last_seen[n] > self.timeout:
                self.declare_dead(n)

    def declare_dead(self, node: int) -> None:
        if node in self.dead:
            return
        self.dead.add(node)
        if self.on_failure:
            self.on_failure(node)

    def run(self) -> None:
        while not self._stop.is_set():
            self._beat_once()
            self._stop.wait(self.interval)

    def start(self) -> "HeartbeatMonitor":
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name="ham-heartbeat")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)

    def alive(self) -> list[int]:
        return sorted(self.nodes - self.dead)


class StragglerDetector:
    """Flags nodes whose step time exceeds ``factor ×`` the fleet median."""

    def __init__(self, factor: float = 1.5, window: int = 16):
        self.factor = factor
        self.window = window
        self._times: dict[int, list[float]] = {}
        self._lock = threading.Lock()

    def record(self, node: int, dt: float) -> None:
        with self._lock:
            self._times.setdefault(node, []).append(dt)
            if len(self._times[node]) > self.window:
                self._times[node] = self._times[node][-self.window:]

    def _node_avg(self, node: int) -> float:
        ts = self._times.get(node, [])
        return sum(ts) / len(ts) if ts else 0.0

    def stragglers(self) -> list[int]:
        with self._lock:
            avgs = {n: self._node_avg(n) for n in self._times if self._times[n]}
        if len(avgs) < 2:
            return []
        vals = sorted(avgs.values())
        median = vals[len(vals) // 2]
        if median <= 0:
            return []
        return sorted(n for n, t in avgs.items() if t > self.factor * median)


class ElasticFleet:
    """Deterministic shard (re)assignment over the surviving membership.

    Rescale cost is O(local sort): the HAM key map needs no renegotiation
    (paper §5.2 — sorted stable names), only the data shards move.
    """

    def __init__(self, domain, worker_nodes: list[int]):
        self.domain = domain
        self.members = sorted(worker_nodes)
        self.epoch = 0

    def shard_of(self, node: int) -> tuple[int, int]:
        """(shard_index, num_shards) for a member under current membership."""
        if node not in self.members:
            raise NodeDownError(f"node {node} not in fleet")
        return self.members.index(node), len(self.members)

    def remove(self, node: int) -> dict[int, tuple[int, int]]:
        """Drop a dead node; returns the new shard map (node -> shard)."""
        self.members = [n for n in self.members if n != node]
        self.epoch += 1
        return {n: self.shard_of(n) for n in self.members}

    def admit(self, node: int, peer_digest_hex: str) -> dict[int, tuple[int, int]]:
        """Join path: verify the candidate derives the same key map (the
        32-byte same-source check), then extend membership."""
        local = self.domain.registry.table.digest.hex()
        if peer_digest_hex != local:
            raise KeyMapMismatchError(
                f"node {node} key-map digest {peer_digest_hex[:12]}… != "
                f"fleet {local[:12]}…"
            )
        if node not in self.members:
            self.members = sorted(self.members + [node])
            self.epoch += 1
        return {n: self.shard_of(n) for n in self.members}
