"""In-process fabric: nodes are threads, frames move by reference.

This is the intra-node offload case of the paper (host and accelerator in
one box) reduced to its cheapest possible transport — useful both as the
latency floor in the Fig. 3-analogue benchmark and as the default fabric for
unit tests.

Elastic membership is trivial here (everything shares the fabric object):
``add_node`` creates a fresh inbox, ``remove_node`` deletes it; endpoints
consult the fabric's live endpoint map on every send, so attach/detach
broadcasts are no-ops and a send toward a removed id fails fast.
"""

from __future__ import annotations

import queue

from repro_torch.comm.base import CommBackend, Fabric
from repro_torch.core.errors import CommError


class LocalEndpoint(CommBackend):
    def __init__(self, fabric: "LocalFabric", node_id: int):
        self._fabric = fabric
        self.node_id = node_id
        self._inbox: queue.SimpleQueue = queue.SimpleQueue()

    @property
    def num_nodes(self) -> int:
        return self._fabric.num_nodes

    def _check_dst(self, dst: int) -> None:
        if dst == self.node_id or dst not in self._fabric._endpoints:
            raise CommError(
                f"invalid destination {dst} (node {self.node_id} of "
                f"{sorted(self._fabric._endpoints)})"
            )

    def attach_peer(self, node_id: int) -> None:
        pass  # membership lives on the shared fabric object

    def detach_peer(self, node_id: int) -> None:
        pass

    def send(self, dst: int, frame) -> None:
        self._check_dst(dst)
        # by-reference handoff: frames are freshly allocated per message and
        # never mutated after send, so the zero-copy pass-through is safe
        # (the latency floor the shm/socket backends are measured against)
        self._fabric._endpoints[dst]._inbox.put(frame)

    def send_many(self, dst: int, frames) -> None:
        self._check_dst(dst)
        inbox = self._fabric._endpoints[dst]._inbox
        for frame in frames:
            inbox.put(frame)

    def recv(self, timeout: float | None = None) -> bytes | None:
        try:
            return self._inbox.get(timeout=timeout)
        except queue.Empty:
            return None

    def recv_many(self, max_frames: int = 64, timeout: float | None = None) -> list:
        """Drain up to ``max_frames`` queued frames in one call (frames are
        owned — by-reference handoff — so there is nothing to release)."""
        try:
            out = [self._inbox.get(timeout=timeout)]
        except queue.Empty:
            return []
        while len(out) < max_frames:
            try:
                out.append(self._inbox.get_nowait())
            except queue.Empty:
                break
        return out

    def pending_frames(self) -> int:
        return self._inbox.qsize()


class LocalFabric(Fabric):
    def __init__(self, num_nodes: int):
        self.num_nodes = num_nodes
        self._endpoints = {i: LocalEndpoint(self, i) for i in range(num_nodes)}
        self._next_id = num_nodes

    def endpoint(self, node_id: int) -> LocalEndpoint:
        return self._endpoints[node_id]

    def nodes(self) -> list[int]:
        return sorted(self._endpoints)

    def add_node(self) -> int:
        node_id = self._next_id
        self._next_id += 1
        self._endpoints[node_id] = LocalEndpoint(self, node_id)
        self.num_nodes = max(self.num_nodes, node_id + 1)
        return node_id

    def remove_node(self, node_id: int) -> None:
        self._endpoints.pop(node_id, None)

    def prepare_restart(self, node_id: int) -> None:
        """Drain frames queued toward a dead node's inbox — they belong to
        calls the failure detector already failed (see Fabric docs)."""
        inbox = self._endpoints[node_id]._inbox
        while True:
            try:
                inbox.get_nowait()
            except queue.Empty:
                return
