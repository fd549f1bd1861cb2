"""Abstract communication backend (paper Fig. 1, bottom layer).

HAM itself is transport-agnostic; HAM-Offload plugs in MPI, TCP/IP, SCIF or
VEO/DMA.  Here the portable set is:

* ``local``  — in-process queues (threads as nodes); zero-copy handoff.
* ``shm``    — POSIX shared-memory SPSC rings between processes (the
  fast-path analogue of SCIF/DMA windows).
* ``socket`` — TCP/IP, byte-for-byte the paper's TCP backend class.

A backend moves opaque *frames* (header || payload, see core.message) between
integer-identified nodes.  It knows nothing about handlers.

Elastic membership
------------------

The paper fixes the node set at MPI startup; here the fabric is *elastic*:

* ``Fabric.add_node()`` allocates the next node id (ids are monotonic and
  never reused — a retired id stays dead forever, which is what lets
  stragglers addressed to it be dropped instead of misdelivered) and
  provisions whatever transport resources the new node needs (shm rings, a
  port, an inbox slot).
* ``Fabric.remove_node(node_id)`` retires an id and reclaims its resources.
* ``CommBackend.attach_peer(node_id)`` / ``detach_peer(node_id)`` are the
  *per-endpoint* half: every already-running endpoint must be told about a
  membership change, because endpoints cache per-peer state (rings, sockets,
  the valid-destination set).  The cluster layer broadcasts these as
  ``_cluster/attach_peer`` / ``_cluster/detach_peer`` control messages —
  see ``repro_torch.cluster.pool`` for the ordering contract.
"""

from __future__ import annotations

from repro_torch.core.errors import CommError


def as_byte_view(data) -> memoryview:
    """Flat uint8 memoryview over any buffer-protocol object, zero-copy —
    the normal form transports move frames in."""
    mv = data if isinstance(data, memoryview) else memoryview(data)
    if mv.format != "B" or mv.ndim != 1:
        mv = mv.cast("B")
    return mv


class CommBackend:
    """Per-node endpoint of a fabric.

    Backends expose two tiers:

    * per-frame ``send``/``recv`` — always available, frames are *owned*
      (plain bytes objects the caller may keep forever);
    * coalesced ``send_many``/``recv_many``/``release`` — the hot path.
      ``send_many`` moves N frames per transport publication (one ring
      counter store, one gathered syscall).  ``recv_many`` may hand out
      zero-copy views into the transport's receive window when the backend
      sets ``zero_copy_recv``; those views stay valid only until the next
      ``release()`` call, which returns the window space to the producer.
      Backends without a zero-copy window return owned frames and make
      ``release`` a no-op, so callers can use one code path everywhere.
    """

    node_id: int
    num_nodes: int

    #: True when recv_many returns leased views into transport memory that
    #: are invalidated by release(); False when frames are caller-owned.
    zero_copy_recv: bool = False

    #: Largest single frame this backend can move, or None for unlimited.
    #: Data-plane callers chunk transfers to stay under it.
    max_frame_nbytes: int | None = None

    def send(self, dst: int, frame: bytes | bytearray | memoryview) -> None:
        raise NotImplementedError

    def recv(self, timeout: float | None = None) -> bytes | None:
        """Next inbound frame, or ``None`` on timeout."""
        raise NotImplementedError

    def send_many(self, dst: int, frames) -> None:
        """Send a batch of frames to one destination (default: a loop)."""
        for frame in frames:
            self.send(dst, frame)

    def recv_many(self, max_frames: int = 64, timeout: float | None = None) -> list:
        """Up to ``max_frames`` inbound frames; ``[]`` on timeout.

        Default implementation degrades to one frame per call.
        """
        frame = self.recv(timeout=timeout)
        return [] if frame is None else [frame]

    def release(self) -> None:
        """Release every view handed out by prior ``recv_many`` calls.

        No-op unless ``zero_copy_recv`` is set.
        """

    def reset_peer(self, dst: int) -> None:
        """Drop cached transport state toward ``dst`` (a worker that died and
        is being replaced): stale connections/cursors must not leak into the
        restarted peer.  No-op for connectionless backends.
        """

    def attach_peer(self, node_id: int) -> None:
        """Make ``node_id`` a valid peer of this endpoint (elastic grow).

        Called on every *running* endpoint when the fabric adds a node —
        after the fabric has provisioned the node's transport resources and
        before the new node sends its first frame.  Default: widen the
        valid-destination range.
        """
        self.num_nodes = max(self.num_nodes, node_id + 1)

    def detach_peer(self, node_id: int) -> None:
        """Forget peer ``node_id`` (elastic shrink): drop cached transport
        state and stop accepting it as a destination.  The id is never
        reused, so a late send toward it must fail fast rather than queue.
        """
        self.reset_peer(node_id)

    def pending_frames(self) -> int:
        """Best-effort count of inbound frames queued in the transport that
        this endpoint has not yet received.  Feeds the runtime's queue-depth
        reports; 0 when the backend cannot tell cheaply.
        """
        return 0

    def close(self) -> None:
        pass

    def _check_dst(self, dst: int) -> None:
        if not 0 <= dst < self.num_nodes or dst == self.node_id:
            raise CommError(
                f"invalid destination {dst} (node {self.node_id} of {self.num_nodes})"
            )


class Fabric:
    """Factory/owner of the per-node backends of one communication domain."""

    num_nodes: int

    def endpoint(self, node_id: int) -> CommBackend:
        raise NotImplementedError

    def nodes(self) -> list[int]:
        """Current member node ids.  Dense ``range(num_nodes)`` by default;
        elastic fabrics may have holes after ``remove_node``."""
        return list(range(self.num_nodes))

    def add_node(self) -> int:
        """Provision transport resources for one new node and return its id
        (monotonic, never reused).  Running endpoints still need
        ``attach_peer`` before they accept the id as a destination.
        """
        raise NotImplementedError(f"{type(self).__name__} is not elastic")

    def remove_node(self, node_id: int) -> None:
        """Retire ``node_id`` and reclaim its transport resources.  The
        caller must have detached every running endpoint first
        (``detach_peer`` broadcast) — frames in flight toward a reclaimed
        resource are dropped, not redelivered.
        """
        raise NotImplementedError(f"{type(self).__name__} is not elastic")

    def prepare_restart(self, node_id: int) -> None:
        """Make the fabric safe for a replacement process to attach as
        ``node_id`` after the original died: discard frames queued toward the
        dead node (their futures were already failed by the failure detector;
        redelivering them to the replacement would resurrect cancelled work).
        No-op where nothing is buffered in the fabric itself.
        """

    def close(self) -> None:
        pass
