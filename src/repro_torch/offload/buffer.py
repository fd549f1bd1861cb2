"""PGAS-style smart pointers (paper §2: ``buffer_ptr<T>``; §6: "smart
pointers that combine an address space or process identifier with a local
pointer").

A :class:`BufferPtr` is (node, handle, nbytes, epoch): 32 bytes on the wire,
registered as a fixed-size ``migratable`` so it can ride the *static* fast
path inside offloaded closures — exactly like the paper's bitwise-copyable
``buffer_ptr`` arguments in Fig. 2.

Location transparency (the post-HAM refactor; cf. HPX's AGAS decoupling
object identity from placement):

* ``handle`` is a **stable global id** — unique cluster-wide (allocating
  nodes namespace their counters by node id), and preserved when the buffer
  is replicated or migrated.  The handle *is* the buffer's identity; the
  ``node`` field is only a **placement hint**: where the primary copy lived
  when this pointer was minted.
* ``epoch`` is the **ownership epoch** the hint was minted under.  Every
  time the primary moves (replica promotion on crash, drain migration on
  shrink) the :class:`~repro_torch.offload.dataplane.BufferDirectory` bumps the
  buffer's epoch — so a pointer whose epoch is older than the directory's
  is *stale* and gets transparently re-resolved (hint rewritten) instead of
  erroring, while an up-to-date pointer skips the directory entirely.
* ``nbytes`` records the buffer's extent, which lets locality-aware
  scheduling weigh votes by the data actually behind a pointer (a pointer
  of unknown provenance carries ``nbytes=0`` and votes with weight 1).

The per-node :class:`BufferRegistry` maps handles to live numpy arrays; only
a node actually *holding* a copy may dereference (pointers are "in general
only valid within their original process's address space", §4.1 — here the
rule is enforced per copy: a replica holder adopts the buffer under the
same global handle, so a pointer retargeted at it dereferences fine).
"""

from __future__ import annotations

import dataclasses
import struct
import threading

import numpy as np

from repro_torch.core.errors import OffloadError
from repro_torch.core.migratable import register_migratable

_WIRE = struct.Struct("<qqqq")

#: global handles are ``(node_id << _HANDLE_SHIFT) | local_counter`` — every
#: node mints ids no other node can mint, so a replica can be installed
#: under its primary's handle without ever clashing with the holder's own
#: allocations (the precondition for a location-transparent namespace)
_HANDLE_SHIFT = 48


def handle_minter(handle: int) -> int:
    """Node that minted ``handle`` (NOT necessarily the current owner)."""
    return handle >> _HANDLE_SHIFT


@dataclasses.dataclass(frozen=True)
class BufferPtr:
    node: int        # placement hint: primary holder as of `epoch`
    handle: int      # stable global id (identity; survives migration)
    nbytes: int = 0  # buffer extent at the owner; 0 = unknown
    epoch: int = 0   # ownership epoch the hint was minted under

    def encode(self) -> bytes:
        return _WIRE.pack(self.node, self.handle, self.nbytes, self.epoch)

    @staticmethod
    def decode(raw: bytes) -> "BufferPtr":
        node, handle, nbytes, epoch = _WIRE.unpack(raw)
        return BufferPtr(node, handle, nbytes, epoch)

    def at(self, node: int, epoch: int | None = None) -> "BufferPtr":
        """Same buffer, rewritten placement hint (directory resolution)."""
        return BufferPtr(node, self.handle, self.nbytes,
                         self.epoch if epoch is None else epoch)


register_migratable(
    BufferPtr,
    encode=lambda p: p.encode(),
    decode=BufferPtr.decode,
    type_name="ham:buffer_ptr",
    nbytes_fixed=_WIRE.size,
    # a buffer_ptr knows its address space: locality-aware scheduling routes
    # calls to the node already holding their buffers, weighted by how much
    # data sits behind the pointer.  With a BufferDirectory attached the
    # scheduler widens this single-node hint to EVERY live replica holder
    # (scan_locality's resolver hook) — any copy can serve a read.
    locality=lambda p: p.node,
    locality_nbytes=lambda p: p.nbytes,
)


class BufferRegistry:
    """Handle -> array map of one node (the target side of allocate/put/get).

    Handles minted here are globally unique (node-id-namespaced counters),
    and :meth:`adopt` installs a *foreign* buffer under its original handle
    — the two halves of replica/migration support.
    """

    def __init__(self, node_id: int):
        self.node_id = node_id
        self._lock = threading.Lock()
        self._buffers: dict[int, np.ndarray] = {}
        self._next = 1

    def allocate(self, shape, dtype) -> BufferPtr:
        arr = np.zeros(tuple(int(d) for d in shape), dtype=np.dtype(str(dtype)))
        with self._lock:
            handle = (self.node_id << _HANDLE_SHIFT) | self._next
            self._next += 1
            self._buffers[handle] = arr
        return BufferPtr(self.node_id, handle, arr.nbytes)

    def adopt(self, handle: int, arr: np.ndarray) -> None:
        """Install ``arr`` under an externally-minted global ``handle`` —
        the receiving half of replication/migration.  Idempotent for a
        same-shape re-adopt (a replica refresh overwrites in place)."""
        with self._lock:
            self._buffers[int(handle)] = arr

    def adopt_empty(self, handle: int, shape, dtype) -> np.ndarray:
        arr = np.zeros(tuple(int(d) for d in shape), dtype=np.dtype(str(dtype)))
        self.adopt(handle, arr)
        return arr

    def holds(self, handle: int) -> bool:
        with self._lock:
            return int(handle) in self._buffers

    def deref(self, ptr: BufferPtr) -> np.ndarray:
        if ptr.node != self.node_id:
            raise OffloadError(
                f"dereferencing remote pointer (node {ptr.node}) on node "
                f"{self.node_id}: pointers are only valid in their own "
                "address space (paper §4.1)"
            )
        with self._lock:
            arr = self._buffers.get(ptr.handle)
        if arr is None:
            raise OffloadError(f"dangling buffer handle {ptr.handle}")
        return arr

    def flat(self, ptr: BufferPtr) -> np.ndarray:
        """1-D zero-copy view of a buffer — the put/get data plane addresses
        buffers by flat element offset (chunked transfers slice this view)."""
        return self.deref(ptr).reshape(-1)

    def free(self, ptr: BufferPtr) -> None:
        with self._lock:
            if self._buffers.pop(ptr.handle, None) is None:
                raise OffloadError(f"double free of handle {ptr.handle}")

    def discard(self, handle: int) -> bool:
        """Replica invalidation: drop ``handle`` if held.  Idempotent (an
        invalidate may race a free — both outcomes are 'copy gone')."""
        with self._lock:
            return self._buffers.pop(int(handle), None) is not None

    def live_count(self) -> int:
        with self._lock:
            return len(self._buffers)
