"""HAM-Offload public API (paper §2, Fig. 2).

``OffloadDomain`` owns one fabric's worth of nodes and exposes the paper's
surface::

    dom = OffloadDomain.local(num_nodes=2)     # threads-as-nodes
    ptr = dom.allocate(target, (1024,), "float64")
    dom.put(host_array, ptr)
    fut = dom.async_(target, f2f(inner_prod, a_ptr, b_ptr, n))
    c = fut.get()
    dom.shutdown()

Arbitrary offload patterns are supported: host->worker, worker->host
(*reverse offload*, via :func:`current_node` + ``send_async`` from inside a
handler), worker->worker, and one-hop relayed sends (*offload over fabric*).
"""

from __future__ import annotations

import numpy as np

from repro_torch.comm.base import Fabric
from repro_torch.comm.local import LocalFabric
from repro_torch.core.closure import Function, f2f
from repro_torch.core.errors import OffloadError
from repro_torch.core.executor import DirectPolicy
from repro_torch.core.future import _UNSET, Future, as_completed, gather
from repro_torch.core.message import encode_frame, FLAG_DYNAMIC, FLAG_STATIC
from repro_torch.core.registry import default_registry
from repro_torch.offload.buffer import BufferPtr
from repro_torch.offload.runtime import NodeRuntime, current_node


def deref(ptr: BufferPtr) -> np.ndarray:
    """Dereference a buffer pointer on its owning node (handler-side)."""
    return current_node().buffers.deref(ptr)


class OffloadDomain:
    """Host-side view of a set of offload targets."""

    def __init__(
        self,
        fabric: Fabric,
        *,
        host_node: int = 0,
        registry=None,
        inline_host: bool = False,
        policy_factory=DirectPolicy,
        direct_data_plane: bool = True,
        default_timeout: float | None = 30.0,
    ):
        self.fabric = fabric
        self.host_node = host_node
        #: default deadline for the blocking surface (sync/ping/barrier):
        #: a lost reply raises a diagnosis instead of blocking forever
        #: (docs/failure-model.md).  ``None`` = wait forever.
        self.default_timeout = default_timeout
        self.registry = registry or default_registry()
        table = self.registry.table  # must be init()ed by caller (paper §5.2)
        self.host = NodeRuntime(
            host_node, fabric.endpoint(host_node), table, inline=inline_host
        )
        if not inline_host:
            self.host.start()
        self._local_workers: list[NodeRuntime] = []
        self._policy_factory = policy_factory
        self._table = table
        #: same-address-space shortcut for put/get (paper §4.1 / the SCIF
        #: pre-mapped-window analogue): when the target node's runtime lives
        #: in THIS process, the data plane does direct loads/stores on the
        #: buffer instead of a wire round trip — one memcpy total.  Caveat:
        #: a direct put/get is NOT ordered behind still-queued async offloads
        #: to that node (the wire path is); callers needing that ordering
        #: sync on their futures first or pass ``direct_data_plane=False``.
        self.direct_data_plane = direct_data_plane
        self._inproc: dict[int, NodeRuntime] = {host_node: self.host}

    # -- construction helpers -------------------------------------------------

    @staticmethod
    def local(num_nodes: int, *, registry=None, inline_host: bool = False,
              policy_factory=DirectPolicy) -> "OffloadDomain":
        """All nodes in-process (threads) — intra-node offload."""
        fabric = LocalFabric(num_nodes)
        dom = OffloadDomain(
            fabric,
            registry=registry,
            inline_host=inline_host,
            policy_factory=policy_factory,
        )
        for node_id in range(num_nodes):
            if node_id != dom.host_node:
                worker = NodeRuntime(
                    node_id,
                    fabric.endpoint(node_id),
                    dom._table,
                    policy=policy_factory(),
                )
                worker.start()
                dom._local_workers.append(worker)
                dom._inproc[node_id] = worker
        return dom

    @property
    def num_nodes(self) -> int:
        return self.fabric.num_nodes

    def targets(self) -> list[int]:
        # fabric.nodes() rather than range(): elastic fabrics have holes
        # after remove_node, and retired ids must not be addressed
        return [n for n in self.fabric.nodes() if n != self.host_node]

    # -- RPC surface ------------------------------------------------------------

    def async_(self, node: int, function: Function) -> Future:
        """``offload::async`` — returns a future for the remote result."""
        return self.host.send_async(node, function)

    def sync(self, node: int, function: Function, timeout=_UNSET):
        """Blocking call; ``timeout`` omitted => :attr:`default_timeout`
        (``None`` = wait forever)."""
        if timeout is _UNSET:
            timeout = self.default_timeout
        return self.host.send_sync(node, function, timeout)

    def oneway(self, node: int, function: Function) -> None:
        self.host.send_oneway(node, function)

    def relay(self, via: int, dst: int, function: Function) -> Future:
        """Offload over fabric: request travels host -> via -> dst; the reply
        returns directly dst -> host (inner header keeps the origin)."""
        msg_id, fut = self.host.futures.create()
        key = self._table.key_of(function.record.stable_name)
        inner = encode_frame(
            key,
            function.pack_payload(),  # pack_static == WirePlan layout
            src_node=self.host_node,
            msg_id=msg_id,
            flags=FLAG_STATIC if function.is_static else FLAG_DYNAMIC,
        )
        self.host.send_oneway(via, f2f("_ham/forward", dst, bytes(inner),
                                       registry=self.registry))
        return fut

    # -- data plane (paper Fig. 2: allocate/put/get) -----------------------------

    def allocate(self, node: int, shape, dtype) -> BufferPtr:
        tag, n, handle, nbytes = self.sync(
            node,
            f2f("_ham/alloc", list(int(d) for d in shape), str(np.dtype(dtype)),
                registry=self.registry),
        )
        assert tag == "ptr"
        return BufferPtr(n, handle, nbytes)

    #: default transfer segment: put payloads above this are split into
    #: pipelined chunks, so transfers (a) always fit the shm ring window
    #: regardless of buffer size and (b) overlap the sender's pack-copy with
    #: the receiver's buffer-copy (measured ~5x on 64 MB puts).  Must fit the
    #: transport frame limit (shm ring capacity, default 16 MB); smaller
    #: chunks trade pipelining gain for per-segment round-trip overhead.
    chunk_nbytes: int = 8 << 20

    def put(self, src: np.ndarray, ptr: BufferPtr, *, offset: int = 0,
            chunk_nbytes: int | None = None) -> None:
        if self.direct_data_plane:
            rt = self._inproc.get(ptr.node)
            if rt is not None:  # direct store into the pre-mapped buffer

                def _store():
                    flat = rt.buffers.flat(ptr)
                    src_flat = np.ascontiguousarray(src).reshape(-1)
                    flat[offset : offset + src_flat.size] = src_flat.astype(
                        flat.dtype, copy=False
                    )

                self._run_direct(_store)
                return
        arr = np.ascontiguousarray(src)
        limit = self.chunk_nbytes if chunk_nbytes is None else chunk_nbytes
        # clamp to what the transport can move in one frame (shm ring size),
        # leaving headroom for the frame header + TLV prefix
        cap = getattr(self.host.endpoint, "max_frame_nbytes", None)
        if limit and cap:
            limit = min(limit, cap - 4096)
        if not limit or arr.nbytes <= limit:
            self.sync(
                ptr.node,
                f2f("_ham/put", ptr.node, ptr.handle, int(offset), arr,
                    registry=self.registry),
            )
            return
        # chunked pipeline: every segment is a zero-copy slice of `arr`,
        # packed straight into its frame; all segments are in flight at once
        flat = arr.reshape(-1)
        step = max(1, limit // arr.dtype.itemsize)
        futs = [
            self.async_(
                ptr.node,
                f2f("_ham/put", ptr.node, ptr.handle, int(offset + o),
                    flat[o : o + step], registry=self.registry),
            )
            for o in range(0, flat.size, step)
        ]
        self._wait_all(futs)

    def chain_put(self, src: np.ndarray, ptr: BufferPtr, hops, dirty: int,
                  *, offset: int = 0, chunk_nbytes: int | None = None,
                  timeout: float | None = 60.0) -> list[int]:
        """Chain-replicated put (``repro_torch.offload.dataplane``, "Chain
        replication"): the payload travels host -> ``ptr.node`` ONCE, as
        the same pipelined chunk stream as :meth:`put`, and ``ptr.node``
        forwards each chunk down ``hops`` over worker->worker links while
        the next chunk is still in flight.  ``dirty`` is the write epoch
        minted by ``BufferDirectory.begin_write``.  Returns the node ids
        that confirmed the COMPLETE write, primary first — a truncated
        list names exactly the stale tail.

        When every holder is in-process (``direct_data_plane``, thread
        workers) the chain degenerates to direct stores — the bytes are
        already in shared memory, so copying host -> each holder is
        strictly cheaper than framing a wire chain.  Otherwise the wire
        path runs: the chain forwarding executes in the primary's handler
        context."""
        arr = np.ascontiguousarray(src)
        hops = [int(h) for h in hops]
        if self.direct_data_plane:
            holders = [int(ptr.node), *hops]
            rts = [self._inproc.get(n) for n in holders]
            if all(rt is not None for rt in rts):
                src_flat = arr.reshape(-1)

                def _store():
                    for n, rt in zip(holders, rts):
                        flat = rt.buffers.flat(ptr.at(n))
                        flat[offset : offset + src_flat.size] = \
                            src_flat.astype(flat.dtype, copy=False)
                        rt.applied_dirty[int(ptr.handle)] = int(dirty)

                self._run_direct(_store)
                return holders
        limit = self.chunk_nbytes if chunk_nbytes is None else chunk_nbytes
        cap = getattr(self.host.endpoint, "max_frame_nbytes", None)
        if limit and cap:
            limit = min(limit, cap - 4096)
        flat = arr.reshape(-1)
        step = max(1, limit // max(1, arr.dtype.itemsize)) if limit \
            else max(1, flat.size)
        futs = []
        nchunks = 0
        if flat.size:
            futs = [
                self.async_(
                    ptr.node,
                    f2f("_ham/chain_put", int(ptr.handle), int(offset + o),
                        flat[o : o + step], hops, int(dirty),
                        registry=self.registry),
                )
                for o in range(0, flat.size, step)
            ]
            nchunks = len(futs)
        # the flush rides the same pipeline (per-link FIFO orders it behind
        # every chunk) — no extra round trip after the last chunk ack
        flush = self.async_(
            ptr.node,
            f2f("_ham/chain_flush", int(ptr.handle), hops, int(dirty),
                int(nchunks), registry=self.registry),
        )
        results = self._wait_all([*futs, flush], timeout)
        return [int(n) for n in results[-1]]

    def get(self, ptr: BufferPtr, *, offset: int = 0, count: int = -1,
            chunk_count: int | None = None) -> np.ndarray:
        """Fetch ``count`` elements from ``offset`` (whole, shaped buffer when
        ``count < 0``).  ``chunk_count`` (elements per segment) opts into a
        chunked, pipelined fetch — required when the flat reply would exceed
        the transport frame limit; the segments are reassembled host-side."""
        if self.direct_data_plane:
            rt = self._inproc.get(ptr.node)
            if rt is not None:  # direct load from the pre-mapped buffer

                def _load():
                    if count < 0 and not offset:
                        return rt.buffers.deref(ptr).copy()
                    flat = rt.buffers.flat(ptr)
                    view = (flat[offset:] if count < 0
                            else flat[offset : offset + count])
                    return view.copy()

                return self._run_direct(_load)
        if chunk_count and count >= 0 and count > chunk_count:
            futs = [
                self.async_(
                    ptr.node,
                    f2f("_ham/get", ptr.node, ptr.handle, int(offset + o),
                        int(min(chunk_count, count - o)),
                        registry=self.registry),
                )
                for o in range(0, count, chunk_count)
            ]
            chunks = self._wait_all(futs)
            out = np.empty(count, dtype=chunks[0].dtype)
            o = 0
            for c in chunks:
                out[o : o + c.size] = c
                o += c.size
            return out
        return self.sync(
            ptr.node,
            f2f("_ham/get", ptr.node, ptr.handle, int(offset), int(count),
                registry=self.registry),
        )

    @staticmethod
    def _run_direct(op):
        """Run a direct data-plane operation, surfacing every failure (bad
        handle, out-of-range slice, dtype mismatch) exactly as the wire path
        would — RemoteExecutionError — so callers see one error contract
        regardless of which plane served them."""
        try:
            return op()
        except Exception as e:  # noqa: BLE001 — mirror the remote-error wrap
            from repro_torch.core.errors import RemoteExecutionError

            raise RemoteExecutionError(f"{type(e).__name__}: {e}", "") from e

    def _wait_all(self, futs: list[Future], timeout: float | None = 60.0) -> list:
        """Results in submission order, waited in *completion* order: one
        shared deadline over the whole pipelined batch (chunked put/get,
        barriers) rather than a fresh timeout per future."""
        if self.host.inline:
            return [self.host._inline_wait(f, timeout) for f in futs]
        return gather(futs, timeout)

    def free(self, ptr: BufferPtr) -> None:
        self.sync(ptr.node, f2f("_ham/free", ptr.node, ptr.handle,
                                registry=self.registry))

    # -- control ------------------------------------------------------------------

    def ping(self, node: int, token: int = 0, timeout=_UNSET):
        if timeout is _UNSET:
            timeout = (10.0 if self.default_timeout is None
                       else min(10.0, self.default_timeout))
        return self.sync(node, f2f("_ham/ping", int(token),
                                   registry=self.registry), timeout)

    def barrier(self, timeout=_UNSET) -> None:
        if timeout is _UNSET:
            timeout = self.default_timeout
        futs = [
            self.async_(n, f2f("_ham/ping", 0, registry=self.registry))
            for n in self.targets()
        ]
        self._wait_all(futs, timeout)

    def shutdown(self, timeout: float = 5.0) -> None:
        for n in self.targets():
            try:
                self.oneway(n, f2f("_ham/terminate", registry=self.registry))
            except Exception:  # noqa: BLE001 — best-effort on teardown
                pass
        for w in self._local_workers:
            w.stop(timeout)
        self.host.stop(timeout)
        self.fabric.close()


def offloaded(*example_args, registry=None, name=None):
    """Decorator: register a function as an offload target with a static
    spec derived from example arguments (the ``Pars...``)."""

    def wrap(fn):
        reg = registry or default_registry()
        reg.handler(fn, args=example_args, name=name)
        return fn

    return wrap
