"""TCP/IP fabric — the paper's TCP backend class, length-prefixed frames.

Connections are established lazily per (src, dst) pair; each endpoint runs a
listener plus one reader thread per inbound connection feeding a single
inbox.  Slowest backend, but the only one that crosses machine boundaries —
used in tests to prove the wire protocol is process-image independent
(heterogeneous binaries: a worker launched as a fresh interpreter).

Hot path:

* sends are *gathered* — ``sendmsg`` writes ``len || frame`` (and, for
  ``send_many``, a whole batch of them) in one syscall with no
  concatenation copy;
* the reader is *buffered* — one big ``recv_into`` per syscall, then every
  complete frame in the buffer is sliced out, so under load one syscall
  yields many frames; frames larger than the buffer are streamed straight
  into their own allocation (no repeated buffer growth).
"""

from __future__ import annotations

import queue
import socket
import struct
import threading

from repro_torch.comm.base import CommBackend, Fabric, as_byte_view as _as_view
from repro_torch.core.errors import CommError

_LEN = struct.Struct("<Q")
_RECV_BUF = 1 << 18  # reader syscall granularity
_IOV_BATCH = 512     # conservative cap under Linux IOV_MAX (1024)


def _recv_exact_into(sock: socket.socket, view: memoryview, got: int = 0) -> bool:
    n = view.nbytes
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if k == 0:
            return False
        got += k
    return True


def _sendv(sock: socket.socket, buffers: list) -> None:
    """Gathered send of all ``buffers``, handling partial writes."""
    views = [_as_view(b) for b in buffers]
    while views:
        sent = sock.sendmsg(views[:_IOV_BATCH])
        while views and sent >= views[0].nbytes:
            sent -= views[0].nbytes
            views.pop(0)
        if sent and views:
            views[0] = views[0][sent:]


class SocketEndpoint(CommBackend):
    def __init__(
        self,
        node_id: int,
        num_nodes: int,
        base_port: int,
        host: str = "127.0.0.1",
    ):
        self.node_id = node_id
        self.num_nodes = num_nodes
        self._host = host
        self._base_port = base_port
        self._removed: set[int] = set()  # retired peers: fail fast, never dial
        self._inbox: queue.SimpleQueue = queue.SimpleQueue()
        self._out: dict[int, socket.socket] = {}
        self._out_lock = threading.Lock()
        self._send_locks: dict[int, threading.Lock] = {}
        self._closing = threading.Event()

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, base_port + node_id))
        self._listener.listen(num_nodes)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"ham-sock-accept-{node_id}", daemon=True
        )
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._closing.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(
                target=self._read_loop, args=(conn,), daemon=True
            ).start()

    def _read_loop(self, conn: socket.socket) -> None:
        """Buffered reader: one recv syscall can yield many frames."""
        pending = bytearray()
        scratch = memoryview(bytearray(_RECV_BUF))
        try:
            while True:
                k = conn.recv_into(scratch)
                if k == 0:
                    return
                pending += scratch[:k]
                # slice out every complete frame already in the buffer
                mv = memoryview(pending)
                total = len(pending)
                off = 0
                while total - off >= _LEN.size:
                    (n,) = _LEN.unpack_from(mv, off)
                    if total - off - _LEN.size < n:
                        break
                    self._inbox.put(bytes(mv[off + 8 : off + 8 + n]))
                    off += 8 + n
                mv.release()
                if off:
                    del pending[:off]
                # oversized frame: stream the remainder straight into its
                # final buffer instead of growing `pending` chunk by chunk
                if len(pending) >= _LEN.size:
                    (n,) = _LEN.unpack_from(pending, 0)
                    if n > _RECV_BUF:
                        frame = bytearray(n)
                        have = len(pending) - 8
                        frame[:have] = memoryview(pending)[8:]
                        del pending[:]
                        if not _recv_exact_into(conn, memoryview(frame), have):
                            return
                        self._inbox.put(frame)
        except OSError:
            return

    def _connect(self, dst: int) -> socket.socket:
        with self._out_lock:
            sock = self._out.get(dst)
            if sock is not None:
                return sock
            # the peer's listener may not be up yet (a fresh-interpreter
            # worker can take seconds to import): time-bounded retry, and a
            # mid-handshake abort/reset gets a fresh socket rather than
            # escaping the loop
            import time

            deadline = time.monotonic() + 15.0
            while True:
                sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                try:
                    sock.connect((self._host, self._base_port + dst))
                    break
                except (ConnectionRefusedError, ConnectionAbortedError,
                        ConnectionResetError, TimeoutError):
                    sock.close()
                    if time.monotonic() > deadline:
                        raise CommError(f"cannot connect to node {dst}") from None
                    time.sleep(0.02)
            self._out[dst] = sock
            self._send_locks[dst] = threading.Lock()
            return sock

    def send(self, dst: int, frame) -> None:
        self._check_dst(dst)
        sock = self._connect(dst)
        mv = _as_view(frame)
        try:
            with self._send_locks[dst]:
                _sendv(sock, [_LEN.pack(mv.nbytes), mv])
        except OSError as e:
            raise CommError(f"send to node {dst} failed: {e}") from e

    def send_many(self, dst: int, frames) -> None:
        """One gathered syscall per ~256 frames: ``len||frame`` iovec pairs."""
        self._check_dst(dst)
        sock = self._connect(dst)
        iov: list = []
        for frame in frames:
            mv = _as_view(frame)
            iov.append(_LEN.pack(mv.nbytes))
            iov.append(mv)
        try:
            with self._send_locks[dst]:
                _sendv(sock, iov)
        except OSError as e:
            raise CommError(f"send to node {dst} failed: {e}") from e

    def reset_peer(self, dst: int) -> None:
        """Forget the cached outbound connection to ``dst``: the next send
        redials, reaching the replacement process listening on dst's port."""
        with self._out_lock:
            sock = self._out.pop(dst, None)
            self._send_locks.pop(dst, None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _check_dst(self, dst: int) -> None:
        if dst in self._removed:
            from repro_torch.core.errors import CommError as _CE

            raise _CE(f"destination {dst} was removed from the fabric")
        super()._check_dst(dst)

    def attach_peer(self, node_id: int) -> None:
        """Widen the valid-destination range (connections are dialled lazily
        by port, so a new peer needs no resources until the first send)."""
        self._removed.discard(node_id)
        self.num_nodes = max(self.num_nodes, node_id + 1)

    def detach_peer(self, node_id: int) -> None:
        """Retire a peer: close any cached connection and refuse later sends
        toward the id (ids are never reused)."""
        self._removed.add(node_id)
        self.reset_peer(node_id)

    def recv(self, timeout: float | None = None) -> bytes | None:
        try:
            return self._inbox.get(timeout=timeout)
        except queue.Empty:
            return None

    def recv_many(self, max_frames: int = 64, timeout: float | None = None) -> list:
        """Drain up to ``max_frames`` from the inbox (frames are owned)."""
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

    def close(self) -> None:
        self._closing.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._out_lock:
            for sock in self._out.values():
                try:
                    sock.close()
                except OSError:
                    pass


def _probe_socket(host: str) -> socket.socket:
    """A socket bound to a free port the kernel picks (no SO_REUSEADDR)."""
    probe = socket.socket()
    probe.bind((host, 0))
    return probe


def _reserve_ports(host: str, count: int) -> tuple[int, list]:
    """Reserve ``count`` contiguous ports and return (first port, the
    sockets holding them).  A probe socket keeps the port just below the
    region (bound without SO_REUSEADDR); every port of the region is bound,
    not listening, with SO_REUSEADDR.  Endpoints (SO_REUSEADDR) bind and
    listen over a holder, in this process or another; a connect() never
    takes a bound port as its ephemeral port; and another fabric's region
    that overlaps this one meets the probe socket or a listener and fails
    to bind, so it probes again."""
    while True:
        lock = _probe_socket(host)
        first = lock.getsockname()[1] + 1
        held = [lock]
        try:
            if first + count > 65536:
                raise OSError("region past the port range")
            for port in range(first, first + count):
                hold = socket.socket()
                held.append(hold)
                hold.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                hold.bind((host, port))
        except OSError:
            for sock in held:
                sock.close()
            continue
        return first, held


class SocketFabric(Fabric):
    """Same-host fabric over loopback TCP (endpoints may live anywhere that
    can reach ``host:base_port+i``).

    Without a ``base_port`` the fabric reserves its region
    (:func:`_reserve_ports`) and holds it until :meth:`close`: the
    reference takes a probed port + 1000 and binds nothing, so another
    process's connection or fabric can take a port of the region before its
    endpoint listens (``Address already in use`` under ``pytest -n 6``)."""

    #: ports reserved past the initial node count so add_node stays inside
    #: the reserved region
    GROW_HEADROOM = 64

    def __init__(self, num_nodes: int, base_port: int = 0, host: str = "127.0.0.1"):
        self.num_nodes = num_nodes
        self.host = host
        self._held: list[socket.socket] = []
        if base_port == 0:
            base_port, self._held = _reserve_ports(host, num_nodes + self.GROW_HEADROOM)
        self.base_port = base_port
        self._endpoints: dict[int, SocketEndpoint] = {}
        self._nodes: set[int] = set(range(num_nodes))
        self._next_id = num_nodes

    def endpoint(self, node_id: int) -> SocketEndpoint:
        if node_id not in self._endpoints:
            self._endpoints[node_id] = SocketEndpoint(
                node_id, self.num_nodes, self.base_port, self.host
            )
        return self._endpoints[node_id]

    def nodes(self) -> list[int]:
        return sorted(self._nodes)

    def add_node(self) -> int:
        node_id = self._next_id
        if self.base_port + node_id > 65535:
            raise CommError(
                f"cannot add node {node_id}: port {self.base_port + node_id} "
                "out of range"
            )
        self._next_id += 1
        self._nodes.add(node_id)
        self.num_nodes = max(self.num_nodes, node_id + 1)
        return node_id

    def remove_node(self, node_id: int) -> None:
        self._nodes.discard(node_id)
        ep = self._endpoints.pop(node_id, None)
        if ep is not None:
            ep.close()

    def close(self) -> None:
        for ep in self._endpoints.values():
            ep.close()
        for sock in self._held:
            sock.close()
        self._held = []
