"""The port's counterpart of tests/test_comm.py and tests/test_doorbell.py.

Transport invariants: delivery, FIFO per pair, large frames — for every
backend (local threads / shm rings / loopback TCP).  Then the doorbell
wakeup: futex semantics, park/wake races, cross-process RTT (every
doorbell case carries the ``shm`` marker, as the reference's file does).
Tests force ``spin_budget=0`` so every receive actually parks."""

import os
import threading
import time
import uuid

import pytest

from repro_torch.comm.doorbell import Doorbell, bell_name, futex_available
from repro_torch.comm.local import LocalFabric
from repro_torch.comm.shm import RingConfig, ShmFabric, ShmRing
from repro_torch.comm.socket import SocketFabric
from repro_torch.core.errors import CommError


def _unique(stem):
    """A segment name no other process uses: /dev/shm is machine-wide, so
    two checkouts running this file at once must not meet on a fixed name."""
    return f"{stem}_{os.getpid()}_{uuid.uuid4().hex[:8]}"


@pytest.fixture(params=["local", "shm", "socket"])
def fabric(request):
    if request.param == "local":
        fab = LocalFabric(3)
    elif request.param == "shm":
        fab = ShmFabric(3, capacity=1 << 20)
    else:
        fab = SocketFabric(3)
    yield fab
    fab.close()


def test_point_to_point(fabric):
    a, b = fabric.endpoint(0), fabric.endpoint(1)
    a.send(1, b"hello")
    assert b.recv(timeout=5) == b"hello"


def test_fifo_per_pair(fabric):
    a, b = fabric.endpoint(0), fabric.endpoint(1)
    for i in range(100):
        a.send(1, bytes([i]))
    got = [b.recv(timeout=5)[0] for _ in range(100)]
    assert got == list(range(100))


def test_large_frame(fabric):
    a, b = fabric.endpoint(0), fabric.endpoint(2)
    blob = bytes(range(256)) * 2048  # 512 KB
    a.send(2, blob)
    assert b.recv(timeout=10) == blob


def test_recv_timeout(fabric):
    ep = fabric.endpoint(0)
    assert ep.recv(timeout=0.05) is None


def test_self_send_rejected(fabric):
    ep = fabric.endpoint(0)
    with pytest.raises(CommError):
        ep.send(0, b"loop")


def test_bidirectional(fabric):
    a, b = fabric.endpoint(0), fabric.endpoint(1)
    a.send(1, b"ping")
    assert b.recv(timeout=5) == b"ping"
    b.send(0, b"pong")
    assert a.recv(timeout=5) == b"pong"


def test_shm_ring_wraparound():
    name = _unique("test_torch_ring_wrap")
    ring = ShmRing(name, capacity=1 << 12, create=True)
    try:
        reader = ShmRing(name)
        # frames larger than half the ring force wrap-around handling
        for i in range(64):
            payload = bytes([i]) * 1500
            ring.push(payload, timeout=1.0)
            assert reader.try_pop() == payload
        reader.close()
    finally:
        ring.close()
        ring.unlink()


def test_shm_ring_full_detection():
    name = _unique("test_torch_ring_full")
    ring = ShmRing(name, capacity=1 << 10, create=True)
    try:
        ring.push(b"x" * 900, timeout=0.1)
        with pytest.raises(CommError):
            ring.push(b"y" * 900, timeout=0.05)  # no consumer: must time out
    finally:
        ring.close()
        ring.unlink()


# -- zero-copy lease protocol -------------------------------------------------


def test_shm_pop_view_aliases_ring_buffer():
    """The leased payload view must BE ring memory — no per-frame copy."""
    name = _unique("test_torch_ring_alias")
    ring = ShmRing(name, capacity=1 << 12, create=True)
    try:
        reader = ShmRing(name)
        ring.push(b"\xaa" * 32)
        lease = reader.try_pop_view()
        assert bytes(lease.view) == b"\xaa" * 32
        # mutate the shared segment underneath the view: an aliasing view
        # observes the store, a copied frame cannot
        from repro_torch.comm.shm import _HDR

        off = reader._tail() + 8  # frame data begins after the u64 length
        reader._buf[_HDR + off] = 0x55
        assert lease.view[0] == 0x55
        lease.release()
        assert reader._tail() == reader._head()
        del lease
        reader.close()
    finally:
        ring.close()
        ring.unlink()


def test_shm_zero_copy_wraparound_and_input_types():
    """Zero-copy push accepts bytes/bytearray/memoryview; frames straddling
    the wrap boundary still roundtrip (reassembled into a scratch copy)."""
    name = _unique("test_torch_ring_zcwrap")
    ring = ShmRing(name, capacity=1 << 12, create=True)
    try:
        reader = ShmRing(name)
        for i in range(64):
            payload = bytes([i]) * 1500  # >1/3 ring: forces wrap handling
            src = (payload, bytearray(payload), memoryview(payload))[i % 3]
            ring.push(src, timeout=1.0)
            lease = reader.try_pop_view()
            assert lease is not None
            assert bytes(lease.view) == payload
            lease.release()
            del lease
        reader.close()
    finally:
        ring.close()
        ring.unlink()


def test_shm_lease_backpressure():
    """Ring space is only reclaimed on release — an unreleased lease keeps
    the producer blocked even though the frame was consumed."""
    name = _unique("test_torch_ring_bp")
    ring = ShmRing(name, capacity=1 << 10, create=True)
    try:
        reader = ShmRing(name)
        ring.push(b"x" * 900, timeout=0.1)
        lease = reader.try_pop_view()
        assert lease is not None
        with pytest.raises(CommError):  # popped but NOT released: still full
            ring.push(b"y" * 900, timeout=0.05)
        lease.release()
        ring.push(b"y" * 900, timeout=0.5)  # space reclaimed
        lease2 = reader.try_pop_view()
        assert bytes(lease2.view) == b"y" * 900
        lease2.release()
        del lease, lease2
        reader.close()
    finally:
        ring.close()
        ring.unlink()


def test_shm_lease_out_of_order_release_rejected():
    name = _unique("test_torch_ring_ooo")
    ring = ShmRing(name, capacity=1 << 12, create=True)
    try:
        reader = ShmRing(name)
        ring.push(b"first")
        ring.push(b"second")
        a = reader.try_pop_view()
        b = reader.try_pop_view()
        with pytest.raises(CommError):
            b.release()  # younger lease first: rejected
        a.release()
        b.release()  # now in order
        with pytest.raises(CommError):
            b.release()  # double release
        del a, b
        reader.close()
    finally:
        ring.close()
        ring.unlink()


def test_shm_push_many_pop_many_batch():
    """N frames move under one head store / one lease (one tail store)."""
    name = _unique("test_torch_ring_batch")
    ring = ShmRing(name, capacity=1 << 14, create=True)
    try:
        reader = ShmRing(name)
        frames = [bytes([i]) * (i + 1) for i in range(50)]
        ring.push_many(frames, timeout=1.0)
        lease = reader.pop_many(max_frames=64)
        assert [bytes(v) for v in lease.views] == frames
        assert reader._tail() == 0  # nothing reclaimed until release
        lease.release()
        assert reader._tail() == reader._head()
        # batches larger than the ring are split transparently
        big = [b"z" * 3000 for _ in range(12)]  # 12*3008 > 16 KiB ring
        got = []

        def consume():
            r2 = ShmRing(name)
            while len(got) < 12:
                ls = r2.pop_many()
                if ls is not None:
                    got.extend(bytes(v) for v in ls.views)
                    ls.release()
            ls = None  # drop the last views before unmapping
            r2.close()

        t = threading.Thread(target=consume)
        t.start()
        ring.push_many(big, timeout=5.0)
        t.join(timeout=10)
        assert got == big
        del lease
        reader.close()
    finally:
        ring.close()
        ring.unlink()


def test_send_many_recv_many_roundtrip(fabric):
    """Coalesced batch API delivers the same frames, in order, per pair —
    on every backend (native batching on shm/socket, loop on local)."""
    a, b = fabric.endpoint(0), fabric.endpoint(1)
    frames = [bytes([i % 256]) * (1 + i % 97) for i in range(300)]
    a.send_many(1, frames)
    got = []
    deadline = 300
    while len(got) < len(frames) and deadline:
        batch = b.recv_many(max_frames=64, timeout=5)
        got.extend(bytes(f) for f in batch)
        batch = None  # leased views must not outlive the fabric
        b.release()
        deadline -= 1
    assert got == frames


def test_shm_nested_pop_with_outstanding_lease():
    """A copying try_pop while a lease is outstanding (the handler-recursing-
    into-recv case) must not corrupt FIFO order or the tail counter."""
    name = _unique("test_torch_ring_nested")
    ring = ShmRing(name, capacity=1 << 12, create=True)
    try:
        reader = ShmRing(name)
        ring.push(b"leased")
        ring.push(b"copied")
        ring.push(b"after")
        lease = reader.try_pop_view()
        assert bytes(lease.view) == b"leased"
        assert reader.try_pop() == b"copied"  # deferred behind the lease
        assert reader._tail() == 0  # nothing reclaimed yet
        lease.release()
        assert reader.try_pop() == b"after"
        assert reader._tail() == reader._head()
        del lease
        reader.close()
    finally:
        ring.close()
        ring.unlink()


@pytest.mark.fork
def test_shm_cross_process_wrap_heavy_frames():
    """Regression: true cross-process traffic with frames near half the ring
    (constant wrap + counter churn) must never desync the consumer's frame
    walk.  CPython can tear 8-byte counter stores on shared memory; the ring
    publishes each counter twice and readers require a stable pair."""
    import multiprocessing

    cap = 1 << 20
    name = _unique("test_torch_ring_xproc")
    ring = ShmRing(name, capacity=cap, create=True)

    def produce():
        w = ShmRing(name)
        payload = bytes(range(256)) * 1800  # ~460KB: wraps almost every frame
        for i in range(40):
            w.push_many([bytes([i]) + payload])
        w.close()

    p = multiprocessing.get_context("fork").Process(target=produce)
    p.start()
    try:
        got = 0
        expect_payload = bytes(range(256)) * 1800
        import time as _t

        deadline = _t.monotonic() + 30
        while got < 40:
            assert _t.monotonic() < deadline, f"stalled at frame {got}"
            lease = ring.pop_many(8)
            if lease is None:
                continue
            for v in lease.views:
                assert v.nbytes == 1 + len(expect_payload)
                assert v[0] == got
                assert bytes(v[1:]) == expect_payload
                got += 1
            lease.release()
        p.join(timeout=10)
        assert p.exitcode == 0
    finally:
        if p.is_alive():
            p.terminate()
        ring.close()
        ring.unlink()


def test_shm_concurrent_producer_consumer():
    name = _unique("test_torch_ring_spsc")
    ring = ShmRing(name, capacity=1 << 16, create=True)
    out = []

    def consume():
        reader = ShmRing(name)
        while len(out) < 500:
            f = reader.try_pop()
            if f is not None:
                out.append(f)
        reader.close()

    t = threading.Thread(target=consume)
    t.start()
    try:
        for i in range(500):
            ring.push(i.to_bytes(4, "little") * 8)
        t.join(timeout=10)
        assert len(out) == 500
        assert out[0][:4] == (0).to_bytes(4, "little")
        assert out[-1][:4] == (499).to_bytes(4, "little")
    finally:
        ring.close()
        ring.unlink()


# -- doorbell (counterpart of tests/test_doorbell.py) -------------------------

needs_futex = pytest.mark.skipif(
    not futex_available(), reason="futex syscall unavailable on this platform"
)

#: forces the park path on every receive — the spin phase is skipped
PARK_CFG = RingConfig(spin_budget=0, park_timeout=2e-3)


# -- Doorbell unit behaviour -------------------------------------------------


@pytest.mark.shm
@needs_futex
def test_wait_returns_immediately_on_stale_seq():
    """FUTEX_WAIT with a mismatched expected value must not block: this is
    the re-check that closes the arm->park race (a ring between arm and
    park changes seq, so the kernel refuses the wait with EAGAIN)."""
    name = _unique("test_torch_db_stale")
    bell = Doorbell(name, create=True)
    try:
        seq = bell.read_seq()
        bell.ring()  # seq moved on: a wait on the OLD value must not park
        t0 = time.monotonic()
        bell.wait(seq, timeout_s=1.0)
        assert time.monotonic() - t0 < 0.5
    finally:
        bell.close()
        bell.unlink()


@pytest.mark.shm
@needs_futex
def test_wait_times_out_on_current_seq():
    """No producer => the wait expires at the park timeout, not earlier
    (spurious immediate returns are allowed by futex(2) but a *systematic*
    early return would mean the expected-value plumbing is wrong)."""
    name = _unique("test_torch_db_timeout")
    bell = Doorbell(name, create=True)
    try:
        t0 = time.monotonic()
        bell.wait(bell.read_seq(), timeout_s=0.05)
        # generous lower bound: some kernels round the timespec down
        assert time.monotonic() - t0 >= 0.02
    finally:
        bell.close()
        bell.unlink()


@pytest.mark.shm
@needs_futex
def test_ring_wakes_parked_waiter():
    name = _unique("test_torch_db_wake")
    bell = Doorbell(name, create=True)
    woke = threading.Event()
    try:

        def park():
            bell.arm()
            try:
                # seq read BEFORE the wait: the protocol's ordering rule
                bell.wait(bell.read_seq(), timeout_s=5.0)
                woke.set()
            finally:
                bell.disarm()

        t = threading.Thread(target=park, daemon=True)
        t.start()
        time.sleep(0.05)  # let the waiter actually park
        bell.ring()
        assert woke.wait(timeout=2.0), "parked waiter never woke"
        t.join(timeout=2.0)
    finally:
        bell.close()
        bell.unlink()


@pytest.mark.shm
def test_ring_without_waiters_skips_syscall():
    """waiters==0 => ring() is just the seq bump (the common case must not
    pay a futex syscall); the seq still advances so a late armer re-polls."""
    name = _unique("test_torch_db_nowaiters")
    bell = Doorbell(name, create=True)
    try:
        before = bell.read_seq()
        for _ in range(3):
            bell.ring()
        assert bell.read_seq() == (before + 3) & 0xFFFFFFFF
    finally:
        bell.close()
        bell.unlink()


@pytest.mark.shm
def test_ring_config_roundtrip():
    cfg = RingConfig(spin_budget=7, sleep_quantum=1e-5, park_timeout=1e-3,
                     use_doorbell=False)
    assert RingConfig.from_dict(cfg.as_dict()) == cfg
    # empty dict => defaults (old spawn specs without a "ring" key)
    assert RingConfig.from_dict(None) == RingConfig()


@pytest.mark.shm
def test_bell_name_is_per_node():
    assert bell_name("p", 0) != bell_name("p", 1)
    assert bell_name("p", 3) == bell_name("p", 3)


# -- parked receive through the endpoint -------------------------------------


@pytest.mark.shm
def test_parked_recv_sees_frame_sent_after_park():
    """In-process two-endpoint fabric, spin_budget=0: the receiver is
    parked in FUTEX_WAIT when the frame lands; the producer's ring must
    wake it well before the 10s recv deadline."""
    fab = ShmFabric(2, config=PARK_CFG)
    try:
        a, b = fab.endpoint(0), fab.endpoint(1)
        got = []

        def rx():
            got.append(b.recv(timeout=10.0))

        t = threading.Thread(target=rx, daemon=True)
        t.start()
        time.sleep(0.05)  # receiver reaches the parked state
        a.send(1, b"\x01" * 64)
        t.join(timeout=5.0)
        assert not t.is_alive()
        assert got and bytes(got[0]) == b"\x01" * 64
        a.close()
        b.close()
    finally:
        fab.close()


@pytest.mark.shm
def test_parked_recv_deadline_still_honoured():
    """Parking must not stretch a recv timeout: with no producer, a 0.2s
    deadline expires in ~0.2s even though each park is 2ms."""
    fab = ShmFabric(2, config=PARK_CFG)
    try:
        b = fab.endpoint(1)
        t0 = time.monotonic()
        assert b.recv(timeout=0.2) is None
        dt = time.monotonic() - t0
        assert 0.15 <= dt < 2.0
        b.close()
    finally:
        fab.close()


@pytest.mark.shm
@pytest.mark.fork
def test_forked_parked_receiver_rtt_regression():
    """Cross-process ping-pong with every receive forced through the park
    path.  A lost wakeup costs one park_timeout (2 ms); systematic losses
    would push the median RTT to ~4 ms.  The pre-doorbell spin+sleep loop
    on a single-core box measured ~8 ms RTT — the 4 ms median bound fails
    for both pathologies while staying safe on loaded CI runners."""
    import multiprocessing
    import statistics

    fab = ShmFabric(2, config=PARK_CFG)
    n = 100

    def echo(prefix, num_nodes):
        from repro_torch.comm.shm import ShmEndpoint

        ep = ShmEndpoint(prefix, 1, num_nodes, peers=[0], config=PARK_CFG)
        try:
            for _ in range(n):
                frame = ep.recv(timeout=30.0)
                assert frame is not None
                ep.send(0, bytes(frame))
        finally:
            ep.close()

    proc = multiprocessing.get_context("fork").Process(
        target=echo, args=(fab.prefix, 2), daemon=True
    )
    proc.start()
    try:
        ep = fab.endpoint(0)
        rtts = []
        payload = b"\x5a" * 32
        for _ in range(n):
            t0 = time.perf_counter()
            ep.send(1, payload)
            reply = ep.recv(timeout=30.0)
            rtts.append(time.perf_counter() - t0)
            assert reply is not None and bytes(reply) == payload
        assert statistics.median(rtts) < 4e-3, (
            f"parked RTT median {statistics.median(rtts) * 1e6:.0f} us — "
            "doorbell wakeups are being lost (or park never wakes)"
        )
        ep.close()
    finally:
        from repro_torch.offload.worker import reap

        reap([proc], timeout=10.0)
        fab.close()


@pytest.mark.shm
@pytest.mark.fork
def test_no_lost_wakeups_under_bursty_producer():
    """Producer sends bursts separated by sleeps longer than the consumer's
    spin budget, so the consumer is parked at every burst arrival.  All
    frames must arrive well under the time lost-wakeup stalls would take
    (every burst eating a 2 ms park_timeout x 40 bursts = 80 ms floor;
    bound is far below drop-pathology territory)."""
    import multiprocessing

    fab = ShmFabric(2, config=PARK_CFG)
    bursts, per_burst = 40, 8

    def produce(prefix, num_nodes):
        from repro_torch.comm.shm import ShmEndpoint

        ep = ShmEndpoint(prefix, 0, num_nodes, peers=[1], config=PARK_CFG)
        try:
            for i in range(bursts):
                ep.send_many(1, [bytes([i]) * 16] * per_burst)
                time.sleep(0.002)  # consumer parks between bursts
        finally:
            ep.close()

    proc = multiprocessing.get_context("fork").Process(
        target=produce, args=(fab.prefix, 2), daemon=True
    )
    proc.start()
    try:
        ep = fab.endpoint(1)
        got = 0
        deadline = time.monotonic() + 30.0
        while got < bursts * per_burst:
            assert time.monotonic() < deadline, f"stalled at frame {got}"
            frames = ep.recv_many(max_frames=64, timeout=5.0)
            got += len(frames)
            ep.release()
        assert got == bursts * per_burst
        ep.close()
    finally:
        from repro_torch.offload.worker import reap

        reap([proc], timeout=10.0)
        fab.close()


# -- chaos: park/wake with delayed + reordered delivery ----------------------


@pytest.mark.shm
@pytest.mark.chaos
def test_parked_receiver_survives_chaos_delay_reorder():
    """Delay faults re-send frames from a timer thread — the doorbell ring
    then happens while the receiver may be mid-park on a seq read before
    the original send.  Reorder shuffles batch order.  Every frame must
    still arrive exactly once with the receiver forced through the park
    path on every poll (no lost wakeups under out-of-band producers)."""
    from repro_torch.comm.chaos import ChaosConfig, ChaosFabric

    inner = ShmFabric(2, config=PARK_CFG)
    chaos = ChaosFabric(inner, seed=11,
                        default=ChaosConfig(delay=0.3, reorder=0.3,
                                            delay_s=0.004))
    n = 120
    try:
        a, b = chaos.endpoint(0), chaos.endpoint(1)
        chaos.arm()
        got = []

        def rx():
            deadline = time.monotonic() + 30.0
            while len(got) < n and time.monotonic() < deadline:
                frame = b.recv(timeout=1.0)
                if frame is not None:
                    got.append(bytes(frame))

        t = threading.Thread(target=rx, daemon=True)
        t.start()
        for i in range(n):
            a.send(1, i.to_bytes(4, "little") * 8)
            if i % 16 == 0:
                time.sleep(0.003)  # let the receiver drain and re-park
        t.join(timeout=30.0)
        chaos.disarm()
        assert not t.is_alive()
        assert len(got) == n, f"got {len(got)}/{n} frames under chaos"
        # no duplication either: delay re-sends the SAME frame once
        assert sorted(got) == sorted(
            i.to_bytes(4, "little") * 8 for i in range(n)
        )
        a.close()
        b.close()
    finally:
        chaos.close()


# -- the socket fabric's reserved port region ---------------------------------------


def test_socket_fabric_holds_its_region():
    """The region stays reserved until the fabric closes: a plain bind of
    one of its ports fails, while the fabric's endpoint binds and listens
    there."""
    import socket

    fab = SocketFabric(2)
    try:
        outsider = socket.socket()
        with pytest.raises(OSError):
            outsider.bind((fab.host, fab.base_port + 1))
        outsider.close()
        a, b = fab.endpoint(0), fab.endpoint(1)
        a.send(1, b"held")
        assert b.recv(timeout=5) == b"held"
    finally:
        fab.close()
    assert not fab._held


def test_socket_fabric_skips_a_port_held_inside_the_probed_region(monkeypatch):
    """A port inside the probed region already taken by another socket (a
    listener, as another fabric's endpoint would be) makes the fabric probe
    again, and the fabric it builds works; the reference's probed port +
    1000 would have handed that port to an endpoint, which then fails with
    ``Address already in use``."""
    import socket

    from repro_torch.comm import socket as sock_mod

    lock = socket.socket()
    lock.bind(("127.0.0.1", 0))
    taken = socket.socket()
    taken.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        taken.bind(("127.0.0.1", lock.getsockname()[1] + 2))
    except OSError:
        pytest.skip("the port next to the probe is in use")
    taken.listen(1)
    probes = [lock]
    real = sock_mod._probe_socket
    monkeypatch.setattr(sock_mod, "_probe_socket",
                        lambda host: probes.pop() if probes else real(host))
    fab = SocketFabric(3)
    try:
        assert not probes, "the fabric did not take the planted probe"
        region = range(fab.base_port, fab.base_port + 3 + SocketFabric.GROW_HEADROOM)
        assert taken.getsockname()[1] not in region
        eps = [fab.endpoint(i) for i in range(3)]
        eps[0].send(2, b"x")
        assert eps[2].recv(timeout=5) == b"x"
    finally:
        fab.close()
        taken.close()
