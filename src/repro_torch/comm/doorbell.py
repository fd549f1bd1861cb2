"""Spin-then-park doorbell for the shm fabric.

The shm rings are pure shared-memory SPSC queues: nothing in the data path
tells a sleeping receiver that a frame was published, so before this module
the receiver's only options were to burn CPU spinning or to sleep a fixed
quantum (1e-4 s) and eat that as wakeup latency.  On a single-core host the
spin is worse than useless -- ``time.sleep(0)`` does not yield the core in
CPython, so a spinning receiver holds the CPU for a full scheduler tick
(~4 ms) while the sender it is waiting for starves.

A :class:`Doorbell` is a tiny shared-memory segment -- one per consumer
node -- holding a futex word:

    offset 0: u32 ``seq``      bumped by a producer after it publishes a frame
    offset 4: u32 ``waiters``  nonzero while the consumer is parked (or about
                               to park); producers skip the wake syscall when
                               it is zero, keeping the un-contended send path
                               at two struct ops and no syscalls

The consumer protocol (see ``docs/transport.md`` for the memory-ordering
argument) is: spin for a budget, then *arm* (waiters=1), re-read ``seq``,
re-poll the rings once, and only then ``FUTEX_WAIT(seq, observed)`` with a
bounded timeout.  The re-poll closes the publish-before-arm window; the
``seq`` compare-on-entry closes the publish-after-repoll window (the kernel
returns EAGAIN instead of sleeping); and the timeout bounds the residual
races that pure-Python non-atomic counters cannot close (two producers
tearing each other's ``seq`` increment, a producer reading ``waiters`` just
before the consumer stores 1).  A lost wakeup therefore costs at most
``park_timeout`` (default 2 ms), never a hang.

Futexes are reached through ``ctypes``/``syscall(2)`` -- no extension module
and no new dependency.  Where the syscall is unavailable (non-Linux, odd
libc, unknown architecture) :func:`futex_available` reports False after an
import-time-style self-probe and callers degrade to the adaptive-spin path.
An ``eventfd`` fallback was considered and rejected: an eventfd is a file
descriptor, which fork-inherits but cannot be re-opened by name from a
fresh interpreter, and every shm worker spawn path here supports
attach-by-name.  The futex word lives in named shared memory, so it works
for both spawn styles with one code path.
"""

from __future__ import annotations

import ctypes
import errno
import os
import platform
import struct
from multiprocessing import shared_memory

__all__ = [
    "CONSUMER_PARK_PROTOCOL",
    "Doorbell",
    "PRODUCER_RING_PROTOCOL",
    "SEQ_OFF",
    "WAITERS_OFF",
    "futex_available",
    "futex_wait",
    "futex_wake",
]

_U32 = struct.Struct("<I")

# Word layout and protocol step orders.  These are the single source of
# truth shared with the exhaustive-interleaving model (the reference's
# ``repro.analysis.models.doorbell``): the model builds its transition system
# from these tuples, so an implementation reorder that reopens a lost-wakeup
# window (the publish-before-arm / publish-after-repoll races) changes the
# model too and the checker finds the stranded park.
SEQ_OFF = 0
WAITERS_OFF = 4

#: producer step order in :meth:`Doorbell.ring` (after the ring push that
#: precedes it): bump ``seq`` (non-atomic RMW), then read ``waiters``, then
#: the conditional FUTEX_WAKE
PRODUCER_RING_PROTOCOL = ("publish", "bump_seq", "read_waiters", "wake_if_armed")

#: consumer step order in the shm endpoints' spin-then-park loop: arm
#: (waiters=1), snapshot ``seq``, MANDATORY ring re-poll, and only then the
#: compare-on-entry FUTEX_WAIT on the pre-poll snapshot.  The snapshot MUST
#: precede the re-poll: a publish that lands between them bumps ``seq`` and
#: FUTEX_WAIT refuses to sleep (EAGAIN) instead of stranding the park.
CONSUMER_PARK_PROTOCOL = ("arm", "read_seq", "repoll", "wait_if_unchanged")

_SEQ_OFF = SEQ_OFF
_WAITERS_OFF = WAITERS_OFF

# futex(2) operation codes.  Deliberately NOT using FUTEX_PRIVATE_FLAG: the
# word lives in shared memory mapped by unrelated processes, so the futex
# must hash on the physical page, not the per-mm address.
_FUTEX_WAIT = 0
_FUTEX_WAKE = 1

# syscall numbers vary per architecture; the generic syscall table (used by
# aarch64/riscv64) assigns 98, legacy tables differ.
_SYS_FUTEX = {
    "x86_64": 202,
    "aarch64": 98,
    "arm64": 98,
    "riscv64": 98,
    "armv7l": 240,
    "i686": 240,
    "ppc64le": 221,
    "s390x": 238,
}.get(platform.machine())


class _Timespec(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long), ("tv_nsec", ctypes.c_long)]


_libc = None
_available = None


def _load_libc():
    global _libc
    if _libc is None:
        _libc = ctypes.CDLL(None, use_errno=True)
    return _libc


def _futex(addr: int, op: int, val: int, timeout_s: float | None) -> int:
    """Raw futex syscall; returns 0 on success, -errno on failure."""
    libc = _load_libc()
    if timeout_s is None:
        ts = None
    else:
        sec = int(timeout_s)
        ts = ctypes.byref(_Timespec(sec, int((timeout_s - sec) * 1e9)))
    ret = libc.syscall(
        _SYS_FUTEX, ctypes.c_void_p(addr), op, ctypes.c_uint(val), ts, None, 0
    )
    if ret == -1:
        return -ctypes.get_errno()
    return ret


def futex_available() -> bool:
    """Self-probe: does FUTEX_WAIT with a mismatched expected value EAGAIN?

    Probing (rather than trusting ``sys.platform``) catches seccomp filters,
    emulation layers, and unknown-architecture syscall numbers in one shot.
    The probe word is private process memory -- futex does not care where
    the page lives.
    """
    global _available
    if _available is None:
        if _SYS_FUTEX is None or not hasattr(os, "sched_yield"):
            _available = False
        else:
            try:
                word = ctypes.c_uint(7)
                rc = _futex(ctypes.addressof(word), _FUTEX_WAIT, 99, None)
                _available = rc == -errno.EAGAIN
            except Exception:
                _available = False
    return _available


def futex_wait(addr: int, expected: int, timeout_s: float | None) -> int:
    """Park until woken, timed out, or ``*addr != expected`` on entry.

    Returns 0 on wake, -EAGAIN if the word already changed, -ETIMEDOUT on
    timeout, -EINTR on signal.  All are "go re-poll" to the caller.
    """
    return _futex(addr, _FUTEX_WAIT, expected, timeout_s)


def futex_wake(addr: int, n: int = 2**31 - 1) -> int:
    """Wake up to ``n`` waiters parked on the word (default: all)."""
    return _futex(addr, _FUTEX_WAKE, n, None)


def bell_name(prefix: str, node: int) -> str:
    """Shared-memory name of node ``node``'s inbound doorbell."""
    return f"{prefix}_db_{node}"


class Doorbell:
    """A named futex word + waiter flag in shared memory.

    One doorbell exists per *consumer* node; every producer that pushes a
    frame to any of that node's inbound rings rings the same bell.  The
    segment is created by the fabric (which owns ring lifetimes already)
    and attached by name from endpoints, including endpoints built inside
    freshly spawned interpreters.
    """

    NBYTES = 8

    def __init__(self, name: str, *, create: bool = False):
        self.name = name
        self._shm = shared_memory.SharedMemory(
            name=name, create=create, size=self.NBYTES
        )
        buf = self._shm.buf
        if create:
            buf[: self.NBYTES] = b"\x00" * self.NBYTES
        self._buf = buf
        # Stable address of the futex word for the lifetime of the mapping.
        self._addr = ctypes.addressof(ctypes.c_char.from_buffer(buf, _SEQ_OFF))
        self._closed = False

    # -- producer side -----------------------------------------------------
    def ring(self) -> None:
        """Publish 'new frames may exist' and wake the consumer if parked.

        The seq bump is a plain read-modify-write (Python offers no atomic
        RMW on shared memory); concurrent producers can tear it, collapsing
        two bumps into one.  That is safe: the wake below is keyed on the
        waiters flag, not on seq, and a consumer that misses a seq change
        still re-polls within ``park_timeout``.
        """
        buf = self._buf
        (seq,) = _U32.unpack_from(buf, _SEQ_OFF)
        _U32.pack_into(buf, _SEQ_OFF, (seq + 1) & 0xFFFFFFFF)
        (waiters,) = _U32.unpack_from(buf, _WAITERS_OFF)
        if waiters:
            futex_wake(self._addr)

    # -- consumer side -----------------------------------------------------
    def read_seq(self) -> int:
        (seq,) = _U32.unpack_from(self._buf, _SEQ_OFF)
        return seq

    def arm(self) -> None:
        """Announce intent to park.  MUST be followed by a ring re-poll
        before :meth:`wait` -- see the protocol note in the module doc."""
        _U32.pack_into(self._buf, _WAITERS_OFF, 1)

    def disarm(self) -> None:
        _U32.pack_into(self._buf, _WAITERS_OFF, 0)

    def wait(self, expected_seq: int, timeout_s: float) -> int:
        """Park until rung, ``seq`` drift, timeout, or signal."""
        return futex_wait(self._addr, expected_seq, timeout_s)

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        # Drop the exported pointer before closing the mapping, else the
        # BufferError path leaks the whole segment mapping.
        self._addr = 0
        self._buf = None
        try:
            self._shm.close()
        except BufferError:  # pragma: no cover - defensive
            pass

    def unlink(self) -> None:
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass

    def __del__(self):  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:
            pass
