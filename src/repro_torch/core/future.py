"""Futures for asynchronous offloads (paper §2: ``offload::async`` returns a
``future<double>``; §4.3: ``offload_result_msg`` routes the result back).

A :class:`FutureTable` correlates reply messages with outstanding futures via
the 64-bit ``msg_id`` in the frame header.  Each future remembers its
``msg_id`` so higher layers (the cluster scheduler) can cancel/fail a
specific in-flight call through the table — popping the entry there means a
stale reply from a dead-then-restarted worker is dropped instead of
resurrecting an already-failed future.

:func:`as_completed` turns a set of futures into a completion-order stream —
the pipelining primitive: callers harvest results as replies arrive instead
of serialising on submission order.
"""

from __future__ import annotations

import itertools
import queue as _queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator

from repro_torch.core.errors import OffloadError, RemoteExecutionError

_UNSET = object()  # "use the default" sentinel (None must keep meaning forever)


class Future:
    """Single-assignment result container with blocking ``get``.

    Two wait surfaces: :meth:`get` (``timeout=None`` waits forever — the
    paper's blocking semantics, raises ``TimeoutError`` on expiry) and
    :meth:`result`, which defaults to :attr:`default_timeout` and raises an
    :class:`OffloadError` *diagnosis* instead of blocking forever on a lost
    reply — the failure-model surface (docs/failure-model.md).
    """

    __slots__ = ("_event", "_result", "_error", "_callbacks", "_lock", "msg_id")

    #: class-wide default for :meth:`result` (seconds; None = wait forever).
    #: Assign ``Future.default_timeout = ...`` to retune a whole process.
    default_timeout: float | None = 60.0

    def __init__(self):
        self._event = threading.Event()
        self._result: Any = None
        self._error: BaseException | None = None
        self._callbacks: list[Callable[["Future"], None]] = []
        self._lock = threading.Lock()
        #: reply-correlation id in the owning FutureTable (0 = untracked)
        self.msg_id: int = 0

    def done(self) -> bool:
        return self._event.is_set()

    def set_result(self, value: Any) -> None:
        with self._lock:
            self._result = value
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            cb(self)

    def set_exception(self, exc: BaseException) -> None:
        with self._lock:
            self._error = exc
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            cb(self)

    def add_done_callback(self, cb: Callable[["Future"], None]) -> None:
        run_now = False
        with self._lock:
            if self._event.is_set():
                run_now = True
            else:
                self._callbacks.append(cb)
        if run_now:
            cb(self)

    def get(self, timeout: float | None = None) -> Any:
        """Block until the result message arrives (``result.get()``)."""
        if not self._event.wait(timeout):
            raise TimeoutError("future did not complete in time")
        if self._error is not None:
            raise self._error
        return self._result

    def result(self, timeout=_UNSET):
        """Like :meth:`get`, but bounded by default: waits at most
        ``timeout`` (omitted => :attr:`default_timeout`; ``None`` = forever)
        and expiry raises an :class:`OffloadError` diagnosis — a lost reply
        surfaces as an explained failure, not an eternal block.  The future
        stays pending: a late reply can still resolve it."""
        if timeout is _UNSET:
            timeout = self.default_timeout
        if self._event.wait(timeout):
            if self._error is not None:
                raise self._error
            return self._result
        raise OffloadError(
            f"no reply within {timeout}s (msg_id {self.msg_id}): the call "
            "may still be executing, its reply may be lost, or the worker "
            "may be partitioned.  Submit with a deadline/retries through "
            "the scheduler for at-least-a-diagnosis semantics — delivery "
            "guarantees per path are in docs/failure-model.md"
        )

    def exception(self) -> BaseException | None:
        """The stored error of a completed future (None while pending/ok)."""
        return self._error


def as_completed(
    futures: Iterable[Future], timeout: float | None = None
) -> Iterator[Future]:
    """Yield ``futures`` in *completion* order — the pipelining iterator.

    Like ``concurrent.futures.as_completed``: each yielded future is done
    (its ``get(0)`` returns immediately), so a caller draining a fan-out of
    offloads overlaps its own post-processing with the still-in-flight
    remainder.  ``timeout`` bounds the total wait across all futures;
    expiry raises :class:`TimeoutError` with the undone count.

    Requires someone else (an event-loop thread) to resolve the futures —
    do not use from an ``inline`` host, which pumps its own endpoint.
    """
    futs = list(futures)
    done_q: _queue.SimpleQueue[Future] = _queue.SimpleQueue()
    for f in futs:
        f.add_done_callback(done_q.put)  # runs immediately if already done
    deadline = None if timeout is None else time.monotonic() + timeout
    for i in range(len(futs)):
        remaining = None if deadline is None else deadline - time.monotonic()
        if remaining is not None and remaining <= 0:
            raise TimeoutError(
                f"{len(futs) - i} of {len(futs)} futures undone at timeout"
            )
        try:
            yield done_q.get(timeout=remaining)
        except _queue.Empty:
            raise TimeoutError(
                f"{len(futs) - i} of {len(futs)} futures undone at timeout"
            ) from None


def gather(futures: Iterable[Future], timeout: float | None = None) -> list:
    """Results of ``futures`` in *submission* order, waiting in completion
    order — one shared deadline instead of per-future timeouts, and
    **fail-fast**: the first future to complete with an error raises it
    immediately (a hung sibling must not bury a real remote error under a
    generic deadline TimeoutError)."""
    futs = list(futures)
    for f in as_completed(futs, timeout):
        exc = f.exception()
        if exc is not None:
            raise exc
    return [f.get(0) for f in futs]


class FutureTable:
    """msg_id -> Future correlation for reply routing."""

    def __init__(self):
        self._counter = itertools.count(1)
        self._lock = threading.Lock()
        self._pending: dict[int, Future] = {}

    def create(self) -> tuple[int, Future]:
        fut = Future()
        msg_id = next(self._counter)
        fut.msg_id = msg_id
        with self._lock:
            self._pending[msg_id] = fut
        return msg_id, fut

    def resolve(self, msg_id: int, value: Any) -> bool:
        with self._lock:
            fut = self._pending.pop(msg_id, None)
        if fut is None:
            return False
        fut.set_result(value)
        return True

    def reject(self, msg_id: int, message: str, remote_traceback: str = "") -> bool:
        with self._lock:
            fut = self._pending.pop(msg_id, None)
        if fut is None:
            return False
        fut.set_exception(RemoteExecutionError(message, remote_traceback))
        return True

    def discard(self, msg_id: int) -> bool:
        """Drop a pending entry WITHOUT completing the future — for a
        created-but-never-sent msg_id (e.g. a scheduler that reserved a
        future, then lost its target to a membership fence before sending).
        A later reply for the id is ignored; safe if already completed."""
        with self._lock:
            return self._pending.pop(msg_id, None) is not None

    def fail_all(self, exc: BaseException) -> int:
        """Reject every outstanding future (node-death path)."""
        with self._lock:
            pending, self._pending = self._pending, {}
        for fut in pending.values():
            fut.set_exception(exc)
        return len(pending)

    def outstanding(self) -> int:
        with self._lock:
            return len(self._pending)
