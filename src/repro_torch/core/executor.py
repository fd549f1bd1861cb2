"""Execution policies (paper §4.3): how a received active message is run.

"In its most basic implementation the policy will simply execute the message
by calling its call operator, while a more sophisticated runtime might for
instance use a policy that puts the message into a queue for a pool of worker
threads."  — we provide exactly those three policies.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable

Task = Callable[[], Any]


class ExecutionPolicy:
    """Interface: ``submit`` a zero-arg task executing one active message."""

    def submit(self, task: Task) -> None:
        raise NotImplementedError

    def drain(self) -> int:
        """Run queued work to completion (no-op for eager policies)."""
        return 0

    def shutdown(self) -> None:
        pass


class DirectPolicy(ExecutionPolicy):
    """Execute inline on the receiving thread — the paper's basic policy.

    Lowest latency; used for the offload-overhead microbenchmarks.
    """

    def submit(self, task: Task) -> None:
        task()


class QueuePolicy(ExecutionPolicy):
    """Enqueue; an owner thread drains explicitly (cooperative runtimes)."""

    def __init__(self):
        self._q: queue.SimpleQueue[Task] = queue.SimpleQueue()

    def submit(self, task: Task) -> None:
        self._q.put(task)

    def drain(self) -> int:
        n = 0
        while True:
            try:
                task = self._q.get_nowait()
            except queue.Empty:
                return n
            task()
            n += 1


class ThreadPoolPolicy(ExecutionPolicy):
    """Worker-pool policy — the paper's "more sophisticated runtime"."""

    def __init__(self, num_workers: int = 2, name: str = "ham-exec"):
        self._q: queue.SimpleQueue[Task | None] = queue.SimpleQueue()
        self._workers = [
            threading.Thread(target=self._run, name=f"{name}-{i}", daemon=True)
            for i in range(num_workers)
        ]
        self._idle = threading.Semaphore(0)
        self._submitted = 0
        self._lock = threading.Lock()
        for w in self._workers:
            w.start()

    def _run(self) -> None:
        while True:
            task = self._q.get()
            if task is None:
                return
            try:
                task()
            finally:
                self._idle.release()

    def submit(self, task: Task) -> None:
        with self._lock:
            self._submitted += 1
        self._q.put(task)

    def drain(self) -> int:
        """Block until every submitted task has finished."""
        with self._lock:
            n = self._submitted
            self._submitted = 0
        for _ in range(n):
            self._idle.acquire()
        return n

    def shutdown(self) -> None:
        for _ in self._workers:
            self._q.put(None)
        for w in self._workers:
            w.join(timeout=5)
