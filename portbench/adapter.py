"""The one place that reads state the program keeps private.

``ClusterServingEngine`` records, per request, when each fused block of
tokens reached the host's stream sink (``_events[rid]["token_ts"]``, on
``time.monotonic``), its transcript and its final status, but offers no
public hook for them.  A mixture of experts chooses each token's experts
in ``repro_torch.models.moe._route_groups`` and hands the choice to no
caller.  The harness reads them here and nowhere else; public hooks are
listed in ``PERF.md`` for the next ``tracing`` change, and then only this
file changes.
"""

from __future__ import annotations

import threading
import time


def token_times(engine, rid: int) -> list:
    """Host arrival time (``time.monotonic``) of each token of ``rid``."""
    with engine._wd:
        return list(engine._events.get(rid, {}).get("token_ts", ()))


def first_arrival(engine, after: float):
    """The earliest token arrival at or after ``after`` of any request, or
    None (one pass under the engine's lock)."""
    best = None
    with engine._wd:
        for ev in engine._events.values():
            ts = ev.get("token_ts")
            if ts and ts[-1] >= after:
                first = next(t for t in ts if t >= after)
                best = first if best is None else min(best, first)
    return best


def transcript(engine, rid: int) -> list:
    with engine._wd:
        return list(engine._transcripts.get(rid, ()))


def status(engine, rid: int):
    """The request's final stream status, or None while it runs."""
    with engine._wd:
        return engine._done.get(rid)


def error(engine, rid: int):
    with engine._wd:
        return engine._errors.get(rid)


def queued(engine) -> list:
    """Request ids still waiting host-side for a slot."""
    with engine._wd:
        return [r.rid for r in engine._pending]


def worker_queue(engine) -> int:
    """Admissions waiting in the worker decode loops' own queues."""
    return sum(len(loop._admits) for loop in loops(engine))


def loops(engine) -> list:
    """The ``WorkerDecodeLoop`` of each serving worker."""
    from repro_torch.serve.handlers import _NODE_LOOPS

    return [_NODE_LOOPS[key] for key in engine._engine_keys.values()]


def wait_ended(loops, timeout: float = 120.0) -> None:
    """Wait until the thread of each decode loop in ``loops`` has ended.
    ``close`` asks a loop to stop and waits 5 s for it, but a loop stops
    only after the iteration it is in, whose admissions can take longer;
    until then it still runs the program on the device."""
    deadline = time.monotonic() + timeout
    for loop in loops:
        loop._thread.join(max(0.0, deadline - time.monotonic()))
        if loop._thread.is_alive():
            raise RuntimeError(f"a decode loop still runs {timeout:.0f} s after its engine closed")


def replicas(engine) -> list:
    """The ``ServingEngine`` replica of each serving worker."""
    from repro_torch.serve.handlers import _NODE_ENGINES

    return [_NODE_ENGINES[key] for key in engine._engine_keys.values()]


class RouteRecorder:
    """Records the experts the program chooses (``top_e``, (G, Tg, k)) at
    every call of its routing while entered, from any thread, in the
    order of the calls; on leaving, the program's function is back."""

    def __init__(self):
        self.calls: list = []
        self._lock = threading.Lock()

    def __enter__(self):
        from repro_torch.models import moe

        self._moe, self._orig = moe, moe._route_groups

        def recorded(*args, **kwargs):
            probs, top_w, top_e = self._orig(*args, **kwargs)
            with self._lock:
                self.calls.append(top_e.detach().clone())
            return probs, top_w, top_e

        moe._route_groups = recorded
        return self

    def __exit__(self, *exc):
        self._moe._route_groups = self._orig
        return False

    def take(self) -> list:
        """The calls recorded since the last ``take``, on the host."""
        with self._lock:
            calls, self.calls = self.calls, []
        return [c.cpu() for c in calls]
