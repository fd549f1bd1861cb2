"""Spans: where the program's time goes, at its layer boundaries.

One context manager, :class:`span`, and two reads, :func:`snapshot` and
:func:`profiled`::

    with span("engine.dispatch", k, cpu=True):
        ...                       # k decode steps dispatched

Always on.  A closed span adds 1 to its name's count, its ``n`` units to
the name's units and its wall time (``time.perf_counter_ns``) to the
name's total; with ``cpu=True`` also the thread's CPU time
(``time.thread_time_ns``), so that wall minus CPU is the time the thread
waited (on the interpreter lock, a lock or the device).  The totals are
kept per thread, with no lock on the path, and merged by :func:`snapshot`
into one flat dict of numbers (``span.<name>.count``, ``.units``,
``.wall_ns``, ``.cpu_ns``, ``.device_ns``); two snapshots subtract key by
key.

While a ``torch.profiler`` records (one read of a module flag), a span is
also entered as a profiler range of its name, so it lands among the
trace's host events on the kernels' clock and names what the host was
doing there; ``rid`` goes into the range's arguments.  The range is a
function-scope record, not a user annotation: the profiler draws no
device-side range for it, so the device's own events stay the kernels'.
Each span that closes while a profiler records is also kept, with its
ends, units, CPU and device time, in a bounded list that
:func:`profiled` returns: the numbers a trace cannot hold, for the spans
it covers.  With no profiler recording nothing of this runs.

``device=`` (the ``torch.device`` the enclosed work runs on) records, on
a CUDA device, a timing event on its current stream at each end of the
span.  The recorder never synchronizes: the events are read by
``Event.query()`` when later device spans close, and by :func:`snapshot`
and :func:`profiled` (a caller that synchronized first sees them all).
The device time is added to ``.device_ns``; on a CPU device the span's
wall time stands in for it.  No span inside the serving engine's
admission or decode block asks for device time, so a CUDA-graph capture
of those paths records no event.

Torch-free at import time: torch is looked up only once it is loaded.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque

__all__ = ["span", "snapshot", "profiled"]

#: spans kept by :func:`profiled`, the newest (a traced serving slice of
#: two decode blocks and its admissions closes a few dozen)
PROFILED_MAX = 1 << 12

_FIELDS = ("count", "units", "wall_ns", "cpu_ns", "device_ns")
_perf = time.perf_counter_ns
_thread_time = time.thread_time_ns

_local = threading.local()
_tables: list[dict] = []          # one {name: [count, units, wall, cpu, device]} a thread
_tables_lock = threading.Lock()
_pending: deque = deque()         # (totals, start event, end event, profiled entry)
_pending_lock = threading.Lock()
_profiled: deque = deque(maxlen=PROFILED_MAX)
_profiler = None                  # torch.autograd.profiler, once loaded


def _new_table() -> dict:
    """The calling thread's totals, registered for :func:`snapshot`."""
    table = _local.table = {}
    with _tables_lock:
        _tables.append(table)
    return table


def _profiling() -> bool:
    """Whether a ``torch.profiler`` records (torch's own flag, read from its
    module once torch has loaded it)."""
    global _profiler
    if _profiler is None:
        _profiler = sys.modules.get("torch.autograd.profiler")
        if _profiler is None:
            return False
    return _profiler._is_profiler_enabled


def _range(name: str, rid):
    """A function-scope profiler range of ``name`` (``record_function``'s
    would be a user annotation, which the profiler also draws on the
    device's timeline)."""
    import torch

    fast = torch._C._profiler._RecordFunctionFast
    return fast(name) if rid is None else fast(name, [], {"rid": int(rid)})


def _resolve() -> None:
    """Add the device time of every finished device span, oldest first."""
    with _pending_lock:
        while _pending:
            totals, start, end, entry = _pending[0]
            if not end.query():
                break
            _pending.popleft()
            ns = int(start.elapsed_time(end) * 1e6)
            totals[4] += ns
            if entry is not None:
                entry["device_ns"] = ns


class span:
    """Time the enclosed block under ``name`` (see the module's notes)."""

    __slots__ = ("name", "n", "cpu", "device", "rid", "_t0", "_c0", "_range", "_events",
                 "_kept")

    def __init__(self, name: str, n: int = 1, *, cpu: bool = False, device=None, rid=None):
        self.name, self.n, self.cpu, self.device, self.rid = name, n, cpu, device, rid

    def __enter__(self):
        self._kept = _profiling()
        self._range = None
        if self._kept:
            self._range = _range(self.name, self.rid)
            self._range.__enter__()
        self._events = None
        if self.device is not None and self.device.type == "cuda":
            import torch

            stream = torch.cuda.current_stream(self.device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True), stream)
            self._events[0].record(stream)
        if self.cpu:
            self._c0 = _thread_time()
        self._t0 = _perf()
        return self

    def __exit__(self, *exc):
        t1 = _perf()
        cpu = _thread_time() - self._c0 if self.cpu else 0
        wall = t1 - self._t0
        table = getattr(_local, "table", None)
        if table is None:
            table = _new_table()
        totals = table.get(self.name)
        if totals is None:
            totals = table[self.name] = [0] * len(_FIELDS)
        totals[0] += 1
        totals[1] += self.n
        totals[2] += wall
        totals[3] += cpu
        entry = None
        if self._kept:
            entry = {"name": self.name, "rid": self.rid, "units": self.n, "open_ns": self._t0,
                     "close_ns": t1, "wall_ns": wall, "cpu_ns": cpu if self.cpu else None,
                     "device_ns": None if self.device is None or self._events else wall}
            _profiled.append(entry)
        if self._events is not None:
            start, end, stream = self._events
            end.record(stream)
            self._events = None
            _pending.append((totals, start, end, entry))
            _resolve()
        elif self.device is not None:
            totals[4] += wall
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False


def snapshot() -> dict:
    """Every span name's totals so far, merged over the threads, as one flat
    dict: ``span.<name>.count``, ``.units``, ``.wall_ns``, ``.cpu_ns``,
    ``.device_ns`` (device spans not yet finished on the device are left
    out of ``.device_ns`` until a later read)."""
    if _pending:
        _resolve()
    with _tables_lock:
        tables = list(_tables)
    merged: dict[str, list] = {}
    for table in tables:
        for name, totals in list(table.items()):
            acc = merged.setdefault(name, [0] * len(_FIELDS))
            for i, v in enumerate(totals):
                acc[i] += v
    return {f"span.{name}.{field}": v
            for name, acc in sorted(merged.items()) for field, v in zip(_FIELDS, acc)}


def profiled() -> list[dict]:
    """The spans that closed while a ``torch.profiler`` recorded, oldest
    first (the last :data:`PROFILED_MAX`), each a dict: ``name``, ``rid``,
    ``units``, ``open_ns`` and ``close_ns`` (``time.perf_counter_ns``),
    ``wall_ns``, ``cpu_ns`` (None unless the span asked for it) and
    ``device_ns`` (None unless it asked for it, or while its device work
    is unfinished)."""
    if _pending:
        _resolve()
    return [dict(e) for e in list(_profiled)]
