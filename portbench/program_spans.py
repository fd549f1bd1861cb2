"""The program's own spans in a traced slice, for the per-layer metrics
that read them (``source`` ``program_span``).

``repro_torch.core.trace`` keeps each span that closed while a
``torch.profiler`` recorded, oldest first, with its ends on
``time.perf_counter_ns``, its units, and its CPU and device time where
the span takes them (``trace.profiled()``).  The slice's spans are found
by the program spans that bound it, counted back from the newest:

* serving profiles the device alone over ``profile.blocks`` decode
  blocks, then, where the mix asks for ``profile.host_blocks``, the host
  too over the blocks after.  The slice runs from the opening of its
  first ``engine.dispatch`` to the close of its last, the host slice's
  dispatches following them;
* training profiles its ``train_steps`` steps alone: the slice runs from
  the opening of the first of the last ``train_steps`` ``train.step``
  spans to the close of the last.

A program without the recorder, or a slice without the bounding spans,
gives None, and the metric is left out.
"""

from __future__ import annotations


def profiled():
    """The program's profiled spans, or None where it keeps none."""
    try:
        from repro_torch.core import trace
    except ImportError:
        return None
    read = getattr(trace, "profiled", None)
    return None if read is None else read()


def between(spans, anchor: str, count: int, after: int = 0):
    """The spans that close from the opening of the first to the close of
    the last of ``count`` ``anchor`` spans that are followed by ``after``
    more, or None where there are too few."""
    if spans is None or count <= 0:
        return None
    marks = [i for i, s in enumerate(spans) if s["name"] == anchor]
    if len(marks) < count + after:
        return None
    first, last = marks[len(marks) - after - count], marks[len(marks) - after - 1]
    t0, t1 = spans[first]["open_ns"], spans[last]["close_ns"]
    return [s for s in spans if t0 <= s["close_ns"] <= t1]


def serve_slice(rec):
    prof = rec["mix"]["profile"]
    return between(profiled(), "engine.dispatch", rec["spans"]["blocks"],
                   prof.get("host_blocks", 0))


def train_slice(rec):
    return between(profiled(), "train.step", rec["spans"]["train_steps"])


def named(spans, *names) -> list:
    return [s for s in spans or () if s["name"] in names]
