"""Share of the decode loop's host work in the traced slice during which
its thread did not run, in %: 100 x (1 - CPU time / wall time) over the
``engine.dispatch`` and ``serve.egress`` spans, which wait on no device
work, so that what is left is the thread's wait for the interpreter lock
or another lock.  Layer: host threads."""

from portbench import program_spans


def read(rec):
    spans = program_spans.named(program_spans.serve_slice(rec), "engine.dispatch",
                                "serve.egress")
    wall = sum(s["wall_ns"] for s in spans)
    if wall == 0 or any(s["cpu_ns"] is None for s in spans):
        return None
    return 100.0 * (1.0 - sum(s["cpu_ns"] for s in spans) / wall)
