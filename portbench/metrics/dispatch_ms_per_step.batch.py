"""Host time to dispatch one decode step in the traced slice, in ms: the
``engine.dispatch`` span of ``ServingEngine.step_many`` (the block's k
greedy dispatches through the device handler table, up to the stacked
tokens' one transfer) over the steps it dispatched.  What a CUDA graph
of the step would replace.  Layer: engine."""

from portbench import program_spans


def read(rec):
    spans = program_spans.named(program_spans.serve_slice(rec), "engine.dispatch")
    steps = sum(s["units"] for s in spans)
    if steps == 0:
        return None
    return sum(s["wall_ns"] for s in spans) / steps / 1e6
