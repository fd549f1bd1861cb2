"""Host time of the decode loop's stream egress in the traced slice, in ms
a loop iteration (one decode block): the ``serve.egress`` span, which
groups the block's tokens by request, packs one ``_serve/stream_block``
segment a request and flushes the iteration's segments as fused frames
through the HAM runtime.  Layer: HAM runtime."""

from portbench import program_spans


def read(rec):
    spans = program_spans.named(program_spans.serve_slice(rec), "serve.egress")
    if not spans:
        return None
    return sum(s["wall_ns"] for s in spans) / len(spans) / 1e6
