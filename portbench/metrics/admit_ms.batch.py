"""Wall time of an admission in the traced slice, in ms: the decode loop's
``serve.admit`` span around ``ServingEngine.admit`` (a batch-1 prefill of
every layer, the cache insert, and the first token's read, a host sync),
averaged over the slice's admissions.  Layer: engine."""

from portbench import program_spans


def read(rec):
    admits = program_spans.named(program_spans.serve_slice(rec), "serve.admit")
    if not admits:
        return None
    return sum(s["wall_ns"] for s in admits) / len(admits) / 1e6
