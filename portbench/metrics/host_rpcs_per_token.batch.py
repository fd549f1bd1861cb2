"""Host RPCs per delivered token in the traced slice: the scheduler's
submitted calls and oneways (``sched.stats``) and the fused stream frames
the decode loops sent the host, over the tokens the slice's admissions and
decode blocks produced.  Layer: HAM runtime."""


def read(rec):
    c, s = rec["counters"], rec["spans"]
    tokens = s["decode_tokens"] + s["first_tokens"]
    if "submitted" not in c or tokens == 0:
        return None
    return (c["submitted"] + c["oneways"] + c.get("stream_frames", 0)) / tokens
