"""Output tokens per decode step in the traced slice: tokens the decode
blocks emitted over the decode steps, counted as decode-attention
launches over the model's attention layers.  Layer: engine."""


def read(rec):
    steps = rec["counters"]["decode_attention"] / rec["conf"]["num_hidden_layers"]
    if steps == 0:
        return None
    return rec["spans"]["decode_tokens"] / steps
