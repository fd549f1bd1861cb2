"""Model FLOPs of the traced slice's prompt and output tokens over the
slice times the bf16 peak, in %: 2N a token plus causal attention for each
prefilled prompt, 2N plus the attended cache for each active sequence's
decode step (a slot with no request is not counted).  Layer: model step."""

from portbench import common


def read(rec):
    conf, s = rec["conf"], rec["spans"]
    flops = sum(common.model_flops_forward(conf, n, common.causal_pairs(n))
                for n in s["prefill_lengths"])
    flops += sum(common.model_flops_forward(conf, len(ls), sum(ls)) for ls in s["decode_lengths"])
    if flops == 0:
        return None
    return 100.0 * flops / rec["window_s"] / common.PEAK_FLOPS["bfloat16"]
