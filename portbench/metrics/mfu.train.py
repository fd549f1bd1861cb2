"""Model FLOPs of the traced slice's train steps over the slice times the
bf16 peak, in %: 6N a token plus causal attention three times over (the
forward, and the backward at twice the forward); recomputation is not
counted.  Layer: model step and trainer."""

from portbench import common


def read(rec):
    s = rec["spans"]
    if not s["train_steps"]:
        return None
    flops = common.model_flops_train(rec["conf"], s["batch"], s["seq"]) * s["train_steps"]
    return 100.0 * flops / rec["window_s"] / common.PEAK_FLOPS["bfloat16"]
