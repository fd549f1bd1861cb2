"""The optimizer's share of a train step's device time in the traced
slice, in %: the ``train.optimizer`` span of the train step (the
reduce-dtype cast, the clip and AdamW's update) over the ``train.step``
span around each step, both timed by CUDA events on the step's stream.
Layer: optimizer."""

from portbench import program_spans


def read(rec):
    spans = program_spans.train_slice(rec)
    steps = program_spans.named(spans, "train.step")
    opt = program_spans.named(spans, "train.optimizer")
    if not steps or not opt or any(s["device_ns"] is None for s in steps + opt):
        return None
    total = sum(s["device_ns"] for s in steps)
    return 100.0 * sum(s["device_ns"] for s in opt) / total if total else None
