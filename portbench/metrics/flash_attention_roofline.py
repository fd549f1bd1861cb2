"""The flash-attention kernels' share of their roofline in the traced
slice's train steps, in %: the least time their launches could take
(forward 4 d_head and backward 10 d_head FLOPs a causal pair and head;
each launch bound by the larger of its FLOPs and its bytes) over the
forward and backward kernels' device time.  Layer: kernels/flash_attention."""

from portbench import common

BACKWARD = ("bwd_delta", "bwd_dkdv", "bwd_group_sum", "bwd_dq")


def _is_flash(name):
    return "flash_kernel" in name or any(b in name for b in BACKWARD)


def read(rec):
    c, s, conf = rec["counters"], rec["spans"], rec["conf"]
    t = common.kernel_seconds(rec["device_events"], _is_flash)
    if t == 0 or not s["train_steps"]:
        return None
    B, S = s["batch"], s["seq"]
    need = 0.0
    for backward, n in ((False, c["flash_attention"]), (True, c["flash_attention_backward"])):
        need += n * common.bound(common.flash_bytes(conf, B, S, backward),
                                 common.flash_flops(conf, B, S, backward))[0]
    return 100.0 * need / t
