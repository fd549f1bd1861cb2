"""The grouped-matmul kernels' share of their roofline in the traced
slice's train steps, in %: the least time their launches could take (2 d f
FLOPs a routed row, tokens x top-k rows, not the capacity padding; 4 d f
for a backward launch, dx and dw) over the forward and backward kernels'
device time.  Layer: kernels/grouped_matmul."""

from portbench import common


def read(rec):
    c, s, conf = rec["counters"], rec["spans"], rec["conf"]
    t = common.kernel_seconds(rec["device_events"], lambda n: "gmm_" in n)
    if t == 0 or not s["train_steps"]:
        return None
    tokens = s["batch"] * s["seq"]
    need = sum(n * common.gmm_flops(conf, tokens, backward) / common.PEAK_FLOPS["bfloat16"]
               for backward, n in ((False, c["grouped_matmul"]),
                                   (True, c["grouped_matmul_backward"])))
    return 100.0 * need / t
