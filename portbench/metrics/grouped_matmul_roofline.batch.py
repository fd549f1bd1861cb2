"""The grouped-matmul kernels' share of their roofline in the traced
serving slice, in %: the least time the slice's launches could take over
the ``gmm_`` kernels' device time.  Every prefill of P tokens and every
decode step over n active sequences makes 3 launches a layer (gate, up,
down), each bound by the larger of 2 d f FLOPs a routed row (tokens x
top-k rows: capacity padding and empty slots are not counted) and its
bytes: all E experts' weights, and each routed row's input and output.
Layer: kernels/grouped_matmul.

Counting all E experts' weights is sound here: a prompt of at least 64
tokens, or a decode step over a backlog that keeps 64 slots or more
nearly full, routes some 400 (token, choice) pairs or more, so a given
expert gets none with probability at most (63/64)^400, about 0.2%; and
the capacity-padded kernel reads every expert's weights anyway.  Where the launch counter
differs from 3 L x (prefills + decode steps) the slice held launches this
count does not describe, and the metric reads nothing."""

from portbench import common


def read(rec):
    conf, s = rec["conf"], rec["spans"]
    if "num_experts" not in conf:
        return None
    t = common.kernel_seconds(rec["device_events"], lambda n: "gmm_" in n)
    calls = list(s["prefill_lengths"]) + [len(ls) for ls in s["decode_lengths"]]
    per_call = 3 * conf["num_hidden_layers"]
    if t == 0 or not calls or rec["counters"]["grouped_matmul"] != per_call * len(calls):
        return None
    need = sum(common.bound(common.gmm_bytes(conf, n), common.gmm_flops(conf, n, False))[0]
               for n in calls)
    return 100.0 * per_call * need / t
