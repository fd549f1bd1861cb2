"""The decode-attention kernel's share of its roofline in the traced slice,
in %: the least time the slice's decode launches could take (the bytes of
each active sequence's cached keys and values, its query and its output,
every layer; bandwidth-bound) over the kernel's device time.  Layer:
kernels/decode_attention."""

from portbench import common


def _is_decode(name):
    return "decode_kernel" in name or "decode_q8" in name


def read(rec):
    conf, s = rec["conf"], rec["spans"]
    t = common.kernel_seconds(rec["device_events"], _is_decode)
    if t == 0 or not s["decode_lengths"]:
        return None
    L = conf["num_hidden_layers"]
    need = sum(common.bound(common.decode_bytes(conf, ls), common.decode_flops(conf, ls))[0]
               for ls in s["decode_lengths"]) * L
    return 100.0 * need / t
