"""Share of the traced slice with no device activity, in %.  Layer:
device."""


def read(rec):
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
