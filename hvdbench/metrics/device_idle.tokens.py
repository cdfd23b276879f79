"""device_idle.tokens: the share of the profiled slice in which the card
ran no kernel or copy: 1 - the union of the device's intervals over the
slice's device time. Moves ``tokens_per_s_per_gpu``."""


def read(t):
    if t.unit != "tokens" or not t.events or not t.slice_s:
        return None
    return 100.0 * (1.0 - t.busy_us() / (t.slice_s * 1e6))
