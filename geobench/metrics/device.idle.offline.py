"""The share of the traced window in which no operation ran on the card
(kernels, copies and fills; their intervals merged), in the offline cell."""

LAYER = "device"
SOURCE = "device_trace"


def read(obs):
    trace = obs["trace"]
    if trace is None or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
