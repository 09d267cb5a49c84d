"""The device: the share of the profiled cycles' wall time in which no
operation ran on the card, in %."""


def read(trace):
    if trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
