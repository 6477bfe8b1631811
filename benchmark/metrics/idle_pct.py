"""The device's idle share over the traced window (whole calls, from the
first launch to the last image on the host), in %."""


def read(trace):
    w = trace.window_s()
    if w <= 0.0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / w)
