"""Share of the traced window in which no kernel, copy or fill runs on the
device (the union of their intervals), in percent."""


def read(trace):
    if not trace.ops or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
