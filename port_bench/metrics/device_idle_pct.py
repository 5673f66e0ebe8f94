"""Share of the traced window in which no kernel, copy or fill ran on
the device, in %."""


def read(t):
    if t.window_s <= 0:
        return None
    return (1.0 - t.busy_s / t.window_s) * 100.0
