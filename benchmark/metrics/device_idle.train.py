"""The share of the traced window's wall time that no device operation
covers (the union of the kernels', copies' and sets' intervals), in %."""


def read(inp):
    t = inp["trace"]
    if t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
