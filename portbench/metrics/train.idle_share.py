"""Device idle share of the traced training window: 1 - busy / wall."""


def read(t):
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.busy_s > 0 else None
