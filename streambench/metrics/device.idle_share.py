"""Percent of the traced window in which nothing ran on the card."""


def read(t):
    if t.window_us <= 0 or t.busy_us <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us / t.window_us)
