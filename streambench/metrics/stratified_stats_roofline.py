"""The stats kernel's share of its roofline over the traced emissions:
each launch a pass over the emission's ``[K·S, N]`` view,
``needs.stats_bytes`` of its slots, live slots and rows, at the card's
peak rate, over the profiler's time of the launches."""
from harness import needs

KERNELS = ("stats_kernel", "stats_rows_kernel")


def read(t):
    nbytes = seconds = 0.0
    for it in t.select("emission"):
        v = t.views[it.chunk]
        nbytes += t.launches([it], KERNELS) * needs.stats_bytes(
            v["slots"], v["live"], v["rows"])
        seconds += t.device_us([it], KERNELS) / 1e6
    return needs.share_of_roofline(nbytes, seconds)
