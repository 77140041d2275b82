"""Percent of the emitting pushes' wall time in which the card was busy
(the backlog of earlier chunks it drains included)."""


def read(t):
    busy, wall = t.busy_in(t.select("emission"))
    return 100.0 * busy / wall if wall > 0 and busy > 0 else None
