"""Device activities per emitting push (its own chunk's ingest, the
emission and the answers read back)."""


def read(t):
    its = t.select("emission")
    return t.launches(its) / len(its) if its else None
