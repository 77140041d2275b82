"""Device activities (kernels, copies, memsets) per non-emitting push."""


def read(t):
    its = t.select("ingest")
    return t.launches(its) / len(its) if its else None
