"""Ingest's share of its roofline: the bytes a non-emitting push's chunk
needs (``needs.ingest_bytes``: items read once, slots won written once,
the counters) at the card's peak rate, over the device time of those
pushes."""
from harness import needs


def read(t):
    its = t.select("ingest")
    nbytes = sum(needs.ingest_bytes(t.fold[it.chunk].items,
                                    t.fold[it.chunk].won,
                                    t.cell.num_strata) for it in its)
    return needs.share_of_roofline(nbytes, t.device_us(its) / 1e6)
