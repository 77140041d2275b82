"""The reservoir fold kernel's share of its roofline over every traced
push: ``needs.fold_bytes`` of each chunk (the cells are the ring's
``K·S``) at the card's peak rate, over the profiler's time of its
launches."""
from harness import needs

KERNELS = ("fold_claim", "fold_write", "fold_parts")


def read(t):
    its = t.select()
    cells = t.cell.config["num_intervals"] * t.cell.num_strata
    nbytes = sum(needs.fold_bytes(t.fold[it.chunk].items,
                                  t.fold[it.chunk].live,
                                  t.fold[it.chunk].won, cells)
                 for it in its)
    return needs.share_of_roofline(nbytes, t.device_us(its, KERNELS) / 1e6)
