"""Bytes each piece of work must move at the least, and the card's peak
rate: the yardstick of the roofline shares.

Each input byte is counted once where it is read and each output byte
once where it is written, whatever a kernel reads again; scattered words
count at their 4 bytes, though DRAM moves a 32-byte sector for each.
Uniform draws are not counted: they are one implementation of the
sampling, not work the answer needs. Frozen from the port's own
arithmetic of the kernels' needs (``fold_need``, ``one_shot_need``,
``stats_need``, ``whist_need`` in ``chip_smoke.py``), uniforms left
out.
"""
from __future__ import annotations

#: One NVIDIA H100 SXM's HBM3 bandwidth (data sheet), bytes per second.
HBM_BYTES_PER_S = 3.35e12


def fold_bytes(items: int, live: int, won: int, cells: int) -> int:
    """The reservoir fold of ``items`` into ``cells`` cells: the mask of
    every item, the cell id of each live item, the payload read and ring
    word written of each slot won, counts in and out and capacity."""
    return items + 4 * live + 8 * won + 12 * cells


def one_shot_bytes(items: int, masked_in: int, won: int, k: int, s: int,
                   resets: int) -> int:
    """The one-shot ingest: the mask of every item, the time and stratum
    of each masked-in item, the payload and ring word of each slot won,
    the carried state (counts, capacities, slot table, counter rows,
    scalars) and the adopted capacities of reset slots."""
    return (items + 8 * masked_in + 8 * won + 4 * (3 * k * s + 11 * s
                                                   + 2 * k + 14)
            + 4 * (resets * s + (s if resets else 0)))


def stats_bytes(slots: int, live: int, rows: int) -> int:
    """One stats pass over a ``[rows, N]`` view of ``slots`` slots: every
    mask byte, the value and row id of each live slot, three f32 outputs
    a row."""
    return slots + 8 * live + 12 * rows


def whist_bytes(slots: int, live: int, in_bin: int, rows: int,
                bins: int) -> int:
    """One weighted histogram: every mask byte, the value of each live
    slot, the cell id and weight of each item in a bin, the edges, two
    f32 ``[rows, bins]`` outputs."""
    return slots + 4 * live + 8 * in_bin + 4 * (bins + 1) + 8 * rows * bins


def ingest_bytes(items: int, won: int, strata: int) -> int:
    """One chunk's ingest: times, values, stratum ids (4 bytes each) and
    mask (1) of every item read once, each slot won written once, and the
    six per-stratum counter rows and two totals read and written."""
    return 13 * items + 4 * won + 8 * (6 * strata + 2)


def share_of_roofline(nbytes: float, seconds: float):
    """Percent of the least time the bytes need at the peak rate; None
    where nothing was timed."""
    if seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
