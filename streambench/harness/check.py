"""Whether what the timed path produced is correct: the program's
emissions, samples and counters against the plain reference, after the
window.

Compared, each against the cell's limit (``limits/<cell>.json``):

* ``counters_off``: per-stratum ingested / accepted / late / dropped
  counters after the window that differ from the reference's. The
  program keeps them in int32, which wraps past 2**31 items (a stated
  departure of the program, in the configuration), so both sides are
  read as u32 words: any miscount below 2**32 items shows; exact,
  limit 0.
* ``cells_off``: cells whose arrival count, and slots whose interval,
  differ, after the window and at each checked emission; exact, limit 0.
* ``emission_counters_off``: watermark totals (on time, late, dropped)
  of every emission in the window that differ (u32 words); exact,
  limit 0.
* ``sample_off``: at each checked emission, sampled items of the cells
  it reads (slot ``j`` of a cell, ``j < min(arrivals, capacity)``) whose
  f32 bits differ from the reference's sample; exact, limit 0.
* ``answer_gap``: the largest ``|program - reference| / |reference|``
  over every answer of the checked emissions, the reference working the
  sample out again from the same chunks and the seed's key and the
  answer in float64.
* ``bound_gap``: the same for the 95% half-widths (Eqs. 6, 9).
* ``checked_emissions``: how many were checked; at least 1.

The checked emissions are every ``check_stride``-th of the window's from
an offset drawn from the seed; the driver copies their samples on the
card as they are made.
"""
from __future__ import annotations

import dataclasses
import random

import numpy as np
import torch

from reference import estimates, replay

MASK32 = 0xFFFFFFFF
COUNTERS = ("ingested", "accepted", "late", "dropped")


def layout(cell, seed: int) -> replay.Layout:
    c = cell.config
    return replay.Layout(num_strata=cell.num_strata,
                         num_intervals=c["num_intervals"],
                         interval_span=c["interval_span_s"],
                         allowed_lateness=c["allowed_lateness_s"],
                         capacity=cell.capacity, seed=seed)


def rel_gap(program: float, reference: float) -> float:
    if program == reference:
        return 0.0
    return abs(program - reference) / max(abs(reference), 1e-30)


def gaps(program: dict, reference: dict) -> tuple:
    """The largest relative gaps of the values and of the half-widths."""
    answer = bound = 0.0
    for name, (ref_v, ref_h) in reference.items():
        prog_v, prog_h = program[name]
        if len(prog_v) != len(ref_v):
            return float("inf"), float("inf")
        for p, r in zip(prog_v, ref_v):
            answer = max(answer, rel_gap(p, r))
        for p, r in zip(prog_h, ref_h):
            bound = max(bound, rel_gap(p, r))
    return answer, bound


def checked(seed: int, stride: int):
    """Whether the window's ``n``-th emission is checked: every
    ``stride``-th from an offset drawn from the seed."""
    phase = random.Random(int(seed) * 2654435761 + 17).randrange(stride)
    return lambda n: n >= phase and (n - phase) % stride == 0


def sample_off(values, ring, view: np.ndarray, capacity: int) -> int:
    """Sampled items of the view's cells whose f32 bits differ between
    the program's ring ``values`` and the reference's ``ring``."""
    k, s, n = ring.shape
    taken = torch.as_tensor(np.minimum(view, capacity).reshape(k * s, 1),
                            device=ring.device)
    valid = torch.arange(n, device=ring.device)[None, :] < taken
    a = values.reshape(k * s, n).contiguous().view(torch.int32)
    b = ring.reshape(k * s, n).contiguous().view(torch.int32)
    return int(((a != b) & valid).sum())


@dataclasses.dataclass
class Routed:
    """The reference's routing of every chunk the run pushed."""
    layout: replay.Layout
    counters: replay.Counters
    records: list
    keys: list


def route(cell, stream, seed: int, chunks: int) -> Routed:
    lay = layout(cell, seed)
    counters, records = replay.route_all(lay, stream, chunks)
    return Routed(lay, counters, records, replay.lead_keys(lay, chunks))


def view_sizes(lay, records: list, data) -> dict:
    """Per traced emission: the slots, live slots and rows of the
    ``[K·S, N]`` view its stats pass reads."""
    out = {}
    for it in data.select("emission"):
        rec = records[it.chunk]
        view = estimates.view_cells(lay, rec.slots, rec.open_interval,
                                    rec.counts, it.interval)
        rows = lay.num_intervals * lay.num_strata
        out[it.chunk] = {"rows": rows, "slots": rows * lay.capacity,
                         "live": int(np.minimum(view, lay.capacity).sum())}
    return out


def _cells_off(records, n: int, counts, slots) -> int:
    rec = records[n]
    counts = np.asarray(counts).reshape(rec.counts.shape)
    return int(np.sum(rec.counts != counts)) + sum(
        int(a) != int(b) for a, b in zip(rec.slots, slots))


def _totals_off(e, rec) -> int:
    return sum(int((got & MASK32) != (want & MASK32))
               for got, want in ((e.on_time, rec.on_time),
                                 (e.late, rec.late),
                                 (e.dropped, rec.dropped)))


@dataclasses.dataclass
class Verdict:
    numbers: dict    # {name: (value, limit)}
    failed: int      # window emissions with a number off


def compare(cell, stream, seed: int, run, final: dict, routed: Routed,
            control_dtype=None) -> Verdict:
    """Every number compared. With ``control_dtype`` the reference at
    that precision stands in the program's place for the answers (the
    control)."""
    lay, counters, records, keys = (routed.layout, routed.counters,
                                    routed.records, routed.keys)
    lim = cell.limits
    off = sum(int(np.sum((getattr(counters, name) & MASK32)
                         != final[name])) for name in COUNTERS)
    cells_off = _cells_off(records, len(records) - 1, final["counts"],
                           final["slots"])
    em_off = sample = n_checked = failed = 0
    answer = bound = 0.0
    for e in (e for e in run.emissions if e.in_window):
        rec = records[e.chunk]
        bad = _totals_off(e, rec)
        em_off += bad
        if e.sample is not None:
            n_checked += 1
            got = e.sample
            c_off = _cells_off(records, e.chunk, got["counts"].cpu(),
                               got["slots"].cpu().tolist())
            view = estimates.view_cells(lay, rec.slots, rec.open_interval,
                                        rec.counts, e.interval)
            wanted = [s for s in range(lay.num_intervals) if view[s].any()]
            first = min((replay.opening_chunk(records, e.chunk, s)
                         for s in wanted), default=e.chunk)
            ring, _ = replay.replay(lay, stream, records, keys, first,
                                    e.chunk, want_ring=True)
            s_off = sample_off(got["values"], ring, view, lay.capacity)
            ref = estimates.answers(ring, view, lay.capacity, cell.queries)
            prog = e.answers
            if control_dtype is not None:
                prog = estimates.answers(ring, view, lay.capacity,
                                         cell.queries, control_dtype)
            a, b = gaps(prog, ref)
            del ring
            cells_off += c_off
            sample += s_off
            answer, bound = max(answer, a), max(bound, b)
            bad += c_off + s_off + (a > lim["answer_gap"]) + (
                b > lim["bound_gap"])
        failed += bad > 0
    numbers = {"counters_off": (off, 0), "cells_off": (cells_off, 0),
               "emission_counters_off": (em_off, 0),
               "sample_off": (sample, 0),
               "answer_gap": (answer, lim["answer_gap"]),
               "bound_gap": (bound, lim["bound_gap"]),
               "checked_emissions": (n_checked, 1)}
    return Verdict(numbers, failed)


def passed(checks: dict) -> bool:
    return all(_ok(name, v, lim) for name, (v, lim) in checks.items())


def _ok(name: str, value, limit) -> bool:
    if name == "checked_emissions":
        return value >= limit
    return value <= limit


def report(checks: dict) -> dict:
    return {name: {"value": v, "limit": lim}
            for name, (v, lim) in checks.items()}


def stderr_lines(checks: dict) -> list:
    return [f"check {name} {v!r} limit {lim!r} "
            f"{'ok' if _ok(name, v, lim) else 'FAILED'}"
            for name, (v, lim) in checks.items()]
