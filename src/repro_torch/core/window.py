"""Sliding-window ring of ``K`` per-interval OASRS states, paper §2.2/§3.1.

Counterpart of the reference's ``core/window.py``. The ring is one
stacked :class:`OASRSState` with ``values [K, S, N_max]``,
``counts``/``capacity [K, S]`` and ``key [K, 2]``; merging the intervals
is the concatenation of their ``K·S`` independently sampled cells
(Eq. 5). Per-key and session windows are cell subsets of the same merged
view (:func:`restrict_view`), and the nonlinear queries read the merged
view unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import prng
from repro_torch.core import error as err
from repro_torch.core import oasrs
from repro_torch.core import quantile as qt
from repro_torch.core import sketches as sk
from repro_torch.core.quantile import SampleView
from repro_torch.utils import DeviceLike, resolve_device


@dataclasses.dataclass
class WindowState:
    """Ring of ``K`` per-interval OASRS states (stacked on axis 0)."""
    intervals: oasrs.OASRSState
    cursor: torch.Tensor      # () int32 — next slot to overwrite
    filled: torch.Tensor      # () int32 — number of live intervals


def init(num_intervals: int, num_strata: int, capacity, key: torch.Tensor,
         max_capacity: Optional[int] = None,
         device: DeviceLike = None) -> WindowState:
    dev = resolve_device(device)
    keys = prng.split(key.to(dev), num_intervals)
    states = [oasrs.init(num_strata, capacity, k, max_capacity, device=dev)
              for k in keys]
    intervals = oasrs.OASRSState(
        *(torch.stack([getattr(s, f) for s in states])
          for f in ("values", "counts", "capacity", "key")))
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return WindowState(intervals=intervals, cursor=zero,
                       filled=zero.clone())


def _live_mask(window: WindowState) -> torch.Tensor:
    """``[K]`` bool — the ``filled`` most recent slots."""
    k = window.intervals.counts.shape[0]
    age = torch.remainder(
        torch.arange(k, dtype=torch.int32, device=window.cursor.device)
        - window.cursor, max(k, 1))
    return age >= (k - window.filled)


def sample_view(window: WindowState) -> SampleView:
    """Merged weighted sample of all live intervals: ``K·S`` cells.

    ``values`` is a view of the ring, not a copy; dead intervals get
    zero counts and so zero weight and no valid slot.
    """
    iv = window.intervals
    k, s, n = iv.values.shape
    live = _live_mask(window)
    counts = torch.where(live[:, None], iv.counts, 0)
    taken = torch.minimum(counts, iv.capacity)
    return SampleView(values=iv.values.to(torch.float32).view(k * s, n),
                      counts=counts.reshape(-1), taken=taken.reshape(-1))


def activity_mask(window: WindowState) -> torch.Tensor:
    """``[K, S]`` — live cells that accepted at least one item."""
    return _live_mask(window)[:, None] & (window.intervals.counts > 0)


def restrict_view(view: SampleView, cell_mask: torch.Tensor) -> SampleView:
    """Zero the counts/taken of cells outside ``cell_mask``."""
    return dataclasses.replace(
        view, counts=torch.where(cell_mask, view.counts, 0),
        taken=torch.where(cell_mask, view.taken, 0))


def window_stats(window: WindowState) -> err.StratumStats:
    """Stats of all live intervals, flattened to ``K·S`` strata (one
    stats pass over the merged view; dead intervals count nothing)."""
    view = sample_view(window)
    return err.stratum_stats_from_sample(view.values, view.counts,
                                         view.taken, view.slot_mask())


# ---------------------------------------------------------------------------
# Window kinds beyond the merged ring: per-key and gap sessions.
# ---------------------------------------------------------------------------

def session_intervals(activity: torch.Tensor, slot_interval: torch.Tensor,
                      gap_intervals: int) -> torch.Tensor:
    """Per-key current-session membership over the interval ring.

    ``activity [K, S]`` flags the (slot, key) cells holding accepted
    items, ``slot_interval [K]`` each slot's event interval. A key's
    current session is the maximal run of its active intervals ending at
    its newest one in which consecutive active intervals are at most
    ``gap_intervals`` apart. One K-step walk over the slots in descending
    interval order (a stable sort, as the reference's). ``[K, S]`` bool.
    """
    k, s = activity.shape
    dev = activity.device
    order = torch.argsort(-slot_interval, stable=True)
    ivs, acts = slot_interval[order], activity[order]
    last = torch.full((s,), -(2 ** 30), dtype=torch.int32, device=dev)
    started = torch.zeros(s, dtype=torch.bool, device=dev)
    stopped = torch.zeros(s, dtype=torch.bool, device=dev)
    rows = []
    for i in range(k):
        iv, act = ivs[i], acts[i]
        within = (last - iv) <= gap_intervals
        include = act & ~stopped & (~started | within)
        # An active interval beyond the gap ends the walk for that key:
        # anything older belongs to a previous session.
        stopped = stopped | (started & act & ~within)
        last = torch.where(include, iv, last)
        started = started | include
        rows.append(include)
    out = torch.zeros((k, s), dtype=torch.bool, device=dev)
    return out.index_copy_(0, order, torch.stack(rows))


def query_per_key_sum(window: WindowState) -> err.Estimate:
    """Per-key tumbling-window SUMs: a vector Estimate, one per stratum."""
    s = window.intervals.counts.shape[1]
    stats = window_stats(window)
    gid = torch.arange(stats.counts.shape[0], dtype=torch.int32,
                       device=stats.counts.device) % s
    return err.estimate_sum_grouped(stats, gid, s)


def query_session_sum(window: WindowState, gap_intervals: int,
                      slot_interval: Optional[torch.Tensor] = None
                      ) -> err.Estimate:
    """Per-key current-session SUMs over the ring (vector Estimate).

    ``slot_interval`` defaults to the recency ranks implied by the
    cursor; the runtime passes the real event-interval ids.
    """
    k, s = window.intervals.counts.shape
    dev = window.cursor.device
    if slot_interval is None:
        slot_interval = torch.remainder(
            torch.arange(k, dtype=torch.int32, device=dev) - window.cursor,
            max(k, 1))
    smask = session_intervals(activity_mask(window), slot_interval,
                              gap_intervals)
    view = restrict_view(sample_view(window), smask.reshape(-1))
    stats = err.stratum_stats_from_sample(view.values, view.counts,
                                          view.taken, view.slot_mask())
    gid = torch.arange(k * s, dtype=torch.int32, device=dev) % s
    return err.estimate_sum_grouped(stats, gid, s)


def _window_key(window: WindowState, salt: int) -> torch.Tensor:
    return prng.fold_in(window.intervals.key[0], salt)


def query_quantile(window: WindowState, qs, **kw) -> err.Estimate:
    """Windowed approximate quantiles over the merged intervals."""
    kw.setdefault("key", _window_key(window, 0x51A17))
    return qt.query_quantile(sample_view(window), qs, **kw)


def query_histogram(window: WindowState,
                    edges: torch.Tensor) -> err.Estimate:
    """Windowed per-bin COUNT estimates (K·S cells, Eq. 6 per bin)."""
    return qt.cell_counts(sample_view(window), edges)


def query_heavy_hitters(window: WindowState, k: int) -> sk.HeavyHitters:
    """Windowed approximate top-k heavy hitters."""
    return sk.query_heavy_hitters(sample_view(window), k)


def query_distinct(window: WindowState, **kw) -> err.Estimate:
    """Windowed approximate distinct count."""
    kw.setdefault("key", _window_key(window, 0xD157))
    return sk.query_distinct(sample_view(window), **kw)
