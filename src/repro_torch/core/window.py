"""Sliding-window ring of ``K`` per-interval OASRS states, paper §2.2/§3.1.

Counterpart of the reference's ``core/window.py``. The ring is one
stacked :class:`OASRSState` with ``values [K, S, N_max, ...]`` (or a
tree of such leaves, from a payload spec),
``counts``/``capacity [K, S]`` and ``key [K, 2]``; merging the intervals
is the concatenation of their ``K·S`` independently sampled cells
(Eq. 5). ``W`` shards' rings stack on one more leading axis, and their
merge is the concatenation of the ``W·K·S`` cells. Per-key and session
windows are cell subsets of the same merged view
(:func:`restrict_view`), and the nonlinear queries read the merged view
unchanged. Every query takes ``extract``, which maps the ring's values
tree to one ``[K, S, N_max]`` tensor (the identity by default), as the
reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import prng
from repro_torch.core import error as err
from repro_torch.core import oasrs
from repro_torch.core import quantile as qt
from repro_torch.core import sketches as sk
from repro_torch.core.quantile import SampleView
from repro_torch.utils import DeviceLike, resolve_device, tree_map

Extract = Callable[[object], torch.Tensor]


@dataclasses.dataclass
class WindowState:
    """Ring of ``K`` per-interval OASRS states (stacked on axis 0)."""
    intervals: oasrs.OASRSState
    cursor: torch.Tensor      # () int32 — next slot to overwrite
    filled: torch.Tensor      # () int32 — number of live intervals


def init(num_intervals: int, num_strata: int, capacity, key: torch.Tensor,
         max_capacity: Optional[int] = None,
         payload_spec=oasrs.PayloadSpec(),
         device: DeviceLike = None) -> WindowState:
    """Empty ring. ``key`` is ``[2]``, or ``[W, 2]`` for ``W`` shards'
    rings stacked on a leading axis (``values [W, K, S, N_max]``,
    ``cursor``/``filled [W]``); ``capacity`` an int or ``[S]`` ints;
    ``payload_spec`` one item's :class:`~repro_torch.core.oasrs.PayloadSpec`
    or a tree of them (each leaf ``[..., K, S, N_max, *shape]``). Every
    leaf is a fresh buffer: the ring is updated in place later."""
    dev = resolve_device(device)
    keys = prng.split(key.to(dev), num_intervals)     # [..., K, 2]
    lead = tuple(keys.shape[:-2])
    cap = torch.as_tensor(capacity, dtype=torch.int32)
    if max_capacity is None:
        max_capacity = int(cap.max())
    shape = lead + (num_intervals, num_strata)
    intervals = oasrs.OASRSState(
        values=tree_map(lambda sp: torch.zeros(
            shape + (max_capacity,) + tuple(sp.shape), dtype=sp.dtype,
            device=dev), payload_spec),
        counts=torch.zeros(shape, dtype=torch.int32, device=dev),
        capacity=cap.to(dev).expand(shape).clone(),
        key=keys)
    zero = torch.zeros(lead, dtype=torch.int32, device=dev)
    return WindowState(intervals=intervals, cursor=zero,
                       filled=zero.clone())


def slide(window: WindowState, fresh: oasrs.OASRSState) -> WindowState:
    """Advance one slide step: ``fresh`` (one interval's state) takes the
    cursor's slot, evicting the oldest interval. The ring's tensors (every
    values leaf) are written in place; ``cursor`` and ``filled`` are
    new."""
    iv = window.intervals
    k = iv.counts.shape[0]
    at = window.cursor.long().view(1)

    def put(ring, new):
        ring.index_copy_(0, at, new.to(ring.dtype).unsqueeze(0))
    tree_map(put, iv.values, fresh.values)
    for ring, new in ((iv.counts, fresh.counts),
                      (iv.capacity, fresh.capacity), (iv.key, fresh.key)):
        put(ring, new)
    return WindowState(intervals=iv, cursor=(window.cursor + 1) % k,
                       filled=torch.clamp(window.filled + 1, max=k))


def interval_capacity(window: WindowState) -> torch.Tensor:
    """Capacity vector of the current insert slot (the adaptive loop's
    input)."""
    return window.intervals.capacity.index_select(
        0, window.cursor.long().view(1))[0]


def with_capacity(window: WindowState,
                  capacity: torch.Tensor) -> WindowState:
    """Every interval's per-stratum capacity set to ``capacity [S]``
    (adaptive feedback); a fresh capacity tensor, the rest shared."""
    iv = window.intervals
    cap = capacity.to(device=iv.capacity.device, dtype=torch.int32)
    intervals = dataclasses.replace(
        iv, capacity=cap.expand(iv.capacity.shape).clone())
    return dataclasses.replace(window, intervals=intervals)


def _live_mask(window: WindowState) -> torch.Tensor:
    """``[K]`` bool — the ``filled`` most recent slots (``[W, K]``)."""
    k = window.intervals.counts.shape[-2]
    age = torch.remainder(
        torch.arange(k, dtype=torch.int32, device=window.cursor.device)
        - window.cursor[..., None], max(k, 1))
    return age >= (k - window.filled[..., None])


def sample_view(window: WindowState,
                extract: Extract = lambda v: v) -> SampleView:
    """Merged weighted sample of all live intervals: ``K·S`` cells, or
    the ``W·K·S`` (shard × interval × stratum) cells of a sharded ring in
    shard-major order (the Eq. 5 concatenation across shards).

    ``extract`` maps the values tree to one ``[K, S, N_max]`` tensor
    (``[W, K, S, N_max]`` sharded); with the identity on an f32 ring,
    ``values`` is a view of the ring, not a copy. Dead intervals get
    zero counts and so zero weight and no valid slot.
    """
    iv = window.intervals
    n = iv.max_capacity
    xs = extract(iv.values)
    if tuple(xs.shape) != tuple(iv.counts.shape) + (n,):
        raise ValueError("extract must return [K, S, N_max] array, got "
                         f"{tuple(xs.shape)}")
    live = _live_mask(window)
    counts = torch.where(live[..., None], iv.counts, 0)
    taken = torch.minimum(counts, iv.capacity)
    return SampleView(values=xs.to(torch.float32).reshape(-1, n),
                      counts=counts.reshape(-1), taken=taken.reshape(-1))


def activity_mask(window: WindowState) -> torch.Tensor:
    """``[K, S]`` — live cells that accepted at least one item."""
    return _live_mask(window)[..., None] & (window.intervals.counts > 0)


def restrict_view(view: SampleView, cell_mask: torch.Tensor) -> SampleView:
    """Zero the counts/taken of cells outside ``cell_mask``."""
    return dataclasses.replace(
        view, counts=torch.where(cell_mask, view.counts, 0),
        taken=torch.where(cell_mask, view.taken, 0))


def window_stats(window: WindowState,
                 extract: Extract = lambda v: v) -> err.StratumStats:
    """Stats of all live intervals, flattened to ``K·S`` strata (one
    stats pass over the merged view; dead intervals count nothing)."""
    view = sample_view(window, extract)
    return err.stratum_stats_from_sample(view.values, view.counts,
                                         view.taken, view.slot_mask())


def query_sum(window: WindowState,
              extract: Extract = lambda v: v) -> err.Estimate:
    """Windowed SUM over the live intervals (Eq. 5: the cells' variances
    add)."""
    return err.estimate_sum(window_stats(window, extract))


def query_mean(window: WindowState,
               extract: Extract = lambda v: v) -> err.Estimate:
    """Windowed MEAN over the live intervals."""
    return err.estimate_mean(window_stats(window, extract))


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


def query_per_key_sum(window: WindowState,
                      extract: Extract = lambda v: v) -> err.Estimate:
    """Per-key tumbling-window SUMs: a vector Estimate, one per stratum."""
    s = window.intervals.counts.shape[1]
    stats = window_stats(window, extract)
    gid = torch.arange(stats.counts.shape[0], dtype=torch.int32,
                       device=stats.counts.device) % s
    return err.estimate_sum_grouped(stats, gid, s)


def query_session_sum(window: WindowState, gap_intervals: int,
                      slot_interval: Optional[torch.Tensor] = None,
                      extract: Extract = lambda v: v) -> err.Estimate:
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
    view = restrict_view(sample_view(window, extract), smask.reshape(-1))
    stats = err.stratum_stats_from_sample(view.values, view.counts,
                                          view.taken, view.slot_mask())
    gid = torch.arange(k * s, dtype=torch.int32, device=dev) % s
    return err.estimate_sum_grouped(stats, gid, s)


def _window_key(window: WindowState, salt: int) -> torch.Tensor:
    return prng.fold_in(window.intervals.key[0], salt)


def query_quantile(window: WindowState, qs, extract: Extract = lambda v: v,
                   **kw) -> err.Estimate:
    """Windowed approximate quantiles over the merged intervals."""
    kw.setdefault("key", _window_key(window, 0x51A17))
    return qt.query_quantile(sample_view(window, extract), qs, **kw)


def query_histogram(window: WindowState, edges: torch.Tensor,
                    extract: Extract = lambda v: v) -> err.Estimate:
    """Windowed per-bin COUNT estimates (K·S cells, Eq. 6 per bin)."""
    return qt.cell_counts(sample_view(window, extract), edges)


def query_heavy_hitters(window: WindowState, k: int,
                        extract: Extract = lambda v: v) -> sk.HeavyHitters:
    """Windowed approximate top-k heavy hitters."""
    return sk.query_heavy_hitters(sample_view(window, extract), k)


def query_distinct(window: WindowState, extract: Extract = lambda v: v,
                   **kw) -> err.Estimate:
    """Windowed approximate distinct count."""
    kw.setdefault("key", _window_key(window, 0xD157))
    return sk.query_distinct(sample_view(window, extract), **kw)
