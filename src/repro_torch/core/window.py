"""Sliding-window ring of ``K`` per-interval OASRS states, paper §2.2/§3.1.

Counterpart of the reference's ``core/window.py`` (the parts the merged
window needs). The ring is one stacked :class:`OASRSState` with
``values [K, S, N_max]``, ``counts``/``capacity [K, S]`` and ``key
[K, 2]``; merging the intervals is the concatenation of their
``K·S`` independently sampled cells (Eq. 5).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import prng
from repro_torch.core import oasrs
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
