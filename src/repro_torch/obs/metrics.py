"""Device counters folded inside the ingest.

Counterpart of the reference's ``obs/metrics.py`` (device side):
cumulative per-stratum counters, updated on the device with every chunk
and never read back except at an emission. ``Telemetry`` (the host-side
mirrors and the event log) comes in a later slice.

* ``ingested[s]``  — masked arrivals of stratum ``s``;
* ``accepted[s]``  — arrivals that survived watermark and ring eviction;
* ``late[s]``      — accepted arrivals older than the pre-chunk open
  interval;
* ``dropped[s]``   — masked arrivals refused;
* ``replaced[s]``  — arrivals into an already-full cell (Vitter's
  replacement phase);
* ``occupancy[s]`` — gauge: items resident across the stratum's cells;
* ``chunks``/``items`` — scalar stream totals.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.utils import bincount


@dataclasses.dataclass
class MetricsState:
    ingested: torch.Tensor    # [S] i32
    accepted: torch.Tensor    # [S] i32
    late: torch.Tensor        # [S] i32
    dropped: torch.Tensor     # [S] i32
    replaced: torch.Tensor    # [S] i32
    occupancy: torch.Tensor   # [S] i32 gauge
    chunks: torch.Tensor      # () i32
    items: torch.Tensor       # () i32


def init(num_strata: int, device) -> MetricsState:
    def z(shape=(num_strata,)):
        return torch.zeros(shape, dtype=torch.int32, device=device)
    return MetricsState(ingested=z(), accepted=z(), late=z(), dropped=z(),
                        replaced=z(), occupancy=z(), chunks=z(()),
                        items=z(()))


def _per_stratum(pred: torch.Tensor, stratum_ids: torch.Tensor,
                 num_strata: int) -> torch.Tensor:
    """Count ``pred`` items per stratum (excluded items go to sentinel S)."""
    sid = torch.where(pred, stratum_ids.to(torch.int32), num_strata)
    return bincount(sid, num_strata + 1)[:num_strata]


def ingest_update(m: MetricsState, num_strata: int,
                  stratum_ids: torch.Tensor, mask: torch.Tensor,
                  accept: torch.Tensor, target_interval: torch.Tensor,
                  open_before: torch.Tensor, counts_before: torch.Tensor,
                  counts_after: torch.Tensor,
                  capacity: torch.Tensor) -> MetricsState:
    """Fold one routed chunk's accounting. ``counts_before`` are the
    ``[K, S]`` cell counts after slot reset and before the fold."""
    i32 = torch.int32
    late = accept & (target_interval < open_before)
    filled0 = torch.minimum(counts_before, capacity)
    filled1 = torch.minimum(counts_after, capacity)
    repl = (counts_after - counts_before) - (filled1 - filled0)
    return MetricsState(
        ingested=m.ingested + _per_stratum(mask, stratum_ids, num_strata),
        accepted=m.accepted + _per_stratum(accept, stratum_ids, num_strata),
        late=m.late + _per_stratum(late, stratum_ids, num_strata),
        dropped=m.dropped + _per_stratum(mask & ~accept, stratum_ids,
                                         num_strata),
        replaced=m.replaced + torch.sum(repl, dim=0, dtype=i32),
        occupancy=torch.sum(filled1, dim=0, dtype=i32),
        chunks=m.chunks + 1,
        items=m.items + torch.sum(mask, dtype=i32))
