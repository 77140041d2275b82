"""Device counters folded inside the ingest, and the host telemetry hub.

Counterpart of the reference's ``obs/metrics.py``. Device side:
cumulative per-stratum counters, updated on the device with every chunk
and never read back except at an emission or a checkpoint. Host side:
:class:`Telemetry` keeps the mirrors that are only observable where the
host already waits (emission, checkpoint and micro-batch boundaries) and
writes the event log (``obs/events.py``). ``export`` feeds the
checkpoint manifest; ``from_export`` is kept for parity with the
reference's API only (only the tests call it).

* ``ingested[s]``  — masked arrivals of stratum ``s``;
* ``accepted[s]``  — arrivals that survived watermark and ring eviction;
* ``late[s]``      — accepted arrivals older than the pre-chunk open
  interval;
* ``dropped[s]``   — masked arrivals refused;
* ``replaced[s]``  — arrivals into an already-full cell (Vitter's
  replacement phase);
* ``occupancy[s]`` — gauge: items resident across the stratum's cells;
* ``chunks``/``items`` — scalar stream totals.

The one-shot ingest kernel takes the per-stratum rows as one ``[6, S]``
tile (``stack_counters`` / ``unstack_counters``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
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


def init(num_strata: int, device, lead: tuple = ()) -> MetricsState:
    """Zero counters; ``lead`` is the shard axis (``(W,)``) or none."""
    def z(shape=(num_strata,)):
        return torch.zeros(lead + shape, dtype=torch.int32, device=device)
    return MetricsState(ingested=z(), accepted=z(), late=z(), dropped=z(),
                        replaced=z(), occupancy=z(), chunks=z(()),
                        items=z(()))


def _per_stratum(pred: torch.Tensor, stratum_ids: torch.Tensor,
                 num_strata: int) -> torch.Tensor:
    """Count ``pred`` items per stratum (excluded items go to sentinel S).
    ``[W, M]`` items count per row: row ``w`` into bins ``w·(S+1) ...``
    of one bincount."""
    sid = torch.where(pred, stratum_ids.to(torch.int32), num_strata)
    if sid.dim() == 1:
        return bincount(sid, num_strata + 1)[:num_strata]
    rows = sid.shape[0]
    base = torch.arange(rows, dtype=torch.int32, device=sid.device)
    sid = sid + (base * (num_strata + 1))[:, None]
    return bincount(sid.reshape(-1), rows * (num_strata + 1)).view(
        rows, num_strata + 1)[:, :num_strata]


def ingest_update(m: MetricsState, num_strata: int,
                  stratum_ids: torch.Tensor, mask: torch.Tensor,
                  accept: torch.Tensor, target_interval: torch.Tensor,
                  open_before: torch.Tensor, counts_before: torch.Tensor,
                  counts_after: torch.Tensor,
                  capacity: torch.Tensor) -> MetricsState:
    """Fold one routed chunk's accounting. ``counts_before`` are the
    ``[K, S]`` cell counts after slot reset and before the fold. A
    sharded state folds a ``[W, M]`` chunk into its ``[W]`` rows."""
    i32 = torch.int32
    late = accept & (target_interval < open_before[..., None])
    filled0 = torch.minimum(counts_before, capacity)
    filled1 = torch.minimum(counts_after, capacity)
    repl = (counts_after - counts_before) - (filled1 - filled0)
    return MetricsState(
        ingested=m.ingested + _per_stratum(mask, stratum_ids, num_strata),
        accepted=m.accepted + _per_stratum(accept, stratum_ids, num_strata),
        late=m.late + _per_stratum(late, stratum_ids, num_strata),
        dropped=m.dropped + _per_stratum(mask & ~accept, stratum_ids,
                                         num_strata),
        replaced=m.replaced + torch.sum(repl, dim=-2, dtype=i32),
        occupancy=torch.sum(filled1, dim=-2, dtype=i32),
        chunks=m.chunks + 1,
        items=m.items + torch.sum(mask, dim=-1, dtype=i32))


#: Row order of the ``[6, S]`` counter tile the one-shot ingest kernel
#: updates in place: the per-stratum fields, scalars excluded.
COUNTER_FIELDS = ("ingested", "accepted", "late", "dropped",
                  "replaced", "occupancy")


def stack_counters(m: MetricsState) -> torch.Tensor:
    """``[6, S]`` row-stack of the per-stratum counters (a new tensor;
    ``[W, 6, S]`` for a sharded state)."""
    return torch.stack([getattr(m, name) for name in COUNTER_FIELDS],
                       dim=-2)


def unstack_counters(rows: torch.Tensor, chunks: torch.Tensor,
                     items: torch.Tensor) -> MetricsState:
    """A :class:`MetricsState` from the ``[6, S]`` tile (``[W, 6, S]``)
    and the scalar totals. Each row gets its own buffer (``clone``): the
    state is updated in place later, so no two fields may share one
    allocation."""
    fields = {name: rows[..., idx, :].clone()
              for idx, name in enumerate(COUNTER_FIELDS)}
    return MetricsState(chunks=chunks, items=items, **fields)


def export(m: MetricsState) -> dict:
    """Plain-Python view (checkpoint manifest, JSON events)."""
    return {f.name: getattr(m, f.name).tolist()
            for f in dataclasses.fields(MetricsState)}


def from_export(d: dict, device) -> MetricsState:
    """A :class:`MetricsState` on ``device`` from :func:`export`."""
    return MetricsState(**{
        f.name: torch.tensor(d[f.name], dtype=torch.int32, device=device)
        for f in dataclasses.fields(MetricsState)})


def counters(m: MetricsState) -> dict:
    """Host snapshot, the shard axis (if any) summed away: per-stratum
    numpy rows, ``chunks``/``items`` as ints. Reads the state back; call
    it at a boundary that already synchronized."""
    out = {}
    for f in dataclasses.fields(MetricsState):
        a = getattr(m, f.name).cpu().numpy().copy()   # not a live view
        if f.name in ("chunks", "items"):
            out[f.name] = int(a.sum())
        else:
            out[f.name] = a.sum(axis=0) if a.ndim == 2 else a
    return out


# ---------------------------------------------------------------------------
# Host-side telemetry hub.
# ---------------------------------------------------------------------------

def _percentiles(xs: List[float]) -> dict:
    if not xs:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0}
    a = np.asarray(xs, np.float64)
    return {"p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)),
            "p99": float(np.percentile(a, 99))}


class Telemetry:
    """Host-side observability hub an executor reports into.

    Pass one as ``telemetry=`` to an executor (or through
    ``executor.attach_telemetry``). Every hook fires where the host
    already waited for the card (emission, checkpoint, micro-batch
    flush), so attaching one adds no read-back to the pipelined hot loop.

    ``log`` is an optional :class:`repro_torch.obs.events.EventLog`;
    without one the hub still keeps the in-memory mirrors behind
    :meth:`summary`. :meth:`on_retrace` writes the schema's ``retrace``
    event when an executor's retrace sentinel (``obs/sentinel.py``) sees
    a step run past its budget. ``strict_retrace`` (default: the
    ``REPRO_OBS_STRICT`` env var) makes those sentinels raise instead of
    record.
    """

    def __init__(self, log=None, strict_retrace: Optional[bool] = None):
        self.log = log
        self.strict_retrace = strict_retrace
        self.latencies: List[float] = []       # per-emission step latency
        self.batch_sizes: List[int] = []       # batched micro-batch knob
        self.capacity_traj: List[list] = []    # [S] capacity per emission
        self.watermark_lag: List[float] = []   # frontier - watermark
        self.staleness: List[float] = []       # close emissions only
        self.emissions = 0
        self.checkpoint_saves = 0
        self.checkpoint_restores = 0
        self.checkpoint_bytes = 0
        self.last_recovery_s: Optional[float] = None

    # -- executor hooks (each fires at an existing host-sync boundary) --

    def on_run_meta(self, ex) -> None:
        if self.log is None:
            return
        from repro_torch.runtime.registry import describe
        cfg = ex.cfg
        self.log.emit("run_meta", mode=ex.mode, emission=cfg.emission,
                      num_strata=cfg.num_strata,
                      num_intervals=cfg.num_intervals,
                      interval_span=cfg.interval_span,
                      allowed_lateness=cfg.allowed_lateness,
                      num_shards=cfg.num_shards,
                      queries=describe(ex.registry))

    def on_emission(self, ex, em) -> None:
        """One emission was recorded (the host just waited for it)."""
        from repro_torch.runtime import controller as ctl
        from repro_torch.runtime import watermark as wmk
        from repro_torch.runtime.registry import result_summary
        self.emissions += 1
        self.latencies.append(float(em.latency_s))
        self.capacity_traj.append(np.asarray(em.capacity).tolist())
        frontier = float(np.max(ex._host_frontier))
        if frontier > float(wmk.NEG_TIME):
            self.watermark_lag.append(frontier - em.watermark)
        stale = None
        if em.interval is not None:
            stale = wmk.staleness(em.watermark, em.interval,
                                  ex.cfg.interval_span)
            self.staleness.append(stale)
        if self.log is None:
            return
        fields = dict(
            index=em.index, interval=em.interval,
            watermark=float(em.watermark),
            open_interval=int(em.open_interval),
            on_time=int(em.on_time), late=int(em.late),
            dropped=int(em.dropped), items=int(em.items),
            latency_s=float(em.latency_s),
            capacity=np.asarray(em.capacity).tolist(),
            results=result_summary(em.results))
        if stale is not None:
            fields["staleness"] = stale
        self.log.emit("emission", **fields)
        if em.interval is not None:
            self.log.emit("watermark_close", interval=int(em.interval),
                          watermark=float(em.watermark), staleness=stale)
        self.log.emit("controller", **ctl.telemetry(ex._ctrl_rows))

    def on_flush(self, ex, batch_chunks: int) -> None:
        """Batched micro-batch boundary (the flush barrier)."""
        if not self.batch_sizes or self.batch_sizes[-1] != batch_chunks:
            if self.log is not None:
                self.log.emit("batch_resize", batch_chunks=batch_chunks)
        self.batch_sizes.append(batch_chunks)

    def on_checkpoint_save(self, stream_offset: int, num_bytes: int,
                           serialize_s: float, drift_chunks: int) -> None:
        self.checkpoint_saves += 1
        self.checkpoint_bytes += num_bytes
        if self.log is not None:
            self.log.emit("checkpoint_save", stream_offset=stream_offset,
                          bytes=num_bytes, serialize_s=serialize_s,
                          drift_chunks=drift_chunks)

    def on_checkpoint_restore(self, stream_offset: int,
                              restore_s: float) -> None:
        self.checkpoint_restores += 1
        self.last_recovery_s = restore_s
        if self.log is not None:
            self.log.emit("checkpoint_restore",
                          stream_offset=stream_offset, restore_s=restore_s)

    def on_retrace(self, name: str, traces: int, allowed: int) -> None:
        if self.log is not None:
            self.log.emit("retrace", step=name, traces=traces,
                          allowed=allowed)

    # -- read side --

    def summary(self) -> dict:
        """The host mirrors, reduced: what the Prometheus text and
        ``repro_torch.obs.summarize`` render."""
        return {
            "emissions": self.emissions,
            "latency_s": _percentiles(self.latencies),
            "watermark_lag": _percentiles(self.watermark_lag),
            "staleness": _percentiles(self.staleness),
            "batch_chunks_last": (self.batch_sizes[-1]
                                  if self.batch_sizes else None),
            "capacity_last": (self.capacity_traj[-1]
                              if self.capacity_traj else None),
            "checkpoint_saves": self.checkpoint_saves,
            "checkpoint_restores": self.checkpoint_restores,
            "checkpoint_bytes": self.checkpoint_bytes,
            "last_recovery_s": self.last_recovery_s,
        }
