"""Surfacing: Prometheus-style exposition and event-log reductions.

Counterpart of the reference's ``obs/export.py``, the same text and the
same reductions:

* :func:`prometheus_text` renders an executor's device counters and its
  attached telemetry's host mirrors as Prometheus text exposition, the
  same string as the reference's for the same counters and summary.
* The series reducers (:func:`staleness_series`,
  :func:`half_width_series`, :func:`checkpoint_stats`) compute their
  quantities from the event log alone; ``python -m
  repro_torch.obs.summarize`` and ``chip_smoke.py``'s recovery phase run
  them.

All event-time arithmetic is ``float32``, as the device watermark's (the
staleness of interval ``j`` at an emission is
``f32(watermark) − f32((j+1)·span)``).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.error import Z_FOR_CONFIDENCE
from repro_torch.obs import metrics as obm
from repro_torch.obs.events import read_events


def _events(source) -> List[dict]:
    if isinstance(source, str):
        return read_events(source)
    return list(source)


def run_meta(source) -> Optional[dict]:
    for ev in _events(source):
        if ev["type"] == "run_meta":
            return ev
    return None


def closed_intervals(source, span: Optional[float] = None) -> List[int]:
    """Event intervals the run's watermark closed, from the log alone.

    A watermark-driven run logs its closes directly. A cadence run
    does not, but the final emission's watermark pins them: interval
    ``j`` closed iff ``watermark >= (j+1)·span``, i.e. every ``j`` up to
    ``floor(w/span) − 1`` (float32, mirroring
    ``watermark.host_closed_through``).
    """
    evs = _events(source)
    closes = [ev["interval"] for ev in evs
              if ev["type"] == "watermark_close"]
    if closes:
        return closes
    ems = [ev for ev in evs if ev["type"] == "emission"]
    if not ems:
        return []
    if span is None:
        meta = run_meta(evs)
        if meta is None:
            raise ValueError("cadence log has no run_meta event; pass "
                             "span= explicitly")
        span = meta["interval_span"]
    w = np.float32(ems[-1]["watermark"])
    through = int(np.floor(w / np.float32(span))) - 1
    return list(range(0, through + 1))


def staleness_series(source, span: Optional[float] = None,
                     intervals: Optional[List[int]] = None) -> List[float]:
    """Per closed interval: frontier progress past its close at the
    FIRST emission whose watermark covers it, from emission events
    alone.

    ``intervals`` overrides the closed set (e.g. a cadence run measured
    against a watermark probe's closes); default: the log's own.
    """
    evs = _events(source)
    if span is None:
        meta = run_meta(evs)
        if meta is None:
            raise ValueError("log has no run_meta event; pass span=")
        span = meta["interval_span"]
    if intervals is None:
        intervals = closed_intervals(evs, span)
    ems = [ev for ev in evs if ev["type"] == "emission"]
    out = []
    for j in intervals:
        close = np.float32((j + 1) * span)
        for em in ems:
            if np.float32(em["watermark"]) >= close:
                out.append(float(np.float32(em["watermark"]) - close))
                break
    return out


def half_width_series(source, query: str) -> List[float]:
    """Realized 95% CI half-width of one standing query per emission
    (vector answers — per-key/quantile — reduce to their mean width)."""
    out = []
    for ev in _events(source):
        if ev["type"] != "emission":
            continue
        r = ev["results"].get(query)
        if r is None:
            raise KeyError(f"query {query!r} not in emission results "
                           f"{sorted(ev['results'])}")
        out.append(float(np.mean(r["hw95"])))
    return out


def latency_series(source) -> List[float]:
    return [float(ev["latency_s"]) for ev in _events(source)
            if ev["type"] == "emission"]


def checkpoint_stats(source) -> dict:
    """Checkpoint cost/recovery summary from save/restore events."""
    evs = _events(source)
    saves = [ev for ev in evs if ev["type"] == "checkpoint_save"]
    restores = [ev for ev in evs if ev["type"] == "checkpoint_restore"]
    return {
        "saves": len(saves),
        "bytes_total": sum(ev["bytes"] for ev in saves),
        "bytes_last": saves[-1]["bytes"] if saves else 0,
        "serialize_s_mean": (float(np.mean([ev["serialize_s"]
                                            for ev in saves]))
                             if saves else 0.0),
        "drift_chunks_max": (max(abs(ev["drift_chunks"]) for ev in saves)
                             if saves else 0),
        "restores": len(restores),
        "restore_s_last": (restores[-1]["restore_s"]
                           if restores else None),
    }


# ---------------------------------------------------------------------------
# Prometheus-style text exposition.
# ---------------------------------------------------------------------------


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def estimates_prometheus_text(estimates: dict,
                              prefix: str = "repro_serve") -> str:
    """Render ``name → Estimate`` mappings as Prometheus text: each
    query becomes a value gauge plus an ``_hw95`` gauge (the 95%
    half-width, ``z·sqrt(max(var, 0))``), vector answers labelled by
    index. Reads the estimates back."""
    z = Z_FOR_CONFIDENCE[0.95]
    lines = []
    for name, est in estimates.items():
        value = np.atleast_1d(_host(est.value).astype(np.float32))
        var = np.atleast_1d(_host(est.variance).astype(np.float32))
        hw = z * np.sqrt(np.maximum(var, 0.0))
        scalar = _host(est.value).ndim == 0
        for metric, vec in ((name, value), (f"{name}_hw95", hw)):
            lines.append(f"# TYPE {prefix}_{metric} gauge")
            if scalar:
                lines.append(f"{prefix}_{metric} {float(vec[0]):.6g}")
            else:
                for i, v in enumerate(vec):
                    lines.append(f'{prefix}_{metric}{{index="{i}"}} '
                                 f"{float(v):.6g}")
    return "\n".join(lines) + "\n"


_COUNTER_HELP = {
    "ingested": "masked arrivals routed per stratum",
    "accepted": "arrivals folded into the reservoirs per stratum",
    "late": "accepted arrivals older than the open interval",
    "dropped": "arrivals refused by watermark or ring eviction",
    "replaced": "arrivals that hit a full reservoir cell",
}


def prometheus_text(ex, telemetry=None) -> str:
    """Render one executor (+ optional Telemetry) as Prometheus text.

    Reads the device counters back: call at a host-sync boundary, like a
    checkpoint or an emission (a metrics scrape is a sync point).
    """
    c = obm.counters(ex.state.metrics)
    lines = []

    def counter(name, values, help_):
        lines.append(f"# HELP repro_{name} {help_}")
        lines.append(f"# TYPE repro_{name} counter")
        for s, v in enumerate(np.atleast_1d(values)):
            lines.append(f'repro_{name}{{stratum="{s}"}} {int(v)}')

    for key, help_ in _COUNTER_HELP.items():
        counter(f"items_{key}_total", c[key], help_)
    lines.append("# HELP repro_reservoir_occupancy resident sampled items "
                 "per stratum")
    lines.append("# TYPE repro_reservoir_occupancy gauge")
    for s, v in enumerate(np.atleast_1d(c["occupancy"])):
        lines.append(f'repro_reservoir_occupancy{{stratum="{s}"}} {int(v)}')
    lines.append("# TYPE repro_chunks_total counter")
    lines.append(f"repro_chunks_total {c['chunks']}")
    lines.append("# TYPE repro_items_total counter")
    lines.append(f"repro_items_total {c['items']}")

    if telemetry is None:
        telemetry = getattr(ex, "telemetry", None)
    if telemetry is not None:
        s = telemetry.summary()
        lines.append("# TYPE repro_emissions_total counter")
        lines.append(f"repro_emissions_total {s['emissions']}")
        lines.append("# TYPE repro_step_latency_seconds summary")
        for q, k in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            lines.append(f'repro_step_latency_seconds{{quantile="{q}"}} '
                         f"{s['latency_s'][k]:.6g}")
        lines.append("# TYPE repro_watermark_lag summary")
        for q, k in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            lines.append(f'repro_watermark_lag{{quantile="{q}"}} '
                         f"{s['watermark_lag'][k]:.6g}")
        lines.append("# TYPE repro_checkpoint_saves_total counter")
        lines.append(f"repro_checkpoint_saves_total "
                     f"{s['checkpoint_saves']}")
        lines.append("# TYPE repro_checkpoint_bytes_total counter")
        lines.append(f"repro_checkpoint_bytes_total "
                     f"{s['checkpoint_bytes']}")
        if s["capacity_last"] is not None:
            lines.append("# TYPE repro_controller_capacity gauge")
            for i, v in enumerate(s["capacity_last"]):
                lines.append(f'repro_controller_capacity{{stratum="{i}"}} '
                             f"{int(v)}")
        if s["batch_chunks_last"] is not None:
            lines.append("# TYPE repro_batch_chunks gauge")
            lines.append(f"repro_batch_chunks {s['batch_chunks_last']}")
    return "\n".join(lines) + "\n"
