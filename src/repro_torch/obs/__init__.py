"""Observability without host waits on the hot loop.

Counterpart of the reference's ``obs`` package:

* :mod:`repro_torch.obs.metrics` — device counters folded inside the
  ingest, and the host :class:`~repro_torch.obs.metrics.Telemetry` hub
  that reads them only where the host already waits (emissions,
  checkpoints, micro-batch flushes);
* :mod:`repro_torch.obs.events` — the append-only JSONL event log, the
  reference's schema;
* :mod:`repro_torch.obs.export` — Prometheus text and the event-log
  reductions behind ``python -m repro_torch.obs.summarize``;
* :mod:`repro_torch.obs.sentinel` — the retrace sentinel guarding each
  executor step: a step run at a new input signature after warmup logs
  (or, opt-in, raises).
"""
from repro_torch.obs import events, metrics, sentinel
from repro_torch.obs.events import (SCHEMA_VERSION, EventLog, read_events,
                                    validate_event)
from repro_torch.obs.metrics import MetricsState, Telemetry
from repro_torch.obs.sentinel import RetraceError, RetraceSentinel

__all__ = [
    "events", "metrics", "sentinel",
    "SCHEMA_VERSION", "EventLog", "read_events", "validate_event",
    "MetricsState", "Telemetry", "RetraceError", "RetraceSentinel",
]
