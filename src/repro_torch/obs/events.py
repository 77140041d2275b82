"""Structured event log: append-only JSONL with a versioned schema.

Counterpart of the reference's ``obs/events.py``, the same schema: the
per-interval answers with CI half-widths, watermark closes, checkpoint
save/restore costs and controller adaptations, emitted by the runtime at
its existing host-sync boundaries and read by
``python -m repro_torch.obs.summarize`` and ``chip_smoke.py``'s recovery
phase through the reducers in ``obs/export.py``.

Every event is one JSON object per line with three envelope fields:
``schema`` (the version below), ``type`` and a per-log monotonic
``seq``, plus the type's payload. :func:`validate_event` checks the
envelope and the per-type required fields; :func:`read_events` applies
it to a whole file.
"""
from __future__ import annotations

import json
from typing import IO, List, Optional, Union

SCHEMA_VERSION = 1

#: Required payload fields per event type (the envelope — ``schema``,
#: ``type``, ``seq`` — is required for every event).  Emitters may add
#: optional fields; validators only insist on these.
EVENT_FIELDS = {
    "run_meta": ("mode", "emission", "num_strata", "num_intervals",
                 "interval_span", "allowed_lateness", "num_shards",
                 "queries"),
    "emission": ("index", "interval", "watermark", "open_interval",
                 "on_time", "late", "dropped", "items", "latency_s",
                 "capacity", "results"),
    "watermark_close": ("interval", "watermark", "staleness"),
    "controller": ("capacity", "pressure", "latency_ema"),
    "batch_resize": ("batch_chunks",),
    "checkpoint_save": ("stream_offset", "bytes", "serialize_s",
                        "drift_chunks"),
    "checkpoint_restore": ("stream_offset", "restore_s"),
    "retrace": ("step", "traces", "allowed"),
}


class EventLog:
    """Append-only event sink: in-memory list + optional JSONL file.

    ``path=None`` keeps events only in memory (tests, ad-hoc runs); with
    a path every event is appended and flushed as one JSON line, so a
    crashed process leaves a readable prefix.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.events: List[dict] = []
        self._fh: Optional[IO[str]] = (
            open(path, "a", encoding="utf-8") if path else None)

    def emit(self, type: str, **fields) -> dict:
        ev = {"schema": SCHEMA_VERSION, "type": type,
              "seq": len(self.events), **fields}
        validate_event(ev)
        self.events.append(ev)
        if self._fh is not None:
            self._fh.write(json.dumps(ev) + "\n")
            self._fh.flush()
        return ev

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def of_type(self, type: str) -> List[dict]:
        return [e for e in self.events if e["type"] == type]


def validate_event(ev: dict) -> dict:
    """Check one event against the schema; returns it (chainable)."""
    for k in ("schema", "type", "seq"):
        if k not in ev:
            raise ValueError(f"event missing envelope field {k!r}: {ev}")
    if ev["schema"] != SCHEMA_VERSION:
        raise ValueError(
            f"event schema version {ev['schema']!r} != {SCHEMA_VERSION} "
            "(regenerate the log with this build)")
    required = EVENT_FIELDS.get(ev["type"])
    if required is None:
        raise ValueError(f"unknown event type {ev['type']!r}; "
                         f"one of {sorted(EVENT_FIELDS)}")
    missing = [f for f in required if f not in ev]
    if missing:
        raise ValueError(
            f"{ev['type']} event missing fields {missing}: {ev}")
    return ev


def read_events(source: Union[str, IO[str]],
                type: Optional[str] = None) -> List[dict]:
    """Parse + validate a JSONL event log (path or open file); filter to
    one event type if given."""
    if isinstance(source, str):
        with open(source, "r", encoding="utf-8") as fh:
            return read_events(fh, type=type)
    out = []
    for line in source:
        line = line.strip()
        if not line:
            continue
        ev = validate_event(json.loads(line))
        if type is None or ev["type"] == type:
            out.append(ev)
    return out
