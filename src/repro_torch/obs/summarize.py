"""``python -m repro_torch.obs.summarize``: render an event log as a report.

Counterpart of the reference's ``obs/summarize.py``. Reads one JSONL
event log (``obs/events.py`` schema) and prints the run's event census,
accuracy (per-query realized CI half-widths), timeliness (staleness per
closed interval, emission latency percentiles) and fault-tolerance cost
(checkpoint bytes, time and cadence drift, recovery latency). All
numbers come from the ``obs/export.py`` reducers.

``--smoke`` first runs a small pipelined stream from the port's own
``GaussianSource`` on ``--device`` (the card unless ``--device cpu``),
with a checkpointer and a telemetry hub attached, writes its event log,
then summarizes it: the liveness check of the whole telemetry path.
"""
from __future__ import annotations

import argparse
import collections
import os
import sys
import tempfile

import numpy as np

from repro_torch.obs import export as obx
from repro_torch.obs.events import read_events


def _fmt_pct(xs) -> str:
    if not xs:
        return "n/a"
    a = np.asarray(xs, np.float64)
    return (f"p50={np.percentile(a, 50):.4g} "
            f"p95={np.percentile(a, 95):.4g} "
            f"max={a.max():.4g} (n={len(a)})")


def render(events, span=None) -> str:
    """The report body (a plain-text table) for a parsed event list."""
    lines = []
    census = collections.Counter(ev["type"] for ev in events)
    meta = obx.run_meta(events)
    lines.append("== run ==")
    if meta is not None:
        lines.append(
            f"mode={meta['mode']} emission={meta['emission']} "
            f"strata={meta['num_strata']} intervals={meta['num_intervals']}"
            f"×{meta['interval_span']} lateness={meta['allowed_lateness']} "
            f"shards={meta['num_shards']}")
        if span is None:
            span = meta["interval_span"]
    lines.append("events: " + ", ".join(
        f"{t}={n}" for t, n in sorted(census.items())))

    ems = [ev for ev in events if ev["type"] == "emission"]
    if ems:
        lines.append("== timeliness ==")
        closed = obx.closed_intervals(events, span)
        st = obx.staleness_series(events, span)
        lines.append(f"closed intervals: {len(closed)}")
        if st:
            lines.append(f"staleness (event-time units): mean="
                         f"{np.mean(st):.4g} " + _fmt_pct(st))
        lines.append("emission latency (s): "
                     + _fmt_pct(obx.latency_series(events)))
        lines.append("== accuracy ==")
        for q in sorted(ems[0]["results"]):
            hw = obx.half_width_series(events, q)
            lines.append(f"{q}: hw95 mean={np.mean(hw):.4g} "
                         + _fmt_pct(hw))

    cs = obx.checkpoint_stats(events)
    if cs["saves"] or cs["restores"]:
        lines.append("== fault tolerance ==")
        lines.append(
            f"saves={cs['saves']} bytes_total={cs['bytes_total']} "
            f"serialize_s_mean={cs['serialize_s_mean']:.4g} "
            f"drift_chunks_max={cs['drift_chunks_max']}")
        if cs["restores"]:
            lines.append(f"restores={cs['restores']} "
                         f"restore_s_last={cs['restore_s_last']:.4g}")
    return "\n".join(lines)


def _smoke_log(path: str, device=None) -> None:
    """A small end-to-end run's event log, the reference's smoke run: 16
    chunks of 128 items of the §5.1 stream (aggregator seed 7) at 512
    items per event-time unit, watermark emission, a checkpoint every 8
    chunks."""
    from repro_torch import prng
    from repro_torch.obs import EventLog, Telemetry
    from repro_torch.runtime import Checkpointer
    from repro_torch.runtime.executor import PipelinedExecutor, RuntimeConfig
    from repro_torch.runtime.registry import QueryRegistry
    from repro_torch.stream import (GaussianSource, ReplayableStream,
                                    StreamAggregator)
    from repro_torch.utils import resolve_device
    dev = resolve_device(device)
    reg = (QueryRegistry().register("avg", "mean")
           .register("total", "sum"))
    cfg = RuntimeConfig(num_strata=3, capacity=32, num_intervals=4,
                        interval_span=1.0, allowed_lateness=0.25,
                        emission="watermark")
    stream = ReplayableStream(
        StreamAggregator(GaussianSource(), seed=7, device=dev),
        chunk_size=128, rate=512.0)
    with EventLog(path) as log:
        ex = PipelinedExecutor(cfg, reg, prng.PRNGKey(0), device=dev,
                               checkpointer=Checkpointer(every_chunks=8),
                               telemetry=Telemetry(log))
        ex.run(stream.prefix(16))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.summarize", description=__doc__)
    ap.add_argument("log", nargs="?", help="JSONL event log path")
    ap.add_argument("--span", type=float, default=None,
                    help="interval span override (cadence logs without "
                         "a run_meta event)")
    ap.add_argument("--smoke", action="store_true",
                    help="generate a small run's event log, then "
                         "summarize it")
    ap.add_argument("--device", default=None,
                    help="device of the --smoke run (default: the card)")
    args = ap.parse_args(argv)
    if args.smoke:
        path = args.log
        if path is None:
            fd, path = tempfile.mkstemp(suffix=".jsonl")
            os.close(fd)
        try:
            _smoke_log(path, args.device)
            events = read_events(path)
        finally:
            if args.log is None:
                os.remove(path)
        print(render(events, span=args.span))
        if not any(e["type"] == "emission" for e in events):
            raise RuntimeError("smoke run produced no emission events")
        return 0
    if not args.log:
        ap.error("event log path required (or --smoke)")
    print(render(read_events(args.log), span=args.span))
    return 0


if __name__ == "__main__":
    sys.exit(main())
