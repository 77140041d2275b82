"""The traced run: ``torch.profiler`` over a fixed number of emission
periods at the start of the window, after one discarded warm-up period
(the tracer drops a trace's first events).

Each loop iteration (re-stamp, ``push``, the answers read back) runs in
a span of the benchmark's own, ``streambench.push``. An iteration whose
push emitted is an emission, any other an ingest. Each device activity
(kernel, memcpy, memset) belongs to the iteration whose host span holds
the host op that launched it, found through the profiler's launch
correlation. Only a summary is kept: no trace file is written.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional

SPAN = "streambench.push"


@dataclasses.dataclass
class Iteration:
    kind: str                  # "ingest" | "emission"
    chunk: int                 # stream index of the chunk pushed
    start_us: float
    end_us: float
    interval: Optional[int] = None   # the interval a watermark emission
    #                                  closed
    events: list = dataclasses.field(default_factory=list)
    #                            (name, start_us, duration_us) on the card


class Tracer:
    """Profiles ``periods`` emission periods after one warm-up period."""

    def __init__(self, periods: int):
        self.periods = periods
        self.prof = None
        self.stage = "off"        # off | warm | active | done
        self.kinds: List[str] = []
        self.chunks: List[int] = []
        self.intervals: List[Optional[int]] = []
        self.seen = 0

    @property
    def recording(self) -> bool:
        return self.stage in ("warm", "active")

    def start(self) -> None:
        from torch.profiler import (ProfilerActivity, profile,
                                    schedule)
        self.prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
        self.prof.start()
        self.stage = "warm"

    def span(self):
        from torch.profiler import record_function
        return record_function(SPAN)

    def after(self, chunk: int, emitted: bool,
              interval: Optional[int] = None) -> None:
        """Bookkeeping after the iteration that pushed ``chunk``."""
        if self.stage == "active":
            self.kinds.append("emission" if emitted else "ingest")
            self.chunks.append(chunk)
            self.intervals.append(interval)
        if not emitted:
            return
        if self.stage == "warm":
            self.prof.step()
            self.stage = "active"
        elif self.stage == "active":
            self.seen += 1
            if self.seen == self.periods:
                self.prof.step()
                self.prof.stop()
                self.stage = "done"

    def summarize(self) -> "TraceData":
        if self.stage != "done":
            raise RuntimeError(
                f"the window ended before {self.periods} traced emission "
                f"periods (stage {self.stage}, {self.seen} seen)")
        return TraceData.from_events(raw_events(self.prof), self.kinds,
                                     self.chunks, self.intervals)


@dataclasses.dataclass
class Event:
    """One profiler event: on the host (``cpu``) or on the card, its
    times in microseconds, its correlation id and the id of the host op
    it is linked to (0 for none)."""
    name: str
    cpu: bool
    start: float
    end: float
    corr: int
    linked: int
    thread: int


def raw_events(prof) -> List[Event]:
    """The last profiled cycle's raw events (the kineto results, which
    keep the launch links on every torch release this runs on)."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        out.append(Event(name=e.name(),
                         cpu=e.device_type() == DeviceType.CPU,
                         start=start, end=start + e.duration_ns() / 1e3,
                         corr=e.correlation_id(),
                         linked=e.linked_correlation_id(),
                         thread=e.start_thread_id()))
    return out


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _clip_total(union: list, lo: float, hi: float) -> float:
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in union)


def short_name(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    if "Memset" in name or "Memcpy" in name:
        return name.split("(")[0]
    return name.split("(")[0][:160]


@dataclasses.dataclass
class TraceData:
    iterations: List[Iteration]
    window_us: float
    busy_us: float
    union: list
    device_ops: list           # [(name, seconds)] most time first
    idle_gaps: list            # [(host activity, seconds)] longest first
    unattributed: int          # device activities with no iteration
    fold: Dict[int, object] = dataclasses.field(default_factory=dict)
    views: Dict[int, dict] = dataclasses.field(default_factory=dict)
    cell: Optional[object] = None

    @classmethod
    def from_events(cls, events, kinds: list, chunks: list,
                    intervals: list) -> "TraceData":
        """From the profiler's raw events (:func:`raw_events`)."""
        cpu = [e for e in events if e.cpu]
        dev = [e for e in events if not e.cpu and e.name != SPAN
               and not e.name.startswith("ProfilerStep")]
        spans = sorted((e for e in cpu if e.name == SPAN),
                       key=lambda e: e.start)
        if len(spans) != len(kinds):
            raise RuntimeError(f"{len(spans)} traced spans for "
                               f"{len(kinds)} traced iterations")
        its = [Iteration(k, c, s.start, s.end, i)
               for k, c, i, s in zip(kinds, chunks, intervals, spans)]
        starts = [it.start_us for it in its]
        # Where each activity was launched: the runtime call that shares
        # its correlation id (a launch, copy or memset); else the host op
        # it is linked to, a host op with no link of its own.
        runtime = {e.corr: e for e in cpu if e.name.startswith("cu")}
        by_id = {e.corr: e for e in cpu if e.linked == 0
                 and not e.name.startswith("cu")}
        unattributed = 0
        for d in dev:
            host = runtime.get(d.corr) or by_id.get(d.linked)
            at = host.start if host is not None else None
            i = -1 if at is None else bisect.bisect_right(starts, at) - 1
            if i < 0 or at > its[i].end_us:
                unattributed += 1
                continue
            its[i].events.append((short_name(d.name), d.start,
                                  d.end - d.start))
        lo, hi = its[0].start_us, its[-1].end_us
        union = _union([(s, s + u) for it in its for _, s, u in it.events])
        busy = _clip_total(union, lo, hi)
        ops = defaultdict(float)
        for it in its:
            for name, _, u in it.events:
                ops[name] += u / 1e6
        gaps = _idle_gaps(union, lo, hi, its, cpu)
        return cls(iterations=its, window_us=hi - lo, busy_us=busy,
                   union=union,
                   device_ops=sorted(ops.items(), key=lambda x: -x[1])[:10],
                   idle_gaps=gaps, unattributed=unattributed)

    def select(self, kind: Optional[str] = None) -> List[Iteration]:
        return [it for it in self.iterations
                if kind is None or it.kind == kind]

    @staticmethod
    def device_us(its: List[Iteration], patterns=None) -> float:
        return sum(u for it in its for name, _, u in it.events
                   if patterns is None or any(p in name for p in patterns))

    @staticmethod
    def launches(its: List[Iteration], patterns=None) -> int:
        return sum(1 for it in its for name, _, _ in it.events
                   if patterns is None or any(p in name for p in patterns))

    def busy_in(self, its: List[Iteration]) -> tuple:
        """Device-busy and wall microseconds over the iterations' spans."""
        busy = sum(_clip_total(self.union, it.start_us, it.end_us)
                   for it in its)
        return busy, sum(it.end_us - it.start_us for it in its)


def _idle_gaps(union: list, lo: float, hi: float, its: List[Iteration],
               cpu: list) -> list:
    """Idle time on the card by what the host was doing when each gap
    began: the innermost host op on the loop's thread, or "python"."""
    thread = None
    for e in cpu:
        if e.name == SPAN:
            thread = e.thread
            break
    host = sorted((e for e in cpu if e.thread == thread and e.name != SPAN
                   and not e.name.startswith("ProfilerStep")),
                  key=lambda e: (e.start, -e.end))
    gaps = []
    prev = lo
    for s, e in union:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    starts = [it.start_us for it in its]
    out = defaultdict(float)
    stack: list = []
    j = 0
    for g0, g1 in gaps:
        while j < len(host) and host[j].start <= g0:
            while stack and stack[-1].end <= host[j].start:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1].end <= g0:
            stack.pop()
        i = bisect.bisect_right(starts, g0) - 1
        kind = its[i].kind if i >= 0 and g0 <= its[i].end_us else "loop"
        what = short_name(stack[-1].name) if stack else "python"
        out[f"{kind}: {what}"] += (g1 - g0) / 1e6
    return sorted(out.items(), key=lambda x: -x[1])[:10]
