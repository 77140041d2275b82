"""Replay tools: offset-addressable deterministic streams and the §6.1
throughput method.

Counterpart of the reference's ``stream/replay.py``.

**Deterministic replay** (:class:`ReplayableStream`) is the source-rewind
half of exactly-once recovery: every chunk is a pure function of its
integer offset — payloads from the aggregator's counter-based PRNG, event
times from the offset's place on the arrival ramp, and bounded disorder
from a key folded with the offset. Two streams built with the same
parameters give the same chunks bit for bit at every offset (ids, times
and masks the reference's too), so replaying a suffix after a restore
regenerates what the uninterrupted run saw.

**Throughput replay** (:func:`measure_window_program`,
:func:`saturation_search`, paper §6.1 "Methodology") feeds a window
program at growing arrival rates until it saturates and reports the peak
sustainable rate. The clock stops after the card has finished: every
CUDA tensor in a window's result synchronises its device first.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, List

import torch

from repro_torch import prng
from repro_torch.runtime import records as rec
from repro_torch.stream.aggregator import StreamAggregator


@dataclasses.dataclass(frozen=True)
class ReplayableStream:
    """Offset-addressable timestamped stream (the recovery source).

    ``chunk_at(e)`` depends only on the constructor's parameters and the
    offset ``e``. ``chunk_size`` is items per chunk (per shard when
    ``num_shards > 1``); ``rate`` is items per event-time unit, so chunk
    ``e`` covers ``[e·span, (e+1)·span)`` with ``span = chunk_size /
    rate``. ``disorder > 0`` shifts event times back by up to ``disorder``
    units, keyed by the absolute offset. ``key_gaps`` holds tuples
    ``(key_id, active_span, silent_span)``: each named key emits in bursts
    (``records.silence_key``), applied after the disorder.
    """
    aggregator: StreamAggregator
    chunk_size: int            # items per chunk (per shard when sharded)
    rate: float                # items per event-time unit
    num_shards: int = 1
    disorder: float = 0.0      # max backward event-time displacement
    disorder_seed: int = 0
    key_gaps: tuple = ()

    def __post_init__(self):
        # The disorder key, made once on the aggregator's device.
        object.__setattr__(self, "_disorder_key", prng.PRNGKey(
            self.disorder_seed, device=self.aggregator.device))

    @property
    def span(self) -> float:
        """Event time covered by one chunk."""
        return self.chunk_size / self.rate

    def chunk_at(self, offset: int) -> rec.TimestampedChunk:
        """The chunk at stream position ``offset`` (pure function)."""
        t0 = offset * self.span
        if self.num_shards == 1:
            c = self.aggregator.interval_chunk(offset, self.chunk_size)
            c = rec.stamp(c.values, c.stratum_ids, t0, self.rate)
        else:
            c = self.aggregator.sharded_interval(offset, self.num_shards,
                                                 self.chunk_size)
            c = rec.stamp_sharded(c.values, c.stratum_ids, t0, self.rate)
        if self.disorder > 0.0:
            c = rec.perturb_event_times([c], self._disorder_key,
                                        self.disorder, offset=offset)[0]
        for key_id, active_span, silent_span in self.key_gaps:
            c = rec.silence_key(c, key_id, active_span, silent_span)
        return c

    def range(self, start: int, stop: int) -> Iterator[rec.TimestampedChunk]:
        """Chunks ``start .. stop-1``: the replay suffix after a restore
        is ``range(payload offset, num_chunks)``."""
        for e in range(start, stop):
            yield self.chunk_at(e)

    def prefix(self, num_chunks: int) -> List[rec.TimestampedChunk]:
        """The first ``num_chunks`` chunks (an uninterrupted run's input)."""
        return list(self.range(0, num_chunks))


class MeteredStream:
    """Iterator wrapper that meters a chunk stream: chunks, masked items
    and the event-time span they cover.

    The chunk count is kept on the host; the item count and the masked
    times' minimum and maximum are kept on the chunks' device and read
    only by :meth:`summary`, :attr:`items`, :attr:`min_time`,
    :attr:`max_time` or :attr:`event_span`. Wrapping a pipelined
    executor's input thus adds no device-to-host read on the way (the
    reference reads each chunk's buffers on the host, which on the card
    would wait for every earlier push).
    """

    def __init__(self, chunks):
        self._chunks = chunks
        self.chunks = 0
        self._items = None
        self._lo = None
        self._hi = None

    def __iter__(self):
        for c in self._chunks:
            m = c.mask
            t = c.times.to(torch.float32)
            n = m.sum(dtype=torch.int64)
            lo = torch.where(m, t, float("inf")).min()
            hi = torch.where(m, t, float("-inf")).max()
            if self._items is None:
                self._items, self._lo, self._hi = n, lo, hi
            else:
                self._items = self._items + n
                self._lo = torch.minimum(self._lo, lo)
                self._hi = torch.maximum(self._hi, hi)
            self.chunks += 1
            yield c

    @property
    def items(self) -> int:
        return 0 if self._items is None else int(self._items)

    @property
    def min_time(self) -> float:
        return float("inf") if self._lo is None else float(self._lo)

    @property
    def max_time(self) -> float:
        return float("-inf") if self._hi is None else float(self._hi)

    @property
    def event_span(self) -> float:
        """Event time covered by the metered traffic so far."""
        lo, hi = self.min_time, self.max_time
        if self.chunks == 0 or lo > hi:
            return 0.0
        return hi - lo

    def summary(self) -> dict:
        return {"chunks": self.chunks, "items": self.items,
                "event_span": self.event_span}


@dataclasses.dataclass
class ReplayResult:
    items_per_sec: float
    seconds_per_window: float
    windows: int


def block_until_ready(tree) -> None:
    """Wait for the devices of every CUDA tensor in ``tree`` (tensors,
    dataclasses, dicts, lists and tuples of them)."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(tree)
    for dev in devices:
        torch.cuda.synchronize(dev)


def measure_window_program(
    run_window: Callable[[int], object],
    items_per_window: int,
    warmup: int = 2,
    windows: int = 10,
) -> ReplayResult:
    """Time a per-window program end to end. ``run_window(epoch)`` must
    consume exactly ``items_per_window`` records and return its result's
    tensors, which are waited for before the clock stops."""
    for e in range(warmup):
        block_until_ready(run_window(e))
    t0 = time.perf_counter()
    for e in range(warmup, warmup + windows):
        block_until_ready(run_window(e))
    dt = time.perf_counter() - t0
    return ReplayResult(
        items_per_sec=items_per_window * windows / dt,
        seconds_per_window=dt / windows,
        windows=windows,
    )


def saturation_search(
    make_runner: Callable[[int], Callable[[int], object]],
    start_items: int = 2_000,
    growth: float = 2.0,
    max_items: int = 4_000_000,
    latency_slo_sec: float = 1.0,
) -> ReplayResult:
    """The paper's method: grow the offered rate until the per-window
    latency exceeds the SLO; report the last sustainable rate."""
    best = None
    items = start_items
    while items <= max_items:
        runner = make_runner(items)
        res = measure_window_program(runner, items, warmup=1, windows=3)
        if res.seconds_per_window > latency_slo_sec:
            break
        best = res
        items = int(items * growth)
    if best is None:
        best = measure_window_program(make_runner(start_items), start_items,
                                      warmup=1, windows=3)
    return best
