"""The plain reference of the pipelined stream path: the same chunks,
routed, counted and sampled as the paper's Algorithm 1 says, one chunk
after another, in plain torch.

Semantics (paper §3, and the event-time rules the system documents):

* Chunk ``n`` is pool chunk ``n mod P`` with event times ``base + t0``,
  ``t0 = start + n · chunk_span`` (one f32 add).
* Interval ``j`` covers ``[j·span, (j+1)·span)``; an item's interval is
  ``floor(t · f32(1/span))``. The ring holds the ``K`` newest intervals,
  interval ``j`` in slot ``j mod K``.
* An item is judged against the watermark before its chunk (the
  frontier, the largest event time seen, less the allowed lateness):
  below it, or older than the ring's oldest interval after the chunk's
  own frontier advance, it is dropped; otherwise accepted, and late if
  its interval is older than the newest interval seen before the chunk.
* A slot whose interval changes is emptied and starts again at the
  configured capacity.
* Each accepted item is the ``c``-th arrival of its (slot, stratum)
  cell, ``c`` counted in arrival order. It fills slot ``c - 1`` while
  ``c <= N``; past that it is kept when ``u_a · c < N`` (f32), at slot
  ``floor(u_s · N)``, and the latest kept item wins each slot.
* The two uniforms of chunk ``n`` come from the ring's lead key: split
  in three, child 1 gives ``u_a``, child 2 ``u_s``, child 0 is the next
  lead key. The lead key of chunk 0 is child 0 of the executor key split
  in ``K``.

Counters are plain Python integers (no width); the caller compares
them with the program's in the program's stated width.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from reference import threefry

NEG_TIME = float(np.float32(-3.0e38))


@dataclasses.dataclass
class Layout:
    """What the deployment fixes."""
    num_strata: int
    num_intervals: int
    interval_span: float
    allowed_lateness: float
    capacity: int
    seed: int


@dataclasses.dataclass
class Stream:
    """The pooled chunks and their place in time (shared with the
    program, which is handed the same tensors)."""
    values: torch.Tensor      # [P, M] f32
    sids: torch.Tensor        # [P, M] int32
    base_times: torch.Tensor  # [P, M] f32
    start_s: float
    chunk_span: float

    @property
    def chunk_items(self) -> int:
        return self.values.shape[1]

    def t0(self, n: int) -> float:
        return float(np.float32(self.start_s + n * self.chunk_span))

    def times(self, n: int) -> torch.Tensor:
        return self.base_times[n % self.values.shape[0]] + self.t0(n)

    def chunk(self, n: int):
        p = n % self.values.shape[0]
        return self.values[p], self.sids[p], self.times(n)


@dataclasses.dataclass
class ChunkRecord:
    """The routing state after one chunk."""
    max_time: float
    open_interval: int
    slots: tuple            # the interval each slot holds
    counts: np.ndarray      # [K, S] arrivals per cell
    resets: int             # slots emptied by this chunk
    on_time: int            # running watermark totals
    late: int
    dropped: int


@dataclasses.dataclass
class Routing:
    """One chunk's verdicts."""
    target: torch.Tensor    # [M] int interval
    accept: torch.Tensor    # [M] bool
    late: torch.Tensor      # [M] bool
    max_time: float
    open_interval: int


def route(layout: Layout, times: torch.Tensor, max_time: float,
          open_interval: int) -> Routing:
    """Judge one chunk against the state before it."""
    f32 = np.float32
    recip = float(f32(1.0) / f32(layout.interval_span))
    wmark = float(f32(max_time) - f32(layout.allowed_lateness))
    target = torch.floor(times * recip).to(torch.int64)
    new_max = max(max_time, float(times.max()))
    new_open = max(open_interval, int(target.max()))
    oldest = new_open - layout.num_intervals + 1
    accept = ~(times < wmark) & (target >= oldest)
    return Routing(target=target, accept=accept,
                   late=accept & (target < open_interval),
                   max_time=new_max, open_interval=new_open)


def held_intervals(layout: Layout, open_interval: int) -> tuple:
    """The interval each slot holds once ``open_interval`` is the
    newest: the newest ``j <= open_interval`` with ``j mod K == slot``."""
    k = layout.num_intervals
    return tuple(open_interval - ((open_interval - s) % k)
                 for s in range(k))


def initial_slots(layout: Layout) -> tuple:
    """Before any chunk slot ``s`` holds interval ``s - K`` (slot 0
    interval 0): the system's starting table."""
    k = layout.num_intervals
    return tuple(0 if s == 0 else s - k for s in range(k))


class Counters:
    """Per-stratum totals and watermark totals over routed chunks."""

    def __init__(self, s: int):
        self.ingested = np.zeros(s, np.int64)
        self.accepted = np.zeros(s, np.int64)
        self.late = np.zeros(s, np.int64)
        self.dropped = np.zeros(s, np.int64)

    def add(self, sids: torch.Tensor, r: Routing) -> None:
        s = self.ingested.shape[0]
        cat = torch.where(r.accept, torch.where(r.late, 2, 1), 3)
        per = torch.bincount(sids.to(torch.int64) * 4 + cat,
                             minlength=4 * s).view(s, 4).cpu().numpy()
        self.ingested += per[:, 1:].sum(axis=1)
        self.accepted += per[:, 1] + per[:, 2]
        self.late += per[:, 2]
        self.dropped += per[:, 3]


def route_all(layout: Layout, stream: Stream, n_chunks: int):
    """Route chunks ``0 .. n_chunks-1``: the counters and one
    :class:`ChunkRecord` per chunk."""
    k, s = layout.num_intervals, layout.num_strata
    counters = Counters(s)
    max_time, open_iv = NEG_TIME, 0
    slots = initial_slots(layout)
    counts = np.zeros((k, s), np.int64)
    on_time = late = dropped = 0
    records: List[ChunkRecord] = []
    for n in range(n_chunks):
        _, sids, times = stream.chunk(n)
        r = route(layout, times, max_time, open_iv)
        counters.add(sids, r)
        held = held_intervals(layout, r.open_interval)
        resets = 0
        for slot in range(k):
            if held[slot] != slots[slot]:
                counts[slot] = 0
                resets += 1
        cell = (torch.remainder(r.target, k) * s + sids.to(torch.int64))
        counts += torch.bincount(cell[r.accept], minlength=k * s).view(
            k, s).cpu().numpy()
        n_acc = int(r.accept.sum())
        n_late = int(r.late.sum())
        on_time += n_acc - n_late
        late += n_late
        dropped += times.numel() - n_acc
        max_time, open_iv, slots = r.max_time, r.open_interval, held
        records.append(ChunkRecord(max_time, open_iv, held, counts.copy(),
                                   resets, on_time, late, dropped))
    return counters, records


def lead_keys(layout: Layout, n_chunks: int) -> list:
    """The ring's lead key before each chunk ``0 .. n_chunks``."""
    key = threefry.split_int(threefry.key_of_seed(layout.seed),
                             layout.num_intervals)[0]
    out = [key]
    for _ in range(n_chunks):
        key = threefry.split_int(key, 3)[0]
        out.append(key)
    return out


@dataclasses.dataclass
class FoldStats:
    """What one chunk's fold needs, counted."""
    items: int       # items in the chunk
    live: int        # items routed into a cell
    fill: int        # of those, arrivals within capacity
    accepted: int    # items kept (fill or replacement)
    won: int         # distinct slots written
    resets: int      # slots emptied by the chunk


def fold_chunk(layout: Layout, values: torch.Tensor, sids: torch.Tensor,
               r: Routing, counts: torch.Tensor, key: tuple,
               ring: Optional[torch.Tensor]) -> FoldStats:
    """Sample one routed chunk into ``ring [K·S, N]`` (skipped when
    ``None``); ``counts [K·S]`` int64 (after slot resets) are advanced
    in place."""
    k, s, cap = layout.num_intervals, layout.num_strata, layout.capacity
    dev = values.device
    m = values.shape[0]
    children = threefry.split_int(key, 3)
    u_accept = threefry.uniforms(children[1], m, dev)
    u_slot = threefry.uniforms(children[2], m, dev)
    g = k * s
    cell = torch.remainder(r.target, k) * s + sids.to(torch.int64)
    cell = torch.where(r.accept, cell, g)
    rank = torch.zeros(m, dtype=torch.int64, device=dev)
    for c in range(g):
        hit = cell == c
        rank = torch.where(hit, torch.cumsum(hit, 0) - 1, rank)
    arrival = counts[torch.clamp(cell, max=g - 1)] + rank + 1
    filling = arrival <= cap
    capf = float(np.float32(cap))
    keep = r.accept & (filling | (u_accept * arrival.to(torch.float32)
                                  < capf))
    rand_slot = torch.clamp(torch.floor(u_slot * capf).to(torch.int64),
                            0, cap - 1)
    slot = torch.where(filling, arrival - 1, rand_slot)
    flat = torch.where(keep, cell * cap + slot, g * cap)
    order = torch.arange(m, dtype=torch.int32, device=dev)
    winner = torch.full((g * cap + 1,), -1, dtype=torch.int32, device=dev)
    winner.scatter_reduce_(0, flat, order, reduce="amax")
    winner = winner[:g * cap]
    won = winner >= 0
    if ring is not None:
        flat_ring = ring.view(-1)
        idx = torch.nonzero(won).squeeze(1)
        flat_ring[idx] = values[winner[idx].to(torch.int64)]
    counts += torch.bincount(cell[r.accept], minlength=g)[:g]
    return FoldStats(items=m, live=int(r.accept.sum()),
                     fill=int((r.accept & filling).sum()),
                     accepted=int(keep.sum()), won=int(won.sum()),
                     resets=0)


def state_before(layout: Layout, records: List[ChunkRecord], n: int):
    """``(max_time, open_interval, slots, counts [K, S])`` before chunk
    ``n``."""
    if n == 0:
        return (NEG_TIME, 0, initial_slots(layout),
                np.zeros((layout.num_intervals, layout.num_strata),
                         np.int64))
    rec = records[n - 1]
    return rec.max_time, rec.open_interval, rec.slots, rec.counts


def replay(layout: Layout, stream: Stream, records: List[ChunkRecord],
           keys: list, first: int, last: int, want_ring: bool):
    """Re-run chunks ``first .. last`` from the routing state before
    ``first``: the ring after ``last`` (``[K, S, N]``; only slots
    emptied inside the range hold their true sample, so start at or
    before the chunk that opened the oldest slot wanted) and each
    chunk's :class:`FoldStats`."""
    k, s, cap = layout.num_intervals, layout.num_strata, layout.capacity
    dev = stream.values.device
    max_time, open_iv, slots, counts = state_before(layout, records, first)
    counts = torch.as_tensor(counts.reshape(-1), device=dev).clone()
    ring = (torch.zeros((k * s, cap), dtype=torch.float32, device=dev)
            if want_ring else None)
    stats = []
    for n in range(first, last + 1):
        values, sids, times = stream.chunk(n)
        r = route(layout, times, max_time, open_iv)
        held = held_intervals(layout, r.open_interval)
        resets = 0
        for slot in range(k):
            if held[slot] != slots[slot]:
                counts[slot * s:(slot + 1) * s] = 0
                if ring is not None:
                    ring[slot * s:(slot + 1) * s] = 0.0
                resets += 1
        st = fold_chunk(layout, values, sids, r, counts, keys[n], ring)
        st.resets = resets
        stats.append(st)
        max_time, open_iv, slots = r.max_time, r.open_interval, held
    if not np.array_equal(counts.view(k, s).cpu().numpy(),
                          records[last].counts):
        raise RuntimeError("replayed cell counts differ from the routing "
                           "pass's: the replay started too late")
    return (None if ring is None else ring.view(k, s, cap)), stats


def opening_chunk(records: List[ChunkRecord], n: int, slot: int) -> int:
    """The chunk that put its interval into ``slot`` as of chunk ``n``
    (0 when it held it from the start)."""
    want = records[n].slots[slot]
    c = n
    while c > 0 and records[c - 1].slots[slot] == want:
        c -= 1
    return c
