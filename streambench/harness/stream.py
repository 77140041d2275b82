"""The pooled stream and the closed loop that drives the program.

Set-up makes ``pool_chunks`` distinct chunks on the card from the seed
(at least one whole window of event time) and keeps them there. Chunk
``n`` of the stream is pool chunk ``n mod P`` whose event times are
re-stamped for its place by one device add. The loop is closed: it
pushes the next chunk as soon as ``push`` returns. After a push whose
emission is to be checked, the driver copies the sample on the card
(outside the emission's latency) for the comparison after the window.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from harness import program
from reference.replay import Stream


def make_pool(cell, seed: int, device) -> Stream:
    """The pool from ``seed``: values and stratum ids from the
    configuration's source, event times ``j / rate`` less the mix's
    disorder (a share of the items shifted back by ``U(0, max_shift)``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2 ** 63 - 1))
    p, m = int(cell.mix["pool_chunks"]), cell.chunk_items
    values, sids = cell.source().make(cell.config, (p, m), gen, device)
    ramp = (torch.arange(m, dtype=torch.float32, device=device)
            / float(np.float32(cell.rate)))
    base = ramp.expand(p, m)
    dis = cell.mix.get("disorder")
    if dis:
        late = torch.rand((p, m), generator=gen, device=device) < float(
            dis["share"])
        shift = torch.rand((p, m), generator=gen, device=device) * float(
            np.float32(dis["max_shift_s"]))
        base = base - torch.where(late, shift, 0.0)
    return Stream(values=values.contiguous(), sids=sids.contiguous(),
                  base_times=base.contiguous(),
                  start_s=float(cell.mix["start_s"]),
                  chunk_span=cell.chunk_span)


@dataclasses.dataclass
class EmissionRecord:
    chunk: int                 # stream index of the push that emitted
    interval: Optional[int]    # the closed interval (watermark emission)
    latency_s: float           # push call to answers held on the host
    answers: dict
    on_time: int
    late: int
    dropped: int
    in_window: bool
    sample: Optional[dict] = None   # the sample after the push, where
    #                                 the emission is checked


@dataclasses.dataclass
class RunRecord:
    chunks: int = 0            # chunks pushed in all (warm-up included)
    window_chunks: int = 0
    window_items: int = 0
    window_s: float = 0.0
    emissions: List[EmissionRecord] = dataclasses.field(
        default_factory=list)


class Driver:
    """Pushes stream chunks into an executor, one per :meth:`step`."""

    def __init__(self, ex, stream: Stream, device,
                 checked: Callable[[int], bool] = lambda n: False):
        self.ex = ex
        self.stream = stream
        self.mask = torch.ones(stream.chunk_items, dtype=torch.bool,
                               device=device)
        self.run = RunRecord()
        self.in_window = False
        self.checked = checked    # of a window emission's ordinal
        self.seen = 0             # window emissions so far

    def step(self) -> bool:
        """Push the next chunk; ``True`` when the push emitted."""
        n = self.run.chunks
        t_call = time.perf_counter()
        values, sids, times = self.stream.chunk(n)
        before = len(self.ex.emissions)
        self.ex.push(program.chunk(values, sids, times, self.mask))
        new = self.ex.emissions[before:]
        got = [program.answers(em) for em in new]
        latency = time.perf_counter() - t_call
        for em, ans in zip(new, got):
            self.run.emissions.append(EmissionRecord(
                chunk=n, interval=em.interval, latency_s=latency,
                answers=ans, on_time=em.on_time, late=em.late,
                dropped=em.dropped, in_window=self.in_window))
        self.run.chunks += 1
        return bool(new)

    def warm_up(self, emit_every: int) -> None:
        """Push until an emission has run and a whole period is done:
        every shape of the window has run once."""
        while not (self.step() and self.run.chunks >= emit_every):
            pass
        if self.stream.values.is_cuda:
            torch.cuda.synchronize()

    def window(self, seconds: float,
               on_step: Optional[Callable[[bool], None]] = None,
               span: Optional[Callable] = None) -> None:
        """Push for ``seconds`` of wall time; the window ends once the
        card has finished every chunk pushed. ``span()`` gives the
        context each iteration runs in, ``on_step(emitted)`` follows
        it."""
        self.in_window = True
        first = self.run.chunks
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            before = len(self.run.emissions)
            with (span() if span is not None else contextlib.nullcontext()):
                emitted = self.step()
            if on_step is not None:
                on_step(emitted)
            if emitted:
                self._keep(self.run.emissions[before:])
        if self.stream.values.is_cuda:
            torch.cuda.synchronize()
        self.run.window_s = time.perf_counter() - t0
        self.in_window = False
        self.run.window_chunks = self.run.chunks - first
        self.run.window_items = (self.run.window_chunks
                                 * self.stream.chunk_items)

    def _keep(self, new: list) -> None:
        picked = [e for i, e in enumerate(new)
                  if self.checked(self.seen + i)]
        self.seen += len(new)
        if picked:
            sample = program.snapshot(self.ex)
            for e in picked:
                e.sample = sample
