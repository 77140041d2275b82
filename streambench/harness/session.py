"""One run of a cell up to its comparison: set-up, the window (traced
or not), and the program's state read and freed."""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import torch

from harness import check, program
from harness import stream as hstream
from harness import trace as htrace


@dataclasses.dataclass
class Measured:
    cell: object
    seed: int
    device: torch.device
    pool: object               # the pooled stream (reference.replay.Stream)
    run: hstream.RunRecord
    final: dict                # the program's state after the window
    setup_s: float
    memory_peak: int
    tracer: Optional[htrace.Tracer]


def measure(cell, seed: int, seconds: float, trace: bool, dev,
            started: float) -> Measured:
    """Set up from ``seed`` (``setup_s`` counted from ``started``), run
    the window, read the peak memory and the program's final state, and
    free the program."""
    pool = hstream.make_pool(cell, seed, dev)
    ex = program.executor(cell, seed, dev)
    driver = hstream.Driver(ex, pool, dev, checked=check.checked(
        seed, int(cell.mix["check_stride"])))
    driver.warm_up(cell.mix["emit_every"])
    setup_s = time.perf_counter() - started

    tracer = htrace.Tracer(cell.mix["traced_periods"]) if trace else None
    if tracer is None:
        driver.window(seconds)
    else:
        def on_step(emitted: bool) -> None:
            if tracer.recording:
                tracer.after(driver.run.chunks - 1, emitted,
                             driver.run.emissions[-1].interval if emitted
                             else None)

        tracer.start()
        driver.window(seconds, on_step=on_step, span=lambda: (
            tracer.span() if tracer.recording
            else contextlib.nullcontext()))
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    final = program.final_state(ex)
    run = driver.run
    del driver, ex
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return Measured(cell, seed, dev, pool, run, final, setup_s, peak,
                    tracer)

