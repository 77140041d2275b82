"""Event-time watermarks with bounded out-of-order arrival.

Counterpart of the reference's ``runtime/watermark.py`` (device side).
The frontier ``max_time`` gives the watermark ``max_time −
allowed_lateness``; interval ``j`` covers ``[j·span, (j+1)·span)``; an
item is on time (newest open interval), late (older, above the
watermark, still in the ring) or dropped. All in f32 and int32 on the
state's device, so routing never reads a value back to the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: f32 −inf stand-in that survives f32 arithmetic (the reference's _NEG).
NEG_TIME = np.float32(-3.0e38)
_IMIN = -(2 ** 31) + 1


@dataclasses.dataclass
class WatermarkState:
    """Frontier + arrival accounting (0-dim device tensors)."""
    max_time: torch.Tensor   # f32 — event-time frontier seen so far
    on_time: torch.Tensor    # i32 — items routed to the newest interval
    late: torch.Tensor       # i32 — items routed to an older live interval
    dropped: torch.Tensor    # i32 — items below watermark / evicted


def init(device) -> WatermarkState:
    # One fresh buffer per field: the state is updated in place later.
    def z():
        return torch.zeros((), dtype=torch.int32, device=device)
    return WatermarkState(
        max_time=torch.full((), float(NEG_TIME), dtype=torch.float32,
                            device=device),
        on_time=z(), late=z(), dropped=z())


def _f32(x: float) -> float:
    """``x`` rounded to f32, as a Python float.

    Scalars enter the device ops as Python numbers, which torch casts to
    the tensor's f32 exactly (the value already is one), so the
    arithmetic is the reference's f32; a device tensor made from a Python
    number would instead cost a blocking host-to-device copy per chunk.
    """
    return float(np.float32(x))


def watermark(wm: WatermarkState, allowed_lateness: float) -> torch.Tensor:
    """Current watermark; ``-inf``-ish before any item arrived."""
    return wm.max_time - _f32(allowed_lateness)


def interval_of(times: torch.Tensor, span: float) -> torch.Tensor:
    """Event-time interval ``floor(t / span)`` per item, int32.

    Taken as ``t * f32(1/span)``: the reference's compiled step divides
    by the constant span, which XLA rewrites into a multiplication by
    its f32 reciprocal, and the two differ in the last bit for some
    ``t`` (enough to move an item across an interval boundary).
    """
    recip = _f32(np.float32(1.0) / np.float32(span))
    return torch.floor(times * recip).to(torch.int32)


@dataclasses.dataclass
class Routing:
    """Per-item routing decision for one chunk."""
    target_interval: torch.Tensor   # [M] i32 — owning event-time interval
    accept: torch.Tensor            # [M] bool — survives watermark + ring
    open_interval: torch.Tensor     # () i32 — newest interval after chunk
    wm: WatermarkState              # updated accounting


def route_chunk(wm: WatermarkState, open_interval: torch.Tensor,
                times: torch.Tensor, mask: torch.Tensor, span: float,
                allowed_lateness: float, num_intervals: int) -> Routing:
    """Advance the frontier and route one chunk's items.

    Items are judged against the PRE-chunk watermark (the chunk is the
    arrival unit); eviction is judged after the chunk's own frontier
    advance: the ring holds the ``num_intervals`` newest intervals.
    """
    wmark = wm.max_time - _f32(allowed_lateness)
    tgt = interval_of(times, span)
    new_max = torch.maximum(
        wm.max_time, torch.max(torch.where(mask, times, float(NEG_TIME))))
    new_open = torch.maximum(open_interval,
                             torch.max(torch.where(mask, tgt, _IMIN)))
    oldest_live = new_open - num_intervals + 1
    accept = mask & ~(times < wmark) & ~(tgt < oldest_live)

    def count(m):
        return torch.sum(m, dtype=torch.int32)

    wm2 = WatermarkState(
        max_time=new_max,
        on_time=wm.on_time + count(accept & (tgt >= open_interval)),
        late=wm.late + count(accept & (tgt < open_interval)),
        dropped=wm.dropped + count(mask & ~accept))
    return Routing(target_interval=tgt, accept=accept,
                   open_interval=new_open, wm=wm2)
