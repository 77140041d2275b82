"""Event-time watermarks with bounded out-of-order arrival.

Counterpart of the reference's ``runtime/watermark.py``: the device
routing and the host mirror of the frontier. The frontier ``max_time``
gives the watermark ``max_time − allowed_lateness``; interval ``j``
covers ``[j·span, (j+1)·span)``; an item is on time (newest open
interval), late (older, above the watermark, still in the ring) or
dropped. The routing runs in f32 and int32 on the state's device, so it
never reads a value back to the host.

``export`` feeds the checkpoint manifest; ``from_export`` is kept for
parity with the reference's API only (only the tests call it).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: f32 −inf stand-in that survives f32 arithmetic (the reference's _NEG).
NEG_TIME = np.float32(-3.0e38)
_IMIN = -(2 ** 31) + 1


# ---------------------------------------------------------------------------
# The host mirror of the frontier (watermark-driven emission).
#
# The reference's numpy arithmetic, copied literally: the closes divide by
# the span (true division), as the reference's host decides them, even
# though the device routing multiplies by its reciprocal. Emitting on the
# reference's schedule is what parity needs.
# ---------------------------------------------------------------------------

def host_frontier(prev: np.ndarray, times, mask) -> np.ndarray:
    """Advance a host-side ``[W]`` frontier mirror with one chunk: the
    masked max of its times, in f32 (``route_chunk``'s frontier update)."""
    t = np.asarray(times, np.float32)
    m = np.asarray(mask, bool)
    if t.ndim == 1:
        t, m = t[None, :], m[None, :]
    chunk_max = np.max(np.where(m, t, NEG_TIME), axis=1).astype(np.float32)
    return np.maximum(prev, chunk_max)


def host_closed_through(frontier: np.ndarray, allowed_lateness: float,
                        span: float) -> int:
    """Newest event interval the watermark has CLOSED: interval ``j``
    closes when the watermark reaches ``(j+1)·span``. f32 throughout."""
    w = np.float32(np.min(frontier)) - np.float32(allowed_lateness)
    return int(np.floor(w / np.float32(span))) - 1


def staleness(watermark: float, interval: int, span: float) -> float:
    """How far the watermark had moved past ``interval``'s close
    ``(interval+1)·span`` when its answer surfaced (f32)."""
    close = np.float32((interval + 1) * span)
    return float(np.float32(watermark) - close)


def host_open_interval(frontier: np.ndarray, span: float) -> int:
    """Newest event interval seen, from the host frontier mirror."""
    return max(0, int(np.floor(np.float32(np.max(frontier))
                               / np.float32(span))))


@dataclasses.dataclass
class WatermarkState:
    """Frontier + arrival accounting (0-dim device tensors)."""
    max_time: torch.Tensor   # f32 — event-time frontier seen so far
    on_time: torch.Tensor    # i32 — items routed to the newest interval
    late: torch.Tensor       # i32 — items routed to an older live interval
    dropped: torch.Tensor    # i32 — items below watermark / evicted


def init(device, lead: tuple = ()) -> WatermarkState:
    """Fresh accounting; ``lead`` is the shard axis (``(W,)``) or none.
    One fresh buffer per field: the state is updated in place later."""
    def z():
        return torch.zeros(lead, dtype=torch.int32, device=device)
    return WatermarkState(
        max_time=torch.full(lead, float(NEG_TIME), dtype=torch.float32,
                            device=device),
        on_time=z(), late=z(), dropped=z())


def export(wm: WatermarkState) -> dict:
    """Plain-Python view of the frontier and counters (the checkpoint
    manifest): floats and ints, JSON-serializable. Reads the state back;
    call it where the host already synchronized."""
    return {f.name: getattr(wm, f.name).tolist()
            for f in dataclasses.fields(WatermarkState)}


def from_export(d: dict, device) -> WatermarkState:
    """A :class:`WatermarkState` on ``device`` from :func:`export`."""
    return WatermarkState(
        max_time=torch.tensor(d["max_time"], dtype=torch.float32,
                              device=device),
        **{f: torch.tensor(d[f], dtype=torch.int32, device=device)
           for f in ("on_time", "late", "dropped")})


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
    """Per-item routing decision for one chunk (each field with the
    state's leading shard axis, if any)."""
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
    A sharded state (``[W]`` scalars) routes a ``[W, M]`` chunk, row
    ``w`` against shard ``w``'s frontier: the scalars broadcast over
    the items, the maxima and counts are taken per row.
    """
    wmark = (wm.max_time - _f32(allowed_lateness))[..., None]
    tgt = interval_of(times, span)
    new_max = torch.maximum(
        wm.max_time,
        torch.amax(torch.where(mask, times, float(NEG_TIME)), dim=-1))
    new_open = torch.maximum(
        open_interval, torch.amax(torch.where(mask, tgt, _IMIN), dim=-1))
    oldest_live = (new_open - num_intervals + 1)[..., None]
    accept = mask & ~(times < wmark) & ~(tgt < oldest_live)
    before = open_interval[..., None]

    def count(m):
        return torch.sum(m, dim=-1, dtype=torch.int32)

    wm2 = WatermarkState(
        max_time=new_max,
        on_time=wm.on_time + count(accept & (tgt >= before)),
        late=wm.late + count(accept & (tgt < before)),
        dropped=wm.dropped + count(mask & ~accept))
    return Routing(target_interval=tgt, accept=accept,
                   open_interval=new_open, wm=wm2)
