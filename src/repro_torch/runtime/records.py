"""Event-time records for the streaming runtime.

Counterpart of the reference's ``runtime/records.py``: the runtime's
arrival unit, the in-order stamps that give a source chunk (one shard's
``[M]`` or ``W`` shards' ``[W, M]``) its event times, the adapter from an
aggregator to a timestamped stream, the periodic silence of one key, and
bounded out-of-order arrival — each bit for bit the reference's.

The reference's ``place_sharded`` (a ``NamedSharding`` over the stream
mesh) has no counterpart: on ``placement="mesh"`` every rank takes the
full ``[W, M]`` chunk and keeps its own row.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch import prng


@dataclasses.dataclass
class TimestampedChunk:
    """One arrival unit: payloads, strata, event times, validity mask."""
    values: torch.Tensor        # [M] f32 ([W, M] sharded)
    stratum_ids: torch.Tensor   # [M] i32
    times: torch.Tensor         # [M] f32 event time
    mask: torch.Tensor          # [M] bool


def stamp(values: torch.Tensor, stratum_ids: torch.Tensor, t0: float,
          rate: float) -> TimestampedChunk:
    """In-order event times: item ``j`` gets ``t0 + j / rate`` (f32)."""
    m = values.shape[0]
    dev = values.device
    # Python scalars, not device tensors: no host-to-device copy per chunk.
    times = (torch.arange(m, dtype=torch.float32, device=dev)
             / float(np.float32(rate)) + float(np.float32(t0)))
    return TimestampedChunk(values=values, stratum_ids=stratum_ids,
                            times=times,
                            mask=torch.ones(m, dtype=torch.bool, device=dev))


def stamp_sharded(values: torch.Tensor, stratum_ids: torch.Tensor,
                  t0: float, rate: float) -> TimestampedChunk:
    """Stamp a sharded chunk (``[W, M]`` leaves) with in-order times.

    All shards consume the same event-time range in parallel (an
    aggregator round-robins one interval's arrivals across the shards),
    so every shard row gets the same ``t0 + j / rate`` ramp.
    """
    w, m = values.shape
    dev = values.device
    times = (torch.arange(m, dtype=torch.float32, device=dev)
             / float(np.float32(rate)) + float(np.float32(t0)))
    return TimestampedChunk(values=values, stratum_ids=stratum_ids,
                            times=times.expand(w, m).contiguous(),
                            mask=torch.ones((w, m), dtype=torch.bool,
                                            device=dev))


def timestamped_stream(aggregator, chunk_size: int, num_chunks: int,
                       rate: float,
                       start_epoch: int = 0) -> Iterator[TimestampedChunk]:
    """Adapt a :class:`~repro_torch.stream.aggregator.StreamAggregator`
    into an in-order timestamped chunk stream: chunk ``e`` covers event
    times ``[e·chunk_size/rate, (e+1)·chunk_size/rate)``; replaying the
    same epochs gives the same chunks bit for bit."""
    span = chunk_size / rate
    for e in range(start_epoch, start_epoch + num_chunks):
        c = aggregator.interval_chunk(e, chunk_size)
        yield stamp(c.values, c.stratum_ids, e * span, rate)


def silence_key(chunk: TimestampedChunk, key_id: int, active_span: float,
                silent_span: float) -> TimestampedChunk:
    """Mask out one stratum key's items during periodic silent phases.

    The key emits for ``active_span`` event-time units, then is silent
    for ``silent_span``, repeating — the session-shaped workload. The
    silence is a pure function of each item's event time, so any replayed
    suffix shows the same pattern. ``[M]`` and ``[W, M]`` chunks.

    The phase is ``jnp.mod``'s: ``fmod`` (exact) with the sign fixed to
    the period's. (``torch.remainder`` computes ``a - b·floor(a/b)``,
    which can round differently.)
    """
    if active_span <= 0 or silent_span <= 0:
        raise ValueError(
            f"active_span and silent_span must be > 0, got "
            f"({active_span}, {silent_span})")
    period = float(np.float32(active_span + silent_span))
    rem = torch.fmod(chunk.times, period)
    phase = torch.where((rem < 0.0) & (rem != 0.0), rem + period, rem)
    silent = (phase >= float(np.float32(active_span))) & (
        chunk.stratum_ids == int(key_id))
    return dataclasses.replace(chunk, mask=chunk.mask & ~silent)


def perturb_event_times(chunks: Sequence[TimestampedChunk],
                        key: torch.Tensor, max_displacement: float,
                        offset: int = 0) -> list[TimestampedChunk]:
    """Bounded out-of-order arrival: each item's event time is shifted
    back by ``max_displacement · u``, ``u`` uniform in ``[0, 1)`` from
    ``fold_in(key, offset + i)`` for the ``i``-th chunk, and clamped at 0;
    the arrival order stays. ``offset`` is the absolute stream position
    of ``chunks[0]``, so perturbing a suffix gives the displacements of
    the full stream."""
    scale = float(np.float32(max_displacement))
    out = []
    for i, c in enumerate(chunks):
        k = prng.fold_in(key, offset + i)
        shift = scale * prng.uniform(k, tuple(c.times.shape))
        out.append(dataclasses.replace(
            c, times=torch.clamp(c.times - shift, min=0.0)))
    return out
