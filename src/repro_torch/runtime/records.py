"""Event-time records for the streaming runtime.

Counterpart of the reference's ``runtime/records.py``: the runtime's
arrival unit, and the in-order stamp that gives a source chunk its
event times.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class TimestampedChunk:
    """One arrival unit: payloads, strata, event times, validity mask."""
    values: torch.Tensor        # [M] f32
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
