"""Straggler mitigation via approximation.

Counterpart of the reference's ``train/straggler.py``. Per-shard
reservoirs are independent and weights come from local counters, so a
shard that misses the window deadline is left out of the merge and the
survivors are Horvitz–Thompson re-inflated by ``w_total / w_alive``. The
estimate stays unbiased (round-robin aggregation makes shard loads
exchangeable); only its variance grows.

``WindowDeadline`` is the host-side policy object; the tensor helpers
apply the reweighting on the batch's device.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.utils import DeviceLike


@dataclasses.dataclass
class WindowDeadline:
    """Tracks per-shard arrival times against a window deadline."""
    num_shards: int
    deadline_sec: float
    grace: float = 0.0

    def __post_init__(self):
        self._start = time.monotonic()
        self._arrived = [False] * self.num_shards

    def start_window(self):
        self._start = time.monotonic()
        self._arrived = [False] * self.num_shards

    def mark_arrival(self, shard: int):
        self._arrived[shard] = True

    def expired(self) -> bool:
        return time.monotonic() - self._start > (
            self.deadline_sec + self.grace)

    def alive_mask(self, device: DeviceLike = "cpu") -> torch.Tensor:
        """0/1 per shard, f32; call when the deadline fires."""
        return torch.tensor(self._arrived, dtype=torch.float32,
                            device=device)


def reweight_for_stragglers(seq_weights: torch.Tensor,
                            shard_alive: torch.Tensor,
                            shard_of_seq: torch.Tensor) -> torch.Tensor:
    """Zero dead shards' sequences and HT-inflate the survivors.

    seq_weights: ``[B]`` OASRS weights; shard_of_seq: ``[B]`` producing
    shard id; shard_alive: ``[W]`` 0/1.
    """
    alive = shard_alive[shard_of_seq.long()]
    n_total = shard_alive.shape[0]
    n_alive = torch.clamp(torch.sum(shard_alive), min=1.0)
    return seq_weights * alive * (n_total / n_alive)


def drop_fraction_variance_penalty(drop_frac: torch.Tensor) -> torch.Tensor:
    """Multiplier on Var(estimate) from dropping a fraction of shards,
    ``1/(1-f)`` for exchangeable shards, logged so operators see the
    accuracy cost of each straggler event."""
    return 1.0 / torch.clamp(1.0 - drop_frac, min=1e-3)
