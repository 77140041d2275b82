"""Stream aggregator — the Kafka analog of Figure 1.

Counterpart of the reference's ``stream/aggregator.py``: combines the
sub-streams into one interleaved stream and partitions it round-robin
across data shards. The chunk of ``(epoch, shard)`` depends only on the
seed (``fold_in(PRNGKey(seed), epoch)``, then ``fold_in`` of the shard),
so re-emitting any window after a failure is exact replay — and the
chunks are the reference's, ids bit for bit.

The keys and the draws live on the aggregator's device: ``device=None``
means the card (and raises without one), ``device="cpu"`` runs on the
CPU on purpose.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import prng
from repro_torch.stream.sources import Source, StreamChunk
from repro_torch.utils import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class StreamAggregator:
    source: Source
    seed: int = 0
    device: DeviceLike = None

    def __post_init__(self):
        dev = resolve_device(self.device)
        object.__setattr__(self, "device", dev)
        # Made once: a key copied from the host per chunk would wait for
        # the card's stream.
        object.__setattr__(self, "_key", prng.PRNGKey(self.seed, device=dev))

    def epoch_key(self, epoch: int) -> torch.Tensor:
        return prng.fold_in(self._key, epoch)

    def interval_chunk(self, epoch: int, size: int) -> StreamChunk:
        """All records arriving in interval ``epoch``."""
        return self.source.chunk(self.epoch_key(epoch), size)

    def shard_chunk(self, epoch: int, shard: int, num_shards: int,
                    size_per_shard: int) -> StreamChunk:
        """Round-robin partition of the interval for one data shard."""
        key = prng.fold_in(self.epoch_key(epoch), shard)
        return self.source.chunk(key, size_per_shard)

    def sharded_interval(self, epoch: int, num_shards: int,
                         size_per_shard: int) -> StreamChunk:
        """Stacked per-shard chunks, leaves ``[W, size_per_shard]``: one
        ``[W, 2]`` key stack and one batched draw (the rows are
        :meth:`shard_chunk`'s)."""
        keys = prng.fold_in(
            self.epoch_key(epoch),
            torch.arange(num_shards, dtype=torch.int64, device=self.device))
        return self.source.chunk(keys, size_per_shard)
