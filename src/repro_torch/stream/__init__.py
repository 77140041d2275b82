"""Stream substrate: sources, aggregator (Kafka analog), replay, pipeline."""
from repro_torch.stream import aggregator, pipeline, replay, sources
from repro_torch.stream.aggregator import StreamAggregator
from repro_torch.stream.replay import MeteredStream, ReplayableStream
from repro_torch.stream.sources import (GaussianSource, NetflowSource,
                                        PoissonSource, StreamChunk,
                                        TaxiSource, skewed)

__all__ = [
    "aggregator", "pipeline", "replay", "sources", "StreamAggregator",
    "MeteredStream", "ReplayableStream", "GaussianSource",
    "NetflowSource", "PoissonSource", "StreamChunk", "TaxiSource", "skewed",
]
