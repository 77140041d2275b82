"""The paper's own workload config: approximate stream analytics.

Not an LM arch — this configures the §5/§6 evaluation pipelines
(micro-benchmarks and the two case studies) and the default OASRS knobs.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class StreamApproxConfig:
    num_strata: int = 3
    reservoir_capacity: int = 512        # N_i per stratum
    items_per_interval: int = 65536      # arrivals per slide interval
    window_intervals: int = 2            # w/δ (10s window, 5s slide)
    sampling_fraction: float = 0.6       # paper's headline setting
    confidence: float = 0.95
    target_half_width: float = 0.0       # 0 → throughput budget mode
    num_shards: int = 4                  # distributed workers (paper: 4)
    pipelined_lane: int = 64             # Flink-mode vector lane


PAPER_MICROBENCH = StreamApproxConfig()
NETWORK_TRAFFIC = StreamApproxConfig(num_strata=3, items_per_interval=131072)
TAXI_RIDES = StreamApproxConfig(num_strata=6, items_per_interval=65536)
