"""Adaptive execution: query budget → sample size, paper §2.3/§4.2/§7.

Counterpart of the reference's ``core/adaptive.py``: the accuracy budget
one Neyman-allocation feedback step, and the throughput budget's
uniform capacities.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import error as err
from repro_torch.utils import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class BudgetConfig:
    """Static accuracy budget (plain numbers; made f32 where used)."""
    target_half_width: float
    z: float
    min_per_stratum: int
    max_per_stratum: int


def accuracy_budget(target_half_width: float, confidence: float = 0.95,
                    min_per_stratum: int = 8,
                    max_per_stratum: int = 4096) -> BudgetConfig:
    return BudgetConfig(target_half_width=float(target_half_width),
                        z=err.Z_FOR_CONFIDENCE[confidence],
                        min_per_stratum=int(min_per_stratum),
                        max_per_stratum=int(max_per_stratum))


def throughput_budget_capacity(
        items_per_interval: float, sampling_fraction: float, num_strata: int,
        min_per_stratum: int = 8, device: DeviceLike = None) -> torch.Tensor:
    """Throughput budget: the fraction of the arriving window we can
    afford, as uniform per-stratum capacities ``[S]`` int32 (the
    reference's ``throughput_budget_capacity``; each item costs one token,
    the budget buys ``fraction × arrivals``). On the card unless
    ``device`` says otherwise."""
    total = int(items_per_interval * sampling_fraction)
    per = max(total // max(num_strata, 1), min_per_stratum)
    return torch.full((num_strata,), per, dtype=torch.int32,
                      device=resolve_device(device))


def next_capacity(budget: BudgetConfig, stats: err.StratumStats,
                  realized: Optional[err.Estimate] = None) -> torch.Tensor:
    """One feedback step: per-stratum capacities for the NEXT window.

    Neyman allocation from the last window's ``(C_i, s_i²)``; if the
    realized bound still exceeded the target, grow by the squared
    violation ratio (variance ∝ 1/N), at most 8x.
    """
    dev = stats.counts.device
    target = torch.tensor(budget.target_half_width, dtype=torch.float32,
                          device=dev)
    z = torch.tensor(budget.z, dtype=torch.float32, device=dev)
    alloc = err.required_sample_size_mean(stats.counts, stats.s2(), target,
                                          z, min_per_stratum=1)
    if realized is not None:
        bound = z * torch.sqrt(torch.clamp(realized.variance, min=0.0))
        ratio = bound / torch.clamp(target, min=1e-20)
        scale = torch.clamp(ratio * ratio, 1.0, 8.0)
        grow = torch.ceil(alloc.to(torch.float32) * scale).to(torch.int32)
        alloc = torch.where(bound > target, grow, alloc)
    alloc = torch.clamp(alloc, min=budget.min_per_stratum)
    return torch.clamp(alloc, max=budget.max_per_stratum)
