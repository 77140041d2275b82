"""Backpressure + adaptive sample-size controller, paper §2.3/§4.2.

Counterpart of the reference's ``runtime/controller.py``: at every
emission the measured step latency (EMA-smoothed) and the realized error
of the accuracy query retune the per-stratum capacity that newly opened
intervals adopt. All on the device; nothing is read back.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import adaptive
from repro_torch.core import error as err


@dataclasses.dataclass
class ControllerState:
    capacity: torch.Tensor       # [S] i32 — capacity new intervals adopt
    base_capacity: torch.Tensor  # [S] i32 — configured capacity
    latency_ema: torch.Tensor    # () f32 — smoothed step latency (s)
    pressure: torch.Tensor       # () f32 — latency_ema / latency budget


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Static controller targets (None disables that feedback path)."""
    budget: Optional[adaptive.BudgetConfig] = None
    latency_budget_s: Optional[float] = None
    ema: float = 0.5
    min_per_stratum: int = 8


def init(capacity: torch.Tensor) -> ControllerState:
    """Both capacity leaves are fresh copies, distinct from each other
    and from the caller's tensor."""
    cap = capacity.to(torch.int32).clone()
    z = torch.zeros((), dtype=torch.float32, device=cap.device)
    return ControllerState(capacity=cap, base_capacity=cap.clone(),
                           latency_ema=z, pressure=z.clone())


def update(ctrl: ControllerState, cfg: ControllerConfig,
           stats: err.StratumStats, realized: err.Estimate,
           latency_s: torch.Tensor, intervals: int = 1) -> ControllerState:
    """One feedback step at an emission boundary.

    ``stats`` are per-stratum ``[S]`` (window cells pooled per stratum);
    ``intervals`` turns the window-level Neyman allocation into the
    per-interval capacity.
    """
    lat = latency_s.to(torch.float32)
    ema = torch.where(ctrl.latency_ema > 0.0,
                      cfg.ema * lat + (1.0 - cfg.ema) * ctrl.latency_ema,
                      lat)
    if cfg.budget is not None:
        alloc = adaptive.next_capacity(cfg.budget, stats, realized)
        cap = -(-alloc // max(intervals, 1))          # ceil divide
    else:
        cap = ctrl.base_capacity
    if cfg.latency_budget_s is not None:
        pressure = ema / torch.tensor(cfg.latency_budget_s,
                                      dtype=torch.float32, device=lat.device)
        relief = torch.clamp(1.0 / torch.clamp(pressure, min=1.0),
                             0.125, 1.0)
        cap = torch.ceil(cap.to(torch.float32) * relief).to(torch.int32)
    else:
        pressure = torch.zeros((), dtype=torch.float32, device=lat.device)
    cap = torch.clamp(cap, min=cfg.min_per_stratum)
    if cfg.budget is not None:
        cap = torch.clamp(cap, max=cfg.budget.max_per_stratum)
    return ControllerState(capacity=cap, base_capacity=ctrl.base_capacity,
                           latency_ema=ema, pressure=pressure)
