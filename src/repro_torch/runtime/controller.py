"""Backpressure + adaptive sample-size controller, paper §2.3/§4.2.

Counterpart of the reference's ``runtime/controller.py``: at every
emission the measured step latency (EMA-smoothed) and the realized error
of the accuracy query retune the per-stratum capacity that newly opened
intervals adopt. All on the device; nothing is read back.

``export`` feeds the checkpoint manifest and ``telemetry`` the
``controller`` event; ``from_export`` is kept for parity with the
reference's API only (only the tests call it).
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
    and from the caller's tensor. A ``[W, S]`` capacity gives one
    controller per shard (``[W]`` EMA and pressure)."""
    cap = capacity.to(torch.int32).clone()
    z = torch.zeros(cap.shape[:-1], dtype=torch.float32, device=cap.device)
    return ControllerState(capacity=cap, base_capacity=cap.clone(),
                           latency_ema=z, pressure=z.clone())


def export(ctrl: ControllerState) -> dict:
    """Plain-Python view of the controller state (the checkpoint
    manifest): capacity lists, EMA and pressure floats."""
    return {f.name: getattr(ctrl, f.name).tolist()
            for f in dataclasses.fields(ControllerState)}


def telemetry(ctrl: ControllerState) -> dict:
    """The signals of one ``controller`` event: the global capacity
    (shard capacities summed), the worst shard's pressure and latency
    EMA. Reads the state back; emitted only at emission boundaries,
    which already synchronized."""
    cap = ctrl.capacity.cpu().numpy()
    if cap.ndim == 2:
        cap = cap.sum(axis=0)
    return {"capacity": cap.tolist(),
            "pressure": float(ctrl.pressure.max()),
            "latency_ema": float(ctrl.latency_ema.max())}


def from_export(d: dict, device) -> ControllerState:
    """A :class:`ControllerState` on ``device`` from :func:`export`."""
    def t(name, dtype):
        return torch.tensor(d[name], dtype=dtype, device=device)
    return ControllerState(capacity=t("capacity", torch.int32),
                           base_capacity=t("base_capacity", torch.int32),
                           latency_ema=t("latency_ema", torch.float32),
                           pressure=t("pressure", torch.float32))


def update(ctrl: ControllerState, cfg: ControllerConfig,
           stats: err.StratumStats, realized: err.Estimate,
           latency_s: torch.Tensor, intervals: int = 1) -> ControllerState:
    """One feedback step at an emission boundary.

    ``stats`` are per-stratum ``[S]`` (window cells pooled per stratum);
    ``intervals`` turns the window-level Neyman allocation into the
    per-interval capacity. A sharded controller (``[W]`` rows) takes
    ``[W, S]`` stats, each shard's row its own, and the one global
    ``realized`` estimate and latency.
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
        cap = torch.ceil(cap.to(torch.float32)
                         * relief[..., None]).to(torch.int32)
    else:
        pressure = torch.zeros_like(ema)
    cap = torch.clamp(cap, min=cfg.min_per_stratum)
    if cfg.budget is not None:
        cap = torch.clamp(cap, max=cfg.budget.max_per_stratum)
    return ControllerState(capacity=cap, base_capacity=ctrl.base_capacity,
                           latency_ema=ema, pressure=pressure)


def next_batch_chunks(batch_chunks: int, pressure: float,
                      max_batch_chunks: int,
                      closes_per_batch: int = 0) -> int:
    """Host-side micro-batch sizing from the pressure signal (batched).

    Pressure > 1 doubles the micro-batch, pressure < 1/2 halves it, in
    powers of two. Under watermark emission, more than one interval closed
    by one micro-batch means the batch barrier, not the watermark, paces
    the emissions, so the micro-batch halves regardless of pressure.
    """
    if closes_per_batch > 1 and batch_chunks > 1:
        return batch_chunks // 2
    if pressure > 1.0 and batch_chunks < max_batch_chunks:
        return min(batch_chunks * 2, max_batch_chunks)
    if pressure < 0.5 and batch_chunks > 1:
        return batch_chunks // 2
    return batch_chunks
