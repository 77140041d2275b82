"""The paper's estimates and their bounds (§3.3, Eqs. 2-9), worked out in
float64 from a sample ring, as the plain reference of an emission.

A cell is one (slot, stratum) reservoir: ``C`` arrivals, ``Y = min(C,
N)`` sampled items, weight ``C / Y`` where ``C > Y`` (else 1). A query
answer is a value and its 95% half-width ``2·sqrt(Var)`` (the paper's
68-95-99.7 rule). ``dtype`` is the precision of every step:
``torch.float64`` for the reference, a lower one for the control.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def view_cells(layout, slots: tuple, open_interval: int,
               counts: np.ndarray, interval=None) -> np.ndarray:
    """``[K, S]`` arrivals of the cells an emission reads: the live
    slots (the ``min(open + 1, K)`` newest), or under watermark emission
    the one slot that still holds ``interval``."""
    k = layout.num_intervals
    out = np.zeros_like(counts)
    if interval is not None:
        slot = interval % k
        if slots[slot] == interval:
            out[slot] = counts[slot]
        return out
    cursor = (open_interval + 1) % k
    filled = min(open_interval + 1, k)
    for slot in range(k):
        if (slot - cursor) % k >= k - filled:
            out[slot] = counts[slot]
    return out


def cell_moments(ring: torch.Tensor, counts: np.ndarray, capacity: int,
                 transform, dtype) -> Dict[str, torch.Tensor]:
    """Per cell of ``ring [K, S, N]``: ``C``, ``Y``, the sum and the
    unbiased variance of the transformed sample, in ``dtype``."""
    k, s, _ = ring.shape
    c = torch.as_tensor(counts.reshape(-1), dtype=torch.float64)
    taken = np.minimum(counts, capacity).reshape(-1)
    sums, s2 = [], []
    flat = ring.reshape(k * s, -1)
    for g in range(k * s):
        y = int(taken[g])
        x = transform(flat[g, :y]).to(dtype)
        total = x.sum(dtype=dtype) if y else torch.zeros((), dtype=dtype)
        sums.append(total)
        if y > 1:
            dev = x - total / y
            s2.append((dev * dev).sum(dtype=dtype) / (y - 1))
        else:
            s2.append(torch.zeros((), dtype=dtype, device=x.device))
    return {"c": c.to(dtype), "y": torch.as_tensor(taken, dtype=dtype),
            "sum": torch.stack([t.cpu() for t in sums]),
            "s2": torch.stack([t.cpu() for t in s2])}


def _sum(m, groups: List[List[int]]):
    c, y, total, s2 = m["c"], m["y"], m["sum"], m["s2"]
    yc = torch.clamp(y, min=1)
    w = torch.where(c > y, c / yc, torch.ones_like(c))
    var = c * torch.clamp(c - y, min=0) * s2 / yc
    return ([float((w * total)[g].sum()) for g in groups],
            [float(var[g].sum()) for g in groups])


def _mean(m, groups: List[List[int]]):
    c, y, s2 = m["c"], m["y"], m["s2"]
    values, variances = [], []
    sums, _ = _sum(m, groups)
    yc = torch.clamp(y, min=1)
    for g, total in zip(groups, sums):
        n = float(c[g].sum())
        n = max(n, 1.0)
        omega = c[g] / n
        fpc = torch.where(c[g] > 0, torch.clamp(c[g] - y[g], min=0)
                          / torch.clamp(c[g], min=1), torch.zeros_like(c[g]))
        values.append(total / n)
        variances.append(float((omega * omega * s2[g] / yc[g] * fpc).sum()))
    return values, variances


def answers(ring: torch.Tensor, counts: np.ndarray, capacity: int,
            queries: list, dtype=torch.float64) -> Dict[str, tuple]:
    """Each query's ``(values, half-widths)`` (lists: one entry for a
    merged window, one per stratum key for ``per_key``)."""
    k, s, _ = ring.shape
    out = {}
    cache = {}
    for q in queries:
        gt = q.get("gt")
        if gt not in cache:
            transform = ((lambda x: x) if gt is None
                         else (lambda x, t=gt: (x > t).to(torch.float32)))
            cache[gt] = cell_moments(ring, counts, capacity, transform,
                                     dtype)
        m = cache[gt]
        if q.get("window", "merged") == "per_key":
            groups = [[slot * s + key for slot in range(k)]
                      for key in range(s)]
        else:
            groups = [list(range(k * s))]
        values, variances = (_mean if q["kind"] == "mean" else _sum)(
            m, groups)
        out[q["name"]] = (values,
                          [2.0 * float(np.sqrt(max(v, 0.0)))
                           for v in variances])
    return out
