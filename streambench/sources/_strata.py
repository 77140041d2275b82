"""Stratum ids drawn from the configuration's shares."""
from __future__ import annotations

import torch


def draw_sids(strata: list, shape: tuple, gen, device) -> torch.Tensor:
    """int32 stratum ids, stratum ``i`` with probability ``weight_i /
    sum(weights)``, from one uniform per item."""
    w = torch.tensor([float(s["weight"]) for s in strata],
                     dtype=torch.float64)
    cum = torch.cumsum(w / w.sum(), 0)[:-1].to(torch.float32).to(device)
    u = torch.rand(shape, generator=gen, device=device)
    return torch.bucketize(u, cum, right=True).to(torch.int32)


def per_stratum(strata: list, key: str, sids: torch.Tensor) -> torch.Tensor:
    table = torch.tensor([float(s[key]) for s in strata],
                         dtype=torch.float32, device=sids.device)
    return table[sids.long()]
