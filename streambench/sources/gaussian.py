"""Gaussian sub-streams (StreamApprox §5.1): stratum ``i`` draws
``mean_i + sd_i · N(0, 1)`` in f32."""
from __future__ import annotations

import torch

from sources._strata import draw_sids, per_stratum


def make(config: dict, shape: tuple, gen, device):
    """``(values f32, stratum ids int32)`` of ``shape``."""
    strata = config["strata"]
    sids = draw_sids(strata, shape, gen, device)
    z = torch.randn(shape, generator=gen, device=device)
    values = per_stratum(strata, "mean", sids) + per_stratum(
        strata, "sd", sids) * z
    return values, sids
