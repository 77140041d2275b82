"""Weighted-sample projection of independently sampled cells.

Counterpart of the reference's ``core/quantile.SampleView``. The quantile
estimators of that module come with the ``weighted_hist`` kernel in a
later slice; the linear queries need only the view.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class SampleView:
    """``G`` independently sampled cells: ``values [G, N]`` f32 slot
    payloads, ``counts [G]`` int32 arrivals ``C_g``, ``taken [G]`` int32
    live sample sizes ``Y_g`` (slots ``>= Y_g`` are dead)."""
    values: torch.Tensor
    counts: torch.Tensor
    taken: torch.Tensor

    def weights(self) -> torch.Tensor:
        """Per-cell HT weight ``W_g`` (Eq. 1)."""
        c = self.counts.to(torch.float32)
        y = torch.clamp(self.taken, min=1).to(torch.float32)
        return torch.where(self.counts > self.taken, c / y, 1.0)

    def slot_mask(self) -> torch.Tensor:
        slots = torch.arange(self.values.shape[1], dtype=torch.int32,
                             device=self.values.device)
        return slots[None, :] < self.taken[:, None]
