"""Synthetic stream sources (paper §5.1), drawn on the device.

Counterpart of the reference's ``GaussianSource``. Draws come from an
explicit ``torch.Generator`` on the chunk's device; they are not the
reference's normal draws bit for bit, and no parity test relies on them.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class GaussianSource:
    """Paper §5.1: A(µ=10,σ=5), B(µ=1000,σ=50), C(µ=10000,σ=500)."""
    mus: tuple = (10.0, 1000.0, 10000.0)
    sigmas: tuple = (5.0, 50.0, 500.0)
    mix: tuple = (1 / 3, 1 / 3, 1 / 3)   # arrival-rate mixture

    @property
    def num_strata(self) -> int:
        return len(self.mus)

    def chunk(self, generator: torch.Generator, size: int):
        """``(values f32 [size], stratum_ids i32 [size])`` on the
        generator's device."""
        dev = generator.device
        f32 = dict(dtype=torch.float32, device=dev)
        cum = torch.cumsum(torch.tensor(self.mix, **f32), 0)
        u = torch.rand(size, generator=generator, **f32)
        sid = torch.bucketize(u * cum[-1], cum[:-1], right=True)
        mu = torch.tensor(self.mus, **f32)[sid]
        sg = torch.tensor(self.sigmas, **f32)[sid]
        vals = mu + sg * torch.randn(size, generator=generator, **f32)
        return vals, sid.to(torch.int32)
