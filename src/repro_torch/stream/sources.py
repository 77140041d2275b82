"""Synthetic stream sources (paper §5.1, §6.1), drawn on the device.

Counterpart of the reference's ``GaussianSource`` and ``NetflowSource``.
Draws come from an explicit ``torch.Generator`` on the chunk's device;
they are not the reference's draws bit for bit, and no parity test relies
on them.
"""
from __future__ import annotations

import dataclasses

import torch


def _strata(generator: torch.Generator, mix: tuple, size: int):
    """Stratum ids drawn from the arrival-rate mixture ``mix``."""
    f32 = dict(dtype=torch.float32, device=generator.device)
    cum = torch.cumsum(torch.tensor(mix, **f32), 0)
    u = torch.rand(size, generator=generator, **f32)
    return torch.bucketize(u * cum[-1], cum[:-1], right=True)


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
        f32 = dict(dtype=torch.float32, device=generator.device)
        sid = _strata(generator, self.mix, size)
        mu = torch.tensor(self.mus, **f32)[sid]
        sg = torch.tensor(self.sigmas, **f32)[sid]
        vals = mu + sg * torch.randn(size, generator=generator, **f32)
        return vals, sid.to(torch.int32)


@dataclasses.dataclass(frozen=True)
class NetflowSource:
    """CAIDA-like NetFlow (paper §6.1): strata are the protocols TCP, UDP
    and ICMP, the value is a flow's bytes, log-normal per protocol."""
    mix: tuple = (0.85, 0.13, 0.02)
    log_mu: tuple = (7.5, 6.0, 4.5)
    log_sigma: tuple = (1.8, 1.2, 0.6)

    @property
    def num_strata(self) -> int:
        return 3

    def chunk(self, generator: torch.Generator, size: int):
        """``(values f32 [size], stratum_ids i32 [size])`` on the
        generator's device."""
        f32 = dict(dtype=torch.float32, device=generator.device)
        sid = _strata(generator, self.mix, size)
        mu = torch.tensor(self.log_mu, **f32)[sid]
        sg = torch.tensor(self.log_sigma, **f32)[sid]
        vals = torch.exp(mu + sg * torch.randn(size, generator=generator,
                                               **f32))
        return vals, sid.to(torch.int32)
