"""Synthetic stream sources, paper §5.1 and the case-study generators.

Counterpart of the reference's ``stream/sources.py``: each source makes
``(values, stratum_ids)`` chunks from a threefry key (``prng``), on the
key's device, with the reference's draws. ``chunk(key, size)`` splits the
key in two, draws the stratum ids from the first half by
``prng.choice`` over the arrival mix and the values from the second:

* ``GaussianSource`` / ``PoissonSource`` — the §5.1 microbenchmark
  streams; ids, and values wherever ``prng.normal`` is, bit for bit.
* ``NetflowSource`` — CAIDA-like records (§6.2): the protocols TCP, UDP
  and ICMP, log-normal flow bytes (``prng.xla_exp``, the reference's
  ``jnp.exp``), bit for bit.
* ``TaxiSource`` — DEBS'15-like rides (§6.3): 6 boroughs, gamma trip
  distances (``prng.gamma``), bit for bit.

A key with leading axes (``[W, 2]``) gives ``[W, size]`` leaves, what
``jax.vmap`` over the keys gives.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch import prng


@dataclasses.dataclass
class StreamChunk:
    values: torch.Tensor        # [M] f32 ([W, M] sharded)
    stratum_ids: torch.Tensor   # [M] i32


class Source:
    """Interface: stratified record generator."""
    num_strata: int
    mix: tuple

    def chunk(self, key: torch.Tensor, size: int) -> StreamChunk:
        raise NotImplementedError

    def _draw(self, key: torch.Tensor, size: int):
        """``(k2, sid)``: the value key and the stratum ids (int64)."""
        keys = prng.split(key)
        p = _on_device(self.mix, key.device)
        sid = prng.choice(keys[..., 0, :], self.num_strata, size, p)
        return keys[..., 1, :], sid

    @staticmethod
    def _per_stratum(params: tuple, sid: torch.Tensor) -> torch.Tensor:
        return _on_device(params, sid.device)[sid]


def _on_device(params: tuple, device) -> torch.Tensor:
    """f32 ``[len(params)]`` filled on ``device``: a tensor copied from
    the host would wait for the card's stream on every chunk."""
    return torch.stack([torch.full((), float(np.float32(v)),
                                   dtype=torch.float32, device=device)
                        for v in params])


@dataclasses.dataclass(frozen=True)
class GaussianSource(Source):
    """Paper §5.1: A(µ=10,σ=5), B(µ=1000,σ=50), C(µ=10000,σ=500)."""
    mus: tuple = (10.0, 1000.0, 10000.0)
    sigmas: tuple = (5.0, 50.0, 500.0)
    mix: tuple = (1 / 3, 1 / 3, 1 / 3)   # arrival-rate mixture

    @property
    def num_strata(self) -> int:
        return len(self.mus)

    def chunk(self, key: torch.Tensor, size: int) -> StreamChunk:
        k2, sid = self._draw(key, size)
        mu = self._per_stratum(self.mus, sid)
        sg = self._per_stratum(self.sigmas, sid)
        vals = mu + sg * prng.normal(k2, size)
        return StreamChunk(values=vals, stratum_ids=sid.to(torch.int32))


@dataclasses.dataclass(frozen=True)
class PoissonSource(Source):
    """Paper §5.1: λ = (10, 1000, 1e8); §5.7 skew: mix (80, 19.99, 0.01)%."""
    lams: tuple = (10.0, 1000.0, 1e8)
    mix: tuple = (1 / 3, 1 / 3, 1 / 3)

    @property
    def num_strata(self) -> int:
        return len(self.lams)

    def chunk(self, key: torch.Tensor, size: int) -> StreamChunk:
        k2, sid = self._draw(key, size)
        lam = self._per_stratum(self.lams, sid)
        # The Gaussian approximation, as the reference's (λ >= 10 in every
        # setting of the paper).
        vals = lam + torch.sqrt(lam) * prng.normal(k2, size)
        return StreamChunk(values=torch.clamp(vals, min=0.0),
                           stratum_ids=sid.to(torch.int32))


@dataclasses.dataclass(frozen=True)
class NetflowSource(Source):
    """CAIDA-like NetFlow: strata = protocol, value = flow bytes."""
    #              TCP    UDP    ICMP
    mix: tuple = (0.85, 0.13, 0.02)
    log_mu: tuple = (7.5, 6.0, 4.5)      # log-bytes location per protocol
    log_sigma: tuple = (1.8, 1.2, 0.6)

    @property
    def num_strata(self) -> int:
        return 3

    def chunk(self, key: torch.Tensor, size: int) -> StreamChunk:
        k2, sid = self._draw(key, size)
        mu = self._per_stratum(self.log_mu, sid)
        sg = self._per_stratum(self.log_sigma, sid)
        vals = prng.xla_exp(mu + sg * prng.normal(k2, size))
        return StreamChunk(values=vals, stratum_ids=sid.to(torch.int32))


@dataclasses.dataclass(frozen=True)
class TaxiSource(Source):
    """DEBS'15-like taxi rides: strata = 6 boroughs, value = distance (mi)."""
    mix: tuple = (0.55, 0.20, 0.12, 0.08, 0.04, 0.01)
    shape: tuple = (2.0, 2.5, 2.2, 3.0, 2.8, 2.0)
    scale: tuple = (1.2, 1.8, 2.5, 3.5, 5.0, 8.0)

    @property
    def num_strata(self) -> int:
        return 6

    def chunk(self, key: torch.Tensor, size: int) -> StreamChunk:
        k2, sid = self._draw(key, size)
        shp = self._per_stratum(self.shape, sid)
        scl = self._per_stratum(self.scale, sid)
        vals = scl * prng.gamma(k2, shp)
        return StreamChunk(values=vals, stratum_ids=sid.to(torch.int32))


def skewed(source: Source, mix: Sequence[float]) -> Source:
    """Re-mix a source's arrival rates (§5.4 varying rates, §5.7 skew).

    ``mix`` is validated and normalized to sum to 1: one nonnegative,
    finite entry per stratum with positive total mass.
    """
    mix = tuple(float(m) for m in mix)
    if len(mix) != source.num_strata:
        raise ValueError(
            f"mix has {len(mix)} entries for {source.num_strata} strata")
    if any(m != m or m in (float("inf"), float("-inf")) for m in mix):
        raise ValueError(f"mix entries must be finite, got {mix}")
    if any(m < 0.0 for m in mix):
        raise ValueError(f"mix entries must be nonnegative, got {mix}")
    total = sum(mix)
    if total <= 0.0:
        raise ValueError(f"mix must have positive total mass, got {mix}")
    return dataclasses.replace(source, mix=tuple(m / total for m in mix))
