"""Online Adaptive Stratified Reservoir Sampling (OASRS), paper §3.2.

Counterpart of the reference's ``core/oasrs.py`` for scalar payloads
(one ``[S, N_max]`` reservoir tensor): the state, its fresh-buffer
``init``, and the chunk fold with the same key schedule — the key is
split three ways and two ``[M]`` uniforms are drawn up front. The fold
runs where the tensors lie (``kernels/ops``): the CUDA kernel on the
card, the plain version on the CPU; both consume the same random stream.

Unlike the reference's pure updates, the fold writes the reservoir
tensor IN PLACE (the ring is never re-materialised per chunk); the
returned state shares ``values`` with the input state.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import prng
from repro_torch.kernels import ops
from repro_torch.utils import DeviceLike, resolve_device

@dataclasses.dataclass
class OASRSState:
    """Per-window sampling state.

    values:   ``[S, N_max]`` reservoir payloads (f32 or i32).
    counts:   ``[S]`` int32 — ``C_i``, arrivals per stratum this window.
    capacity: ``[S]`` int32 — ``N_i <= N_max``, the adaptive knob.
    key:      ``[2]`` int64 PRNG key (two u32 words).
    """
    values: torch.Tensor
    counts: torch.Tensor
    capacity: torch.Tensor
    key: torch.Tensor

    @property
    def num_strata(self) -> int:
        return self.counts.shape[-1]

    @property
    def max_capacity(self) -> int:
        return self.values.shape[-1]

    def taken(self) -> torch.Tensor:
        """``Y_i = min(C_i, N_i)``."""
        return torch.minimum(self.counts, self.capacity)

    def weights(self) -> torch.Tensor:
        """Eq. 1: ``W_i = C_i/N_i`` if ``C_i > N_i`` else 1."""
        c = self.counts.to(torch.float32)
        n = torch.clamp(self.capacity, min=1).to(torch.float32)
        return torch.where(self.counts > self.capacity, c / n, 1.0)

    def slot_mask(self) -> torch.Tensor:
        """``[S, N_max]`` bool — which slots hold sampled items."""
        slots = torch.arange(self.max_capacity, dtype=torch.int32,
                             device=self.counts.device)
        return slots < self.taken()[..., None]


def init(num_strata: int, capacity, key: torch.Tensor,
         max_capacity: Optional[int] = None,
         dtype: torch.dtype = torch.float32,
         device: DeviceLike = None) -> OASRSState:
    """Empty state; ``capacity`` is an int or ``[S]`` ints.

    ``capacity`` always gets a FRESH buffer, never a view of the
    caller's tensor: the state is updated in place later.
    """
    dev = resolve_device(device)
    cap = torch.as_tensor(capacity, dtype=torch.int32)
    if max_capacity is None:
        max_capacity = int(cap.max())
    cap = cap.to(dev).expand(num_strata).clone()
    return OASRSState(
        values=torch.zeros((num_strata, max_capacity), dtype=dtype,
                           device=dev),
        counts=torch.zeros(num_strata, dtype=torch.int32, device=dev),
        capacity=cap,
        key=key.to(dev))


def apply_chunk_uniforms(state: OASRSState, stratum_ids: torch.Tensor,
                         payload: torch.Tensor, mask: torch.Tensor,
                         u_accept: torch.Tensor,
                         u_slot: torch.Tensor) -> OASRSState:
    """The chunk fold given pre-drawn uniforms; ``state.key`` is kept.

    Bit-identical to folding the chunk item by item through Algorithm 1
    with the same uniforms. ``state.values`` is written in place.
    """
    counts = ops.reservoir_fold(stratum_ids.to(torch.int32), payload,
                                u_accept, u_slot, mask, state.counts,
                                state.capacity, state.values)
    return OASRSState(values=state.values, counts=counts,
                      capacity=state.capacity, key=state.key)


def update_chunk(state: OASRSState, stratum_ids: torch.Tensor,
                 payload: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> OASRSState:
    """Fold a micro-batch of ``M`` items into the reservoirs."""
    m = stratum_ids.shape[0]
    if mask is None:
        mask = torch.ones(m, dtype=torch.bool, device=stratum_ids.device)
    keys = prng.split(state.key, 3)
    u_accept = prng.uniform(keys[1], m)
    u_slot = prng.uniform(keys[2], m)
    out = apply_chunk_uniforms(state, stratum_ids, payload, mask, u_accept,
                               u_slot)
    return dataclasses.replace(out, key=keys[0])
