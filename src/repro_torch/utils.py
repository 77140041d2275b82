"""Shared small utilities: device choice, ranking, counting, key labels."""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch import prng

DeviceLike = Optional[Union[str, torch.device]]


class NoCudaDeviceError(RuntimeError):
    """An entry point was asked for the card (the default) and none is
    present. Pass ``device="cpu"`` to run on the CPU on purpose."""


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDeviceError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev


def rank_within_stratum(stratum_ids: torch.Tensor) -> torch.Tensor:
    """``r[j]`` = number of ``k < j`` with ``stratum_ids[k] == stratum_ids[j]``.

    Stable sort, then each item's position minus the start of its group,
    scattered back to item order. int32 out, like the reference.
    """
    m = stratum_ids.shape[0]
    order = torch.argsort(stratum_ids, stable=True)
    sorted_ids = stratum_ids[order]
    idx = torch.arange(m, dtype=torch.int64, device=stratum_ids.device)
    is_start = torch.ones(m, dtype=torch.bool, device=stratum_ids.device)
    is_start[1:] = sorted_ids[1:] != sorted_ids[:-1]
    group_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    rank = torch.empty(m, dtype=torch.int32, device=stratum_ids.device)
    rank[order] = (idx - group_start).to(torch.int32)
    return rank


def bincount(stratum_ids: torch.Tensor, num_strata: int) -> torch.Tensor:
    """Fixed-length int32 bincount. ``torch.bincount`` reads the largest
    id back to the host on CUDA; a scatter-add never leaves the device."""
    out = torch.zeros(num_strata, dtype=torch.int32,
                      device=stratum_ids.device)
    ones = torch.ones_like(stratum_ids, dtype=torch.int32)
    return out.index_add_(0, stratum_ids.long(), ones)


def fold_in_str(key: torch.Tensor, label: str) -> torch.Tensor:
    """Deterministically fold a string label into a PRNG key."""
    h = 0
    for ch in label:
        h = (h * 131 + ord(ch)) % (2**31 - 1)
    return prng.fold_in(key, h)
