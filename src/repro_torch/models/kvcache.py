"""KV caches for decode.

Counterpart of the reference's ``models/kvcache.py``: a leading
``layers`` axis, a scalar ``position`` (aligned batches), ring semantics
when ``window > 0``. ``position`` is a 0-dim int32 tensor on the cache's
device and is never read back to the host: the write slot is computed
and clamped on the device and used as a ``[1]`` index.

:func:`write_token` writes the layer's cache IN PLACE (the reference
returns new arrays; here the caller's cache tensors are the ones
updated).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.utils import DeviceLike, resolve_device


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor          # [L, B, Smax, Hkv, hd]
    v: torch.Tensor          # [L, B, Smax, Hkv, hd]
    position: torch.Tensor   # [] int32: tokens generated so far
    window: int = 0          # > 0: ring cache

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def init_cache(cfg: ModelConfig, num_layers: int, batch: int, max_len: int,
               window: int = 0, device: DeviceLike = None) -> KVCache:
    dev = resolve_device(device)
    shape = (num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
        v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
        position=torch.zeros((), dtype=torch.int32, device=dev),
        window=window)


def cache_len(cache: KVCache) -> torch.Tensor:
    """Number of valid entries (ring caches saturate at the window)."""
    if cache.window:
        return torch.clamp(cache.position, max=cache.window)
    return cache.position


def write_slot(cache: KVCache) -> torch.Tensor:
    """The ``[1]`` int64 slot the next token goes to: ``position`` (or
    ``position % window``), clamped to ``[0, Smax - 1]`` as XLA clamps
    ``dynamic_update_slice``'s start index. A cache allocated with no
    room past the prompt (``max_len=0``) therefore rewrites its last slot
    on every step, as the reference does."""
    pos = cache.position.reshape(1).long()
    if cache.window:
        pos = torch.remainder(pos, cache.window)
    return torch.clamp(pos, 0, cache.max_len - 1)


def write_token(layer_k: torch.Tensor, layer_v: torch.Tensor,
                cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor):
    """Insert one token's K/V into a single layer's cache slice, in place.

    layer_k/v: ``[B, Smax, Hkv, hd]``; k_new/v_new: ``[B, 1, Hkv, hd]``.
    Returns ``(layer_k, layer_v)``. Ring semantics when window > 0.
    """
    slot = write_slot(cache)
    layer_k.index_copy_(1, slot, k_new.to(layer_k.dtype))
    layer_v.index_copy_(1, slot, v_new.to(layer_v.dtype))
    return layer_k, layer_v
