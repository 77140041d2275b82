"""KV caches for decode.

Counterpart of the reference's ``models/kvcache.py``: a leading
``layers`` axis, a scalar ``position`` (aligned batches), ring semantics
when ``window > 0``. ``position`` is a 0-dim int32 tensor on the cache's
device and is never read back to the host: the write slot is computed
and clamped on the device and used as a ``[1]`` index.

:func:`write_token` writes the layer's cache IN PLACE (the reference
returns new arrays; here the caller's cache tensors are the ones
updated). Under a mesh the cache is placed by :data:`CACHE_LOGICAL`, the
reference's annotation, each rank allocating only its shard.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.models.config import ModelConfig
from repro_torch.utils import DeviceLike, resolve_device


#: Logical axes of a ``[L, B, Smax, Hkv, hd]`` cache.
CACHE_LOGICAL = ("layers", "batch", "kv_seq", "kv_heads", None)


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
        k=shd.zeros(shape, CACHE_LOGICAL, cfg.dtype, dev),
        v=shd.zeros(shape, CACHE_LOGICAL, cfg.dtype, dev),
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
    Returns ``(layer_k, layer_v)``. Ring semantics when window > 0. On a
    ``DTensor`` cache, :func:`_write_local`.
    """
    return write_at(layer_k, layer_v, write_slot(cache), k_new, v_new)


def write_at(layer_k: torch.Tensor, layer_v: torch.Tensor,
             slot: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor):
    """Write one token's K/V at ``slot`` (``[1]`` int64, on the device) of
    dim 1 of ``layer_k/v [B, Smax, Hkv, hd]``, in place."""
    if isinstance(layer_k, shd.DTensor):
        return _write_local(layer_k, layer_v, slot, k_new, v_new)
    layer_k.index_copy_(1, slot, k_new.to(layer_k.dtype))
    layer_v.index_copy_(1, slot, v_new.to(layer_v.dtype))
    return layer_k, layer_v


def write_prompt(dst_k: torch.Tensor, dst_v: torch.Tensor, i: int,
                 k: torch.Tensor, v: torch.Tensor, kept: int) -> None:
    """Write a prompt's last ``kept`` positions of layer ``i``'s K/V ``[B,
    S, Hkv, hd]`` into slots ``[0, kept)`` of ``dst_k/v [L, B, Smax, Hkv,
    hd]``, in place."""
    s = k.shape[1]
    if not isinstance(dst_k, shd.DTensor):
        dst_k[i, :, :kept] = k[:, s - kept:]
        dst_v[i, :, :kept] = v[:, s - kept:]
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = dst_k.device_mesh
    want = [Shard(pl.dim - 1) if isinstance(pl, Shard) and pl.dim != 2
            else Replicate() for pl in dst_k.placements]
    shape, offset = shd.local_shape_and_offset(dst_k)
    lo, hi = offset[2], min(offset[2] + shape[2], kept)
    if hi <= lo:
        return
    for cache_t, new in ((dst_k, k), (dst_v, v)):
        ln = new.redistribute(mesh, want).to_local()
        cache_t.to_local()[i, :, :hi - lo] = ln[:, s - kept + lo:
                                               s - kept + hi]


def _write_local(layer_k, layer_v, slot, k_new, v_new):
    """:func:`write_at` on each rank's shard: the token's K/V placed like
    the cache's batch and head dims; where the sequence is sharded, the
    rank whose slice holds the slot writes it and the others rewrite one
    of their slots with its own value."""
    from torch.distributed.tensor import Replicate, Shard
    if isinstance(slot, shd.DTensor):
        slot = slot.to_local()
    mesh = layer_k.device_mesh
    want = [pl if isinstance(pl, Shard) and pl.dim != 1 else Replicate()
            for pl in layer_k.placements]
    shape, offset = shd.local_shape_and_offset(layer_k)
    local = slot - offset[1]
    inside = (local >= 0) & (local < shape[1])
    local = torch.clamp(local, 0, shape[1] - 1)
    for cache_t, new in ((layer_k, k_new), (layer_v, v_new)):
        lc = cache_t.to_local()
        ln = new.redistribute(mesh, want).to_local().to(lc.dtype)
        lc.index_copy_(1, local, torch.where(
            inside, ln, lc.index_select(1, local)))
    return layer_k, layer_v
