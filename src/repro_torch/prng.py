"""Threefry-2x32 keys and uniforms in torch integer ops, bit for bit with
``jax.random`` (threefry2x32, ``jax_threefry_partitionable=True``).

A key is a ``[2]`` int64 tensor holding two unsigned 32-bit words. Every
word stays in ``[0, 2**32)``: sums and shifts are masked with
``& 0xFFFFFFFF`` right after they are taken, so the same code runs on the
CPU and on the card with no unsigned dtype. There is no global generator:
every draw names its key, and the tensors stay on the key's device.

Keys may carry leading axes: ``split``, ``fold_in``, ``random_bits``,
``uniform`` and ``randint`` take ``[..., 2]`` keys and give ``[..., ...]``
draws, bit for bit what ``jax.vmap`` over the keys gives. Each key's
counters run ``0 ... n-1`` of its own draw (not a flat index over the
batch), so a batch of ``W`` shards' draws is one hash over ``[W, n]``
words, one call of :func:`threefry2x32` whatever ``W``.

The schedule matches ``jax._src.prng`` as installed beside the reference:

* ``PRNGKey(seed)`` — the seed is taken as a 32-bit integer (x32 mode),
  whose logical right shift by 32 is 0: the key is ``[0, seed mod 2**32]``.
* ``split(key, n)`` — the fold-like form: key ``i`` is
  ``threefry2x32(key, (hi(i), lo(i)))``, both output words.
* ``fold_in(key, d)`` — ``threefry2x32(key, (0, d))``.
* ``random_bits(key, shape)`` — ``bits1 ^ bits2`` over the flat-index
  counters ``(hi(i), lo(i))``.
* ``uniform(key, shape)`` — ``((bits >> 9) | 0x3F800000)`` viewed as f32,
  minus 1.
* ``randint(key, shape, minval, maxval)`` — int32 ``_randint``: split the
  key in two, draw a high and a low word per element, and reduce both
  modulo the span in u32 arithmetic.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & _MASK) | (x >> (32 - d))


def threefry2x32(key: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of counter pairs ``(x0, x1)`` under ``key``.

    ``x0``/``x1`` are int64 tensors of u32 words of one shape ``[n]``;
    ``key`` is ``[..., 2]``. Returns the two hashed words, ``[..., n]``.
    Twenty rounds, key injection every four, exactly
    ``_threefry2x32_lowering``'s unrolled form.
    """
    k0, k1 = key[..., 0:1], key[..., 1:2]
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _counters(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & _MASK


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """The raw key ``jax.random.PRNGKey(seed)`` gives (x32 mode)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``[..., num, 2]`` new keys (``jax.random.split``, fold-like form)."""
    hi, lo = _counters(num, key.device)
    b0, b1 = threefry2x32(key, hi, lo)
    return torch.stack([b0, b1], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a Python int ``data``.

    The counter is filled on the key's device (no host-to-device copy,
    which on the card would wait for the stream)."""
    hi = torch.zeros(1, dtype=torch.int64, device=key.device)
    lo = torch.full((1,), int(data) & _MASK, dtype=torch.int64,
                    device=key.device)
    b0, b1 = threefry2x32(key, hi, lo)
    return torch.cat([b0, b1], dim=-1)


def random_bits(key: torch.Tensor,
                shape: Union[int, Sequence[int]]) -> torch.Tensor:
    """32-bit random words (int64 tensor) of ``key.shape[:-1] + shape``."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    n = 1
    for d in shape:
        n *= d
    hi, lo = _counters(n, key.device)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(tuple(key.shape[:-1]) + shape)


def uniform(key: torch.Tensor,
            shape: Union[int, Sequence[int]]) -> torch.Tensor:
    """f32 uniforms in ``[0, 1)`` (``jax.random.uniform``, defaults)."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def randint(key: torch.Tensor, shape: Union[int, Sequence[int]],
            minval, maxval) -> torch.Tensor:
    """int32 draws in ``[minval, maxval)`` (``jax.random.randint``).

    ``minval``/``maxval`` are ints or int32 tensors broadcastable to
    ``shape``; where ``maxval <= minval`` the draw is ``minval``. Two
    32-bit words per element (``k1``, ``k2`` from ``split(key)``) are
    reduced as ``((hi % span) * mult + lo % span) % span`` with ``mult =
    ((2**16 % span)**2) % span``, every product and sum wrapped to 32 bits
    as the reference's u32 lanes wrap (so ``mult`` is 0 for spans above
    2**16, where the square is 2**32).
    """
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    keys = split(key, 2)
    hi = random_bits(keys[..., 0, :], shape)
    lo = random_bits(keys[..., 1, :], shape)

    def bound(v) -> torch.Tensor:
        # A Python int is filled on the device: a host-to-device copy
        # would wait for the stream on every draw.
        if isinstance(v, torch.Tensor):
            return v.to(key.device).long()
        return torch.full((), int(v), dtype=torch.int64, device=key.device)
    lo_v, hi_v = bound(minval), bound(maxval)
    span = torch.where(hi_v <= lo_v, 1, (hi_v - lo_v) & _MASK)
    mult = torch.remainder(torch.remainder(2 ** 16, span) ** 2 & _MASK, span)
    off = (torch.remainder(hi, span) * mult) & _MASK
    off = (off + torch.remainder(lo, span)) & _MASK
    off = torch.remainder(off, span)
    return ((lo_v + off) & _MASK).to(torch.int32)
