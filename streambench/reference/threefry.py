"""Threefry-2x32 keys and f32 uniforms, written from the Random123 paper
(Salmon et al., SC'11) and the key schedule of ``jax.random`` that the
system under test documents: a key is two unsigned 32-bit words; key
``i`` of a split is the hash of the counter pair ``(0, i)``; the ``n``
uniforms of a key are the hashes of ``(0, j)`` for ``j < n``, the two
output words xor-ed, the top 23 bits put under an exponent of 1 and 1
taken away.

Plain torch integer arithmetic on int64 tensors that hold u32 words,
every sum masked back to 32 bits. Nothing here is shared with the
program: this is the benchmark's own copy of the published hash.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def key_of_seed(seed: int) -> tuple[int, int]:
    """The key of a 32-bit seed: ``(0, seed mod 2**32)``."""
    return 0, int(seed) & MASK


def _rotate(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def hash_pairs(key: tuple[int, int], hi: torch.Tensor,
               lo: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds of the counter pairs ``(hi, lo)``
    (int64 tensors of u32 words) under ``key``."""
    k0, k1 = key
    ks = (k0, k1, (k0 ^ k1 ^ PARITY) & MASK)
    x0 = (hi + ks[0]) & MASK
    x1 = (lo + ks[1]) & MASK
    for block in range(5):
        for r in ROTATIONS[block % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotate(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & MASK
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & MASK
    return x0, x1


def uniforms(key: tuple[int, int], n: int, device,
             block: int = 1 << 22) -> torch.Tensor:
    """``n`` f32 uniforms in ``[0, 1)`` of ``key``, made in blocks of
    ``block`` counters so the int64 temporaries stay small."""
    out = torch.empty(n, dtype=torch.float32, device=device)
    for start in range(0, n, block):
        lo = torch.arange(start, min(n, start + block), dtype=torch.int64,
                          device=device)
        b0, b1 = hash_pairs(key, lo >> 32, lo & MASK)
        word = ((b0 ^ b1) >> 9) | 0x3F800000
        out[start:start + lo.numel()] = (
            word.to(torch.int32).view(torch.float32) - 1.0)
    return out


def _rotate_int(x: int, r: int) -> int:
    return ((x << r) & MASK) | (x >> (32 - r))


def hash_int(key: tuple[int, int], hi: int, lo: int) -> tuple[int, int]:
    """:func:`hash_pairs` of one counter pair, in Python integers."""
    k0, k1 = key
    ks = (k0, k1, (k0 ^ k1 ^ PARITY) & MASK)
    x0, x1 = (hi + ks[0]) & MASK, (lo + ks[1]) & MASK
    for block in range(5):
        for r in ROTATIONS[block % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotate_int(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & MASK
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & MASK
    return x0, x1


def split_int(key: tuple[int, int], num: int) -> list[tuple[int, int]]:
    """``num`` child keys: child ``i`` is the hash of ``(0, i)``."""
    return [hash_int(key, 0, i) for i in range(num)]
