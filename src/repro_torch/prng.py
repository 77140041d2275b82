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
* ``normal(key, shape)`` — ``sqrt(2) · erf_inv(uniform(lo, 1))`` with
  ``lo = nextafter(-1, 0)``, ``erf_inv`` the single-precision polynomial
  XLA's CPU backend compiles (Giles), its ``log1p`` the backend's own
  (Cephes ``logf`` for ``1 + x``, a rational form near 0), every
  multiply-add the backend contracts done as one fused step
  (:func:`_fma`). Bit for bit on the draws checked
  (``tests/test_torch_prng.py``).
* ``choice(key, n, shape, p)`` — ``searchsorted(cumsum(p), cum[-1] ·
  (1 - uniform))`` with the cumulative sum in the backend's order
  (:func:`xla_cumsum`).
* ``gamma(key, a)`` — Marsaglia–Tsang with one key per element, split
  as the reference splits it, its ``log``, ``rsqrt`` and ``pow`` XLA's
  CPU code (:func:`xla_log`, :func:`xla_rsqrt`, :func:`xla_pow`): bit
  for bit on the shapes checked.
* ``xla_exp`` / ``xla_log`` / ``xla_pow`` — ``jnp.exp`` / ``log`` /
  ``power`` of f32 as XLA's CPU backend computes them (Cephes ``expf``
  and ``logf`` from the compiled code, glibc's ``powf``).
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
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


def _counters(n: int, device,
              start: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
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


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a Python int ``data``; for an
    int64 tensor ``data [n]`` the ``[n, 2]`` keys ``jax.vmap`` over
    ``data`` gives (a ``[2]`` key only).

    The counter is filled on the key's device (no host-to-device copy,
    which on the card would wait for the stream)."""
    if isinstance(data, torch.Tensor):
        lo = data.to(device=key.device, dtype=torch.int64) & _MASK
        b0, b1 = threefry2x32(key, torch.zeros_like(lo), lo)
        return torch.stack([b0, b1], dim=-1)
    hi = torch.zeros(1, dtype=torch.int64, device=key.device)
    lo = torch.full((1,), int(data) & _MASK, dtype=torch.int64,
                    device=key.device)
    b0, b1 = threefry2x32(key, hi, lo)
    return torch.cat([b0, b1], dim=-1)


def random_bits(key: torch.Tensor, shape: Union[int, Sequence[int]],
                start: int = 0) -> torch.Tensor:
    """32-bit random words (int64 tensor) of ``key.shape[:-1] + shape``.

    ``start`` offsets the flat counter: the words are elements ``start
    ...`` of a larger draw from the same key, so a large draw can be made
    in slices of the same bits."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    n = 1
    for d in shape:
        n *= d
    hi, lo = _counters(n, key.device, start)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(tuple(key.shape[:-1]) + shape)


def _f32(x: float) -> float:
    """``x`` rounded to f32, as a Python float (f32-exact scalars keep
    torch's f32 arithmetic the reference's)."""
    return float(np.float32(x))


def _fma(a, b, c) -> torch.Tensor:
    """``a · b + c`` of f32 operands rounded once to f32, as the fused
    multiply-add XLA's CPU backend contracts a product and a sum into:
    the product is exact in f64, the f64 sum is rounded to f32."""
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    return (a.double() * (b.double() if isinstance(b, torch.Tensor) else b)
            + (c.double() if isinstance(c, torch.Tensor) else c)).float()


def uniform(key: torch.Tensor, shape: Union[int, Sequence[int]],
            minval: float = 0.0, maxval: float = 1.0,
            start: int = 0) -> torch.Tensor:
    """f32 uniforms in ``[minval, maxval)`` (``jax.random.uniform``):
    ``max(minval, u · (maxval - minval) + minval)`` for ``u`` in
    ``[0, 1)``, the multiply-add fused as the reference's compiled draw
    fuses it. ``start`` as in :func:`random_bits`."""
    bits = (random_bits(key, shape, start) >> 9) | 0x3F800000
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:
        return u
    lo, hi = _f32(minval), _f32(maxval)
    return torch.clamp(_fma(u, _f32(hi - lo), lo), min=lo)


# XLA's CPU log1p: Cephes ``logf`` of ``1 + x``, and a rational form for
# |x| below sqrt(2) - 1 (numerator and denominator, highest power first).
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
# Giles' single-precision erf_inv, for w < 5 and w >= 5.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _xla_log(y: torch.Tensor) -> torch.Tensor:
    """Cephes ``logf`` as XLA's CPU backend emits it, for ``y > 0``
    finite (the callers never pass anything else)."""
    y = torch.clamp(y, min=_f32(1.17549435e-38))
    b = y.view(torch.int32)
    ef = ((b >> 23) - 127).float() + 1.0
    m = ((b & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    small = m < _f32(0.70710676908493042)
    ef = ef - small.float()
    xr = (m - 1.0) + torch.where(small, m, 0.0)
    z = xr * xr
    x3 = z * xr
    y1 = _fma(_fma(xr, _f32(7.0376836292e-2), _f32(-1.1514610310e-1)), xr,
              _f32(1.1676998740e-1))
    y2 = _fma(_fma(xr, _f32(-1.2420140846e-1), _f32(1.4249322787e-1)), xr,
              _f32(-1.6668057665e-1))
    y3 = _fma(_fma(xr, _f32(2.0000714765e-1), _f32(-2.4999993993e-1)), xr,
              _f32(3.3333331174e-1))
    p = _fma(_fma(y1, x3, y2), x3, y3)
    p = _fma(p, x3, ef * _f32(-2.12194440e-4))
    return _fma(ef, 0.693359375, _fma(z, -0.5, xr) + p)


def xla_log(y: torch.Tensor) -> torch.Tensor:
    """``jnp.log`` of f32 ``y >= 0`` finite, bit for bit XLA's CPU code
    (0 and, flushed to it, a subnormal give ``-inf``)."""
    return torch.where(y < _f32(1.17549435e-38), float("-inf"), _xla_log(y))


def xla_rsqrt(x: torch.Tensor) -> torch.Tensor:
    """``lax.rsqrt`` of f32 ``x`` positive, normal and finite as XLA's CPU
    code computes it: an estimate refined by two Newton steps, each
    ``y + (-y/2)·(y·(x·y) - 1)`` with both multiply-adds fused. The
    backend's estimate is the CPU's ``rsqrtps``; this one is the
    correctly rounded root, which the two steps turn into the same result
    for most ``x`` but not all (some end one ulp apart). Bit for bit at
    every ``alpha - 1/3`` of the gamma draws the repository makes
    (shapes 1.5, 2, 2.2, 2.5, 2.8, 3)."""
    y = (1.0 / torch.sqrt(x.double())).float()
    for _ in range(2):
        y = _fma(y * -0.5, _fma(y, x * y, -1.0), y)
    return y


# XLA's CPU exp: Cephes ``expf``, its input clamped to [-87.8, 88.8] and
# ``2**n`` built from the exponent bits (n clamped to [-127, 127]).
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 0.5)


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """``jnp.exp`` of f32 ``x`` (finite), bit for bit XLA's CPU code: the
    backend's compiled ``expf`` with each multiply-add it contracts done
    as one step rounded once (:func:`_fma`), a subnormal result flushed
    to zero as the backend flushes it."""
    x = torch.clamp(x, _f32(-87.80000305175781), _f32(88.80000305175781))
    fx = torch.floor(_fma(x, _f32(1.4426950216293335), 0.5))
    fx = torch.clamp(fx, -127.0, 127.0)
    x = _fma(fx, -0.693359375, x)
    x = _fma(fx, -_f32(-2.12194440e-4), x)
    y = torch.full_like(x, _f32(_EXP_POLY[0]))
    for c in _EXP_POLY[1:]:
        y = _fma(y, x, _f32(c))
    y = _fma(y, x * x, x) + 1.0
    two_n = ((fx.to(torch.int32) + 127) << 23).view(torch.float32)
    out = y * two_n
    # The backend flushes subnormal results to zero.
    return torch.where(out < _f32(1.17549435e-38), 0.0, out)


# glibc's ``powf`` (what XLA's CPU backend calls for an f32 ``pow``):
# log2 of x from a 16-entry table and a degree-5 polynomial in f64, the
# product with y, and 2**that from a 32-entry table and a cubic, rounded
# once to f32. The constants are glibc's ``__powf_log2_data`` and
# ``__exp2f_data`` (x86_64, glibc 2.28 and later).
_POWF_LOG2 = tuple((float.fromhex(a), float.fromhex(b)) for a, b in (
    ("0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2"),
    ("0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2"),
    ("0x1.49539f0f010b0p+0", "-0x1.7418b0a1fb77bp-2"),
    ("0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2"),
    ("0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2"),
    ("0x1.25e227b0b8ea0p+0", "-0x1.97c1d1b3b7af0p-3"),
    ("0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3"),
    ("0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4"),
    ("0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5"),
    ("0x1.0000000000000p+0", "0x0p+0"),
    ("0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4"),
    ("0x1.ca4b31f026aa0p-1", "0x1.476a9543891bap-3"),
    ("0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3"),
    ("0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2"),
    ("0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2"),
    ("0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2")))
_POWF_POLY = tuple(float.fromhex(h) for h in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0"))
# 2**(i/32) as f64 bits less i << 47 (glibc stores them so).
_EXP2_TAB = (
    0x3ff0000000000000, 0x3fefd9b0d3158574, 0x3fefb5586cf9890f,
    0x3fef9301d0125b51, 0x3fef72b83c7d517b, 0x3fef54873168b9aa,
    0x3fef387a6e756238, 0x3fef1e9df51fdee1, 0x3fef06fe0a31b715,
    0x3feef1a7373aa9cb, 0x3feedea64c123422, 0x3feece086061892d,
    0x3feebfdad5362a27, 0x3feeb42b569d4f82, 0x3feeab07dd485429,
    0x3feea47eb03a5585, 0x3feea09e667f3bcd, 0x3fee9f75e8ec5f74,
    0x3feea11473eb0187, 0x3feea589994cce13, 0x3feeace5422aa0db,
    0x3feeb737b0cdc5e5, 0x3feec49182a3f090, 0x3feed503b23e255d,
    0x3feee89f995ad3ad, 0x3feeff76f2fb5e47, 0x3fef199bdd85529c,
    0x3fef3720dcef9069, 0x3fef5818dcfba487, 0x3fef7c97337b9b5f,
    0x3fefa4afa2a490da, 0x3fefd0765b6e4540)
_EXP2_SHIFT = float.fromhex("0x1.8p+47")      # 0x1.8p52 / 32
_EXP2_POLY = tuple(float.fromhex(h) for h in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1"))


def xla_pow(x: torch.Tensor, y) -> torch.Tensor:
    """``x ** y`` for f32 ``x`` positive, normal and finite and f32 ``y``
    (a tensor or a Python float) with ``y · log2 x < 126``: what the
    reference's ``jnp.power`` / ``lax.pow`` computes on the CPU, glibc's
    ``powf``, rebuilt in f64 torch ops (bit for bit on the 200,064 ranks
    of the token window and the 600,000 pairs of
    ``tests/test_torch_stream.py``); a result below
    ``2**-126`` is flushed to 0, as the backend flushes it. Overflow and
    the special inputs take glibc paths this rebuild does not have."""
    dev = x.device
    ix = x.contiguous().view(torch.int32).long() & _MASK
    tmp = (ix - 0x3F330000) & _MASK
    top = tmp & 0xFF800000
    k = torch.where(top >= 2 ** 31, top - 2 ** 32, top) >> 23
    tab = torch.tensor(_POWF_LOG2, dtype=torch.float64, device=dev)
    i = (tmp >> 19) % 16
    z = ((ix - top) & _MASK).to(torch.int32).view(torch.float32).double()
    r = z * tab[i, 0] - 1.0
    a = _POWF_POLY
    r2 = r * r
    logx = ((a[0] * r + a[1]) * (r2 * r2)
            + ((a[2] * r + a[3]) * r2 + (a[4] * r + (tab[i, 1] + k))))
    yd = y.double() if isinstance(y, torch.Tensor) else _f32(y)
    xd = yd * logx
    kd = xd + _EXP2_SHIFT
    ki = kd.view(torch.int64)
    r = xd - (kd - _EXP2_SHIFT)
    t2 = torch.tensor([v - (1 << 64) if v >= 1 << 63 else v
                       for v in _EXP2_TAB], dtype=torch.int64, device=dev)
    s = (t2[ki % 32] + (ki << 47)).view(torch.float64)
    c = _EXP2_POLY
    out = (((c[0] * r + c[1]) * (r * r) + (c[2] * r + 1.0)) * s).float()
    # Below 2**-126 the result is subnormal or 0, which the backend
    # flushes to 0.
    return torch.where(xd < -126.0, 0.0, out)


def _xla_log1p(a: torch.Tensor) -> torch.Tensor:
    """XLA's CPU ``log1p`` of f32 ``a > -1``."""
    x2 = a * a
    num = torch.full_like(a, _f32(_LOG1P_NUM[0]))
    den = torch.ones_like(a)
    for cn, cd in zip(_LOG1P_NUM[1:], _LOG1P_DEN[1:]):
        num = _fma(num, a, _f32(cn))
        den = _fma(den, a, _f32(cd))
    near0 = a + _fma(x2, -0.5, (a * x2) * (num / den))
    return torch.where(a.abs() < _f32(0.41421356237309504880), near0,
                       _xla_log(a + 1.0))


def normal(key: torch.Tensor, shape: Union[int, Sequence[int]],
           start: int = 0) -> torch.Tensor:
    """f32 standard normals (``jax.random.normal``); ``start`` as in
    :func:`random_bits`."""
    x = uniform(key, shape, float(np.nextafter(np.float32(-1.0),
                                               np.float32(0.0))), 1.0,
                start)
    w = -_xla_log1p(x * (-x))
    lt = w < 5.0
    # f64 then f32: a correctly rounded f32 root (``torch.sqrt`` of f32 on
    # the CPU is not, for some short tensors).
    wv = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(lt, _f32(_ERFINV_LT5[0]), _f32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, wv, torch.where(lt, _f32(a), _f32(b)))
    r = torch.where(x.abs() == 1.0, x * float("inf"), p * x)
    return r * _f32(np.sqrt(2.0))


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 cumulative sum of a 1-D ``x`` in the order of
    ``jnp.cumsum`` on XLA's CPU backend: sequential within blocks of 16,
    the blocks' totals scanned the same way and added to the next
    blocks. (``torch.cumsum`` accumulates in f64 on the CPU and in a
    parallel order on the card.)"""
    n = x.shape[0]
    blk = 16
    if n <= blk:
        cols = [x[0]]
        for j in range(1, n):
            cols.append(cols[-1] + x[j])
        return torch.stack(cols)
    nb = -(-n // blk)
    rows = torch.zeros(nb * blk, dtype=x.dtype, device=x.device)
    rows[:n] = x
    rows = rows.view(nb, blk)
    cols = [rows[:, 0]]
    for j in range(1, blk):
        cols.append(cols[-1] + rows[:, j])
    inner = torch.stack(cols, dim=1)
    tot = xla_cumsum(inner[:, -1].contiguous())
    excl = torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device),
                      tot[:-1]])
    return (inner + excl[:, None]).reshape(-1)[:n]


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """f32 sum over the last axis of ``x [..., n]`` in the order of
    ``jnp.sum`` on XLA's CPU backend (a row reduction too): above 32
    items, zero-padded to a multiple of 32 (half the padding in front),
    each window of 32 summed in order, and the window sums reduced the
    same way. Returns ``x.shape[:-1]``."""
    n = x.shape[-1]
    lead = tuple(x.shape[:-1])
    if n <= 32:
        acc = torch.zeros(lead, dtype=x.dtype, device=x.device)
        for j in range(n):
            acc = acc + x[..., j]
        return acc
    padded = -(-n // 32) * 32
    low = (padded - n) // 2
    rows = torch.zeros(lead + (padded,), dtype=x.dtype, device=x.device)
    rows[..., low:low + n] = x
    rows = rows.view(lead + (-1, 32))
    acc = rows[..., 0]
    for j in range(1, 32):
        acc = acc + rows[..., j]
    return xla_sum(acc)


def choice(key: torch.Tensor, n: int, shape: Union[int, Sequence[int]],
           p: torch.Tensor) -> torch.Tensor:
    """int64 draws from ``range(n)`` with probabilities ``p`` (f32
    ``[n]``), with replacement (``jax.random.choice(key, n, shape,
    p=p)``): the left insertion point of ``cum[-1] · (1 - u)`` in
    ``cum = cumsum(p)``."""
    if p.shape != (n,):
        raise ValueError(f"p has shape {tuple(p.shape)}, expected ({n},)")
    cum = xla_cumsum(p.to(device=key.device, dtype=torch.float32))
    r = cum[-1] * (1.0 - uniform(key, shape))
    return torch.searchsorted(cum, r.reshape(-1)).reshape(r.shape)


#: Rounds of the gamma sampler's rejection loop; each lane leaves it
#: with probability above 0.95 per round for ``a >= 1``.
GAMMA_ROUNDS = 64


def gamma(key: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """f32 Gamma(``a``, 1) draws of ``a``'s shape (``jax.random.gamma``).

    Marsaglia–Tsang as ``jax.random``'s ``_gamma_one``, one key per
    element (``split(key, n)`` over the ``n`` elements of each key's
    draw; ``key`` may carry leading axes, which ``a``'s shape starts
    with). Every element's rejection loop runs as a lane of one
    vectorised loop over the lanes still rejecting (gathered by index,
    so each round draws only for them; reading which lanes remain is a
    host read per round). ``a < 1`` is boosted to ``a + 1`` and scaled
    by ``(1 - u)^(1/a)``. Raises if a lane still rejects after
    ``GAMMA_ROUNDS`` rounds."""
    shape = a.shape
    alpha0 = a.reshape(-1).to(device=key.device, dtype=torch.float32)
    lanes = key.numel() // 2
    keys = split(key, alpha0.numel() // lanes).reshape(-1, 2)
    boost = alpha0 >= 1.0
    alpha = torch.where(boost, alpha0, alpha0 + 1.0)
    d = alpha - _f32(1.0 / 3.0)
    c = _f32(1.0 / 3.0) * xla_rsqrt(d)
    ks = split(keys, 2)
    key, subkey = ks[:, 0].contiguous(), ks[:, 1]
    big_v = torch.ones_like(alpha)
    act = torch.arange(alpha.numel(), device=alpha.device)
    for _ in range(GAMMA_ROUNDS):
        k3 = split(key[act], 3)
        key[act] = k3[:, 0]
        xkey, ukey = k3[:, 1].contiguous(), k3[:, 2]
        c_act = c[act]
        x = torch.zeros_like(c_act)
        v = torch.full_like(c_act, -1.0)
        need = torch.arange(act.numel(), device=act.device)
        for _ in range(GAMMA_ROUNDS):
            k2 = split(xkey[need], 2)
            xkey[need] = k2[:, 0]
            xn = normal(k2[:, 1], ())
            x[need] = xn
            v[need] = _fma(xn, c_act[need], 1.0)
            need = need[v[need] <= 0.0]
            if need.numel() == 0:
                break
        xx = x * x
        vv = (v * v) * v
        u = uniform(ukey, ())
        d_act = d[act]
        # x²·0.5 is exact, so the backend's fused form of the right-hand
        # side rounds as this one does.
        reject = (u >= _fma(xx * xx, -_f32(0.0331), 1.0)) & (
            xla_log(u) >= xx * 0.5 + d_act * ((1.0 - vv) + xla_log(vv)))
        big_v[act] = vv
        act = act[reject]
        if act.numel() == 0:
            break
    else:
        raise RuntimeError(f"gamma: a lane still rejects after "
                           f"{GAMMA_ROUNDS} rounds")
    scale = xla_pow(1.0 - uniform(subkey, ()), 1.0 / alpha0)
    return ((d * big_v) * torch.where(boost, 1.0, scale)).reshape(shape)


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
