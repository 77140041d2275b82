"""The baseline sampling systems the paper compares against, §4.1, §5.

Counterpart of the reference's ``core/baselines.py``:

* ``srs`` — Spark's Simple Random Sampling (``sample``): random-sort
  selection with the two-threshold ``(p, q)`` pruning of Meng (ICML'13).
* ``sts`` — Spark's Stratified Sampling (``sampleByKeyExact``): pass 1
  counts each stratum (the synchronisation the paper criticises), pass 2
  random-sorts within each stratum and takes ``⌈fraction · C_i⌉``.

Both samplers return a :class:`WindowSample` (selected mask, per-item HT
weight) over the raw window, so weighted aggregation is shared with
OASRS. Masks and weights are the reference's bit for bit:

* a tie in the sort key goes to the lower index, as ``lax.top_k`` and
  ``lax.sort`` break it (``torch.topk`` promises no order on a tie, so
  both samplers sort stably);
* STS sorts once on the int64 key ``sid << 32 | bits(u)`` (``u`` is
  nonnegative or ``+inf``, so its int32 bits keep its order) and takes
  each group's start from the exclusive cumulative count, not a
  ``cummax`` scan;
* ``k / m`` and ``fraction · C_i`` are f32 operations on f32-exact
  scalars, as the reference's weakly typed Python numbers are.

The per-stratum sums of :func:`sample_stats` run through the stats
kernel (``kernels/ops.stratified_stats``); no float scatter-add, which is
not deterministic on the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import error as err
from repro_torch.kernels import ops
from repro_torch.utils import bincount


@dataclasses.dataclass
class WindowSample:
    """A per-window sample over a raw buffer of ``M`` items."""
    mask: torch.Tensor       # [M] bool — item selected
    weights: torch.Tensor    # [M] f32  — HT weight of each selected item


# ---------------------------------------------------------------------------
# Simple Random Sampling (Spark `sample`) — random sort with (p, q) pruning.
# ---------------------------------------------------------------------------

def srs_sample(key: torch.Tensor, num_items: int, k: int,
               mask: Optional[torch.Tensor] = None,
               gap: float = 2.0) -> WindowSample:
    """Select ``k`` of ``num_items`` by random sort (§4.1.1).

    ScaSRS: draw ``u_j ~ U[0, 1)``; accept ``u <= p`` outright, reject
    ``u > q``, order only the band, with ``p, q = k/m ∓ gap·σ``. The
    clamped keys (sure accepts 0, sure rejects 1, masked-out items
    ``+inf``) are sorted stably and the first ``k`` taken.
    """
    dev = key.device
    if mask is None:
        mask = torch.ones(num_items, dtype=torch.bool, device=dev)
    u = prng.uniform(key, num_items)
    m = torch.clamp(mask.sum(dtype=torch.int32), min=1).to(torch.float32)
    # ``k / m`` as the f32 division of f32(k) (``k / tensor`` in torch
    # multiplies by a reciprocal); filled on the device, not copied.
    k32 = torch.full((), float(np.float32(k)), dtype=torch.float32,
                     device=dev)
    frac = torch.clamp(k32 / m, max=1.0)
    sigma = torch.sqrt((frac * (1.0 - frac) / m).double()).float()
    g = float(np.float32(gap))
    p = torch.clamp(frac - g * sigma, min=0.0)
    q = torch.clamp(frac + g * sigma, max=1.0)
    u_band = torch.where(u <= p, 0.0, torch.where(u > q, 1.0, u))
    u_band = torch.where(mask, u_band, float("inf"))
    kk = min(k, num_items)
    idx = torch.sort(u_band, stable=True).indices[:kk]
    sel = torch.zeros(num_items, dtype=torch.bool, device=dev)
    sel[idx] = True
    sel &= mask
    n_sel = torch.clamp(sel.sum(dtype=torch.int32), min=1).to(torch.float32)
    w = torch.where(sel, m / n_sel, 0.0)
    return WindowSample(mask=sel, weights=w)


# ---------------------------------------------------------------------------
# Stratified Sampling (Spark `sampleByKeyExact`) — 2-pass, synchronizing.
# ---------------------------------------------------------------------------

def sts_counts(stratum_ids: torch.Tensor, num_strata: int,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pass 1: per-stratum counts (int32 ``[S]``). Distributed, this is
    the barrier: every worker counts the window before any may sample."""
    if mask is None:
        return bincount(stratum_ids, num_strata)
    sid = torch.where(mask, stratum_ids, num_strata)
    return bincount(sid, num_strata + 1)[:num_strata]


def sts_sample(key: torch.Tensor, stratum_ids: torch.Tensor,
               global_counts: torch.Tensor, fraction: float,
               mask: Optional[torch.Tensor] = None) -> WindowSample:
    """Pass 2: take exactly ``⌈fraction · C_i⌉`` items of each stratum,
    the first of each stratum in a random sort (``sampleByKeyExact``).
    ``global_counts`` come from :func:`sts_counts`."""
    m = stratum_ids.shape[0]
    s = global_counts.shape[0]
    dev = stratum_ids.device
    if mask is None:
        mask = torch.ones(m, dtype=torch.bool, device=dev)
    gc = global_counts.to(torch.float32)
    targets = torch.ceil(float(np.float32(fraction)) * gc).to(torch.int32)

    u = torch.where(mask, prng.uniform(key, m), float("inf"))
    sid = torch.where(mask, stratum_ids.to(torch.int32), s)
    sort_key = (sid.to(torch.int64) << 32) | u.view(torch.int32).to(
        torch.int64)
    order = torch.sort(sort_key, stable=True).indices
    # Each group's start in sorted order is the count of lower strata.
    per = bincount(sid, s + 1).to(torch.int64)
    start = torch.cumsum(per, 0) - per
    rank_sorted = (torch.arange(m, dtype=torch.int64, device=dev)
                   - start[sid[order].long()])
    rank = torch.empty(m, dtype=torch.int64, device=dev)
    rank[order] = rank_sorted

    clamp_sid = torch.clamp(sid, max=s - 1).long()
    sel = mask & (rank < targets[clamp_sid])
    sel_per = bincount(torch.where(sel, sid, s), s + 1)[:s]
    w_str = gc / torch.clamp(sel_per, min=1).to(torch.float32)
    w = torch.where(sel, w_str[clamp_sid], 0.0)
    return WindowSample(mask=sel, weights=w)


# ---------------------------------------------------------------------------
# Weighted window statistics shared by the SRS/STS paths.
# ---------------------------------------------------------------------------

def srs_stats(values: torch.Tensor, sample: WindowSample) -> err.StratumStats:
    """Stats for SRS error estimation: the whole window is ONE stratum
    (SRS has no stratification, so its honest variance is the
    single-stratum Eq. 6)."""
    sid = torch.zeros(values.shape[0], dtype=torch.int32,
                      device=values.device)
    return sample_stats(values, sid, sample, num_strata=1)


def _f32_running_sum(w: float, n: int) -> float:
    """The f32 running sum ``fl(...fl(fl(0 + w) + w)... + w)`` of ``n``
    copies of the f32 ``w > 0``, in O(binades) steps.

    Inside one binade of the running sum, once a step has been taken
    there, every later step adds the same amount: ``w`` rounded to the
    binade's ulp (a tie rounds the sum to even, and after one such step
    every later sum is even). So the run jumps to the binade's top in one
    step and walks across each boundary one addition at a time.
    """
    def fl(x: float) -> float:
        return float(np.float32(x))
    w, s = fl(w), 0.0
    while n > 0:
        t = fl(s + w)
        if t == s:                  # w is below half the sum's ulp
            break
        same = s > 0.0 and math.frexp(t)[1] == math.frexp(s)[1]
        s, n = t, n - 1
        if not same:
            continue
        d = fl(s + w) - s
        if d == 0.0:
            break
        e = math.frexp(s)[1]        # s in [2**(e-1), 2**e), ulp 2**(e-24)
        top, ulp = 2.0 ** e, 2.0 ** (e - 24)
        j = min(max(int((top - ulp - w - s) // d) + 1, 0), n)
        s, n = s + j * d, n - j
    return s


def sample_stats(values: torch.Tensor, stratum_ids: torch.Tensor,
                 sample: WindowSample, num_strata: int,
                 global_counts: Optional[torch.Tensor] = None
                 ) -> err.StratumStats:
    """Per-stratum stats of a mask-selected sample.

    ``counts`` are the true per-stratum sizes when given (STS knows them
    from pass 1); otherwise the HT estimate ``round(Σ w)`` (SRS does not
    know per-stratum sizes). The reference sums the weights in f32, item
    by item, and that sum drifts from ``Σ w`` (65,535 for a window of
    65,536); the port reproduces it: where a stratum's selected weights
    are one value (always, for SRS), as the closed-form running sum of
    that many copies, read on the host (one device-to-host read); where
    they differ, as an f64 sum.
    """
    sel = sample.mask
    sid = stratum_ids.to(torch.int32)
    _, sums, sumsqs = ops.stratified_stats(
        values.to(torch.float32), sid, sel, num_strata)
    taken = bincount(torch.where(sel, sid, num_strata),
                     num_strata + 1)[:num_strata]
    if global_counts is None:
        strata = torch.arange(num_strata, dtype=torch.int32,
                              device=sid.device)
        inside = sel[None, :] & (sid[None, :] == strata[:, None])
        w = sample.weights.double()[None, :]
        lo = torch.where(inside, w, float("inf")).amin(dim=1)
        hi = torch.where(inside, w, float("-inf")).amax(dim=1)
        total = torch.where(inside, w, 0.0).sum(dim=1)
        host = torch.stack([taken.double(), lo, hi, total]).cpu().tolist()
        est = [_f32_running_sum(a, int(n)) if n > 0 and a == b else t
               for n, a, b, t in zip(*host)]
        global_counts = torch.tensor(
            np.round(np.asarray(est, np.float32)).astype(np.int32),
            device=sid.device)
    return err.StratumStats(counts=global_counts, taken=taken, sums=sums,
                            sumsqs=sumsqs)
