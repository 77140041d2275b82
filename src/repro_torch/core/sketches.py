"""Nonlinear approximate queries II: heavy hitters and distinct counts.

Counterpart of the reference's ``core/sketches.py``, on the
:class:`~repro_torch.core.quantile.SampleView` projection:

* **Heavy hitters / top-k** — candidate generation by one stable sort of
  the slot buffer and a segment sum of HT weights (the ``k`` heaviest
  distinct values), then per-key COUNT estimates with Eq. 6 variances
  (:func:`key_counts`). The segments are contiguous after the sort, so
  their sums come from a segmented fixed-order scan, never from a float
  scatter-add (on the card that sums in atomic order and could reorder
  near-tied candidates from run to run). Ties in weight keep the lower
  segment first, as ``jax.lax.top_k`` does: a stable descending sort.
* **Distinct count** — bias-corrected Chao1 on the sampled frequency
  spectrum, with a stratified-bootstrap variance.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import prng
from repro_torch.core import error as err
from repro_torch.core import quantile as qt
from repro_torch.core.oasrs import OASRSState

_BIG = qt._BIG


@dataclasses.dataclass
class HeavyHitters:
    """Top-k result: ``keys [k]`` candidate values (``+BIG`` padding when
    the sample holds fewer than ``k`` distinct keys), their Eq. 6-bounded
    stream frequencies, and ``sample_weight [k]`` (the HT mass ranked)."""
    keys: torch.Tensor
    estimate: err.Estimate
    sample_weight: torch.Tensor


def _view(source) -> qt.SampleView:
    if isinstance(source, OASRSState):
        return qt.sample_view(source)
    return source


def _segments(x: torch.Tensor, valid: torch.Tensor):
    """Sort-based distinct-value segmentation of a flat slot buffer.

    Returns ``(order, seg, seg_keys)``: the stable sort permutation, the
    dense int64 segment id of every sorted slot, and ``seg_keys[j]``,
    segment ``j``'s value (``+BIG`` for unused ids and for the segment of
    dead slots).
    """
    m = x.shape[0]
    xk = torch.where(valid, x, _BIG)
    order = torch.argsort(xk, stable=True)
    xs = xk[order]
    is_start = torch.ones(m, dtype=torch.bool, device=x.device)
    is_start[1:] = xs[1:] != xs[:-1]
    seg = torch.cumsum(is_start, dim=0) - 1
    seg_keys = torch.full((m,), _BIG, dtype=torch.float32, device=x.device)
    seg_keys.scatter_reduce_(0, seg, xs.to(torch.float32), "amin")
    return order, seg, seg_keys


def _segment_sums(ws: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """``out[j]`` = sum of ``ws`` over segment ``j`` (``[M]``, 0 where
    unused), from the segmented scan's value at each segment's end."""
    m = ws.shape[0]
    scan = qt.fixed_order_cumsum(ws, seg)
    is_end = torch.ones(m, dtype=torch.bool, device=ws.device)
    is_end[:-1] = seg[1:] != seg[:-1]
    out = torch.zeros(m + 1, dtype=ws.dtype, device=ws.device)
    out.scatter_reduce_(0, torch.where(is_end, seg, m), scan, "amax",
                        include_self=False)
    return out[:m]


def query_heavy_hitters(source, k: int) -> HeavyHitters:
    """Approximate top-k heaviest keys with Eq. 6 frequency bounds."""
    view = _view(source)
    x, w, valid, _ = view.flat()
    order, seg, seg_keys = _segments(x, valid)
    seg_w = _segment_sums(torch.where(valid, w, 0.0)[order], seg)
    ranked, idx = torch.sort(seg_w, descending=True, stable=True)
    keys = seg_keys[idx[:k]]
    return HeavyHitters(keys=keys, estimate=key_counts(view, keys),
                        sample_weight=ranked[:k])


def key_counts(view: qt.SampleView, keys: torch.Tensor) -> err.Estimate:
    """Linear per-key COUNT estimates for a fixed candidate vector: the
    sampled matches per cell × key ``n_gk`` (counted as integers) feed the
    vectorized Eq. 6 machinery."""
    match = view.values[:, :, None] == keys[None, None, :]
    match &= view.slot_mask()[:, :, None]
    n_gk = torch.sum(match, dim=1, dtype=torch.int32).to(torch.float32)
    return err.estimate_counts(n_gk, view.counts, view.taken)


# ---------------------------------------------------------------------------
# Distinct count.
# ---------------------------------------------------------------------------

def _chao1(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Bias-corrected Chao1 on the sampled frequency spectrum."""
    order, seg, _ = _segments(x, valid)
    # Dead slots all land in the +BIG segment but add 0 to its frequency.
    freq = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
    freq.index_add_(0, seg, valid[order].to(torch.int32))
    d = torch.sum(freq > 0, dtype=torch.int32).to(torch.float32)
    f1 = torch.sum(freq == 1, dtype=torch.int32).to(torch.float32)
    f2 = torch.sum(freq == 2, dtype=torch.int32).to(torch.float32)
    return d + f1 * (f1 - 1.0) / (2.0 * (f2 + 1.0))


def query_distinct(source, num_replicates: int = 64,
                   key: Optional[torch.Tensor] = None) -> err.Estimate:
    """Approximate distinct count: Chao1 on the pooled sample (a lower
    bound on the stream's distinct count), with the stratified-bootstrap
    replicate variance."""
    if isinstance(source, OASRSState) and key is None:
        key = prng.fold_in(source.key, 0xD157)
    view = _view(source)
    if key is None and num_replicates > 0:
        raise ValueError("pass key= when querying a bare SampleView")
    valid = view.slot_mask().reshape(-1)
    value = _chao1(view.values.reshape(-1), valid)
    if num_replicates > 0:
        keys = prng.split(key, num_replicates)
        reps = torch.stack([
            _chao1(qt.bootstrap_resample(view, keys[r]).reshape(-1), valid)
            for r in range(num_replicates)])
        variance = torch.var(reps, correction=1)
    else:
        variance = torch.zeros((), dtype=torch.float32, device=value.device)
    return err.Estimate(value=value, variance=variance)
