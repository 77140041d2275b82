"""Approximate queries over one OASRS state, paper §3.2/§3.3.

Counterpart of the reference's ``core/query.py``. Every linear query is a
weighted (Horvitz–Thompson) estimator built from one per-stratum stats
pass, which on the card is the hand-written stats kernel; histograms,
quantiles, heavy hitters and distinct counts are the nonlinear estimators
of ``core/quantile`` and ``core/sketches``. Every query returns an
:class:`~repro_torch.core.error.Estimate` (``value ± error bound``) or,
for heavy hitters, a :class:`~repro_torch.core.sketches.HeavyHitters`.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import error as err
from repro_torch.core import quantile as qt
from repro_torch.core import sketches as sk
from repro_torch.core.oasrs import OASRSState
from repro_torch.kernels import ops
from repro_torch.utils import bincount

Transform = Callable[[torch.Tensor], torch.Tensor]


def stats(state: OASRSState,
          transform: Optional[Transform] = None) -> err.StratumStats:
    """One stats pass → per-stratum ``(C_i, Y_i, Σx, Σx²)``;
    ``transform`` maps item values first (e.g. a 0/1 predicate)."""
    xs = state.values if transform is None else transform(state.values)
    return err.stratum_stats_from_sample(xs, state.counts, state.taken(),
                                         state.slot_mask())


def query_sum(state: OASRSState) -> err.Estimate:
    """Approximate SUM over the full stream (Eqs. 2, 3, 6)."""
    return err.estimate_sum(stats(state))


def query_mean(state: OASRSState) -> err.Estimate:
    """Approximate MEAN over the full stream (Eqs. 4, 8, 9)."""
    return err.estimate_mean(stats(state))


def query_count(state: OASRSState, predicate: Transform) -> err.Estimate:
    """Approximate COUNT of items satisfying ``predicate``: the SUM of its
    0/1 indicator, so Eq. 6 applies directly."""
    return err.estimate_sum(
        stats(state, transform=lambda x: predicate(x).to(torch.float32)))


def query_histogram(state: OASRSState, edges: torch.Tensor) -> err.Estimate:
    """Per-bin COUNT estimates (one weighted-histogram pass)."""
    return qt.cell_counts(qt.sample_view(state), edges)


def query_quantile(state: OASRSState, qs, **kw) -> err.Estimate:
    """Approximate quantiles with bootstrap bounds
    (:func:`repro_torch.core.quantile.query_quantile`)."""
    return qt.query_quantile(state, qs, **kw)


def query_heavy_hitters(state: OASRSState, k: int) -> sk.HeavyHitters:
    """Approximate top-k heavy hitters (``core/sketches``)."""
    return sk.query_heavy_hitters(state, k)


def query_distinct(state: OASRSState, **kw) -> err.Estimate:
    """Approximate distinct count (``core/sketches``)."""
    return sk.query_distinct(state, **kw)


def query_linear(state: OASRSState, fn: Transform) -> err.Estimate:
    """Generic linear query ``Σ_items fn(x)`` with Eq. 6 bounds."""
    return err.estimate_sum(stats(state, transform=fn))


def group_means(state: OASRSState) -> err.Estimate:
    """Per-stratum MEAN: the sample mean with the single-stratum Eq. 9
    variance."""
    st = stats(state)
    y = torch.clamp(st.taken, min=1).to(torch.float32)
    c = torch.clamp(st.counts, min=1).to(torch.float32)
    var = st.s2() / y * torch.clamp(
        c - st.taken.to(torch.float32), min=0.0) / c
    return err.Estimate(value=st.mean(), variance=var)


def exact_stats(values: torch.Tensor, stratum_ids: torch.Tensor,
                num_strata: int,
                mask: Optional[torch.Tensor] = None) -> err.StratumStats:
    """Ground-truth per-stratum stats of a raw window (native baseline):
    the stats pass over the raw items, counts as integers."""
    if mask is None:
        mask = torch.ones(values.shape, dtype=torch.bool,
                          device=values.device)
    sid = stratum_ids.to(torch.int32)
    _, sums, sumsqs = ops.stratified_stats(values.to(torch.float32), sid,
                                           mask, num_strata)
    counts = bincount(torch.where(mask, sid, num_strata), num_strata + 1)
    return err.StratumStats(counts=counts[:num_strata],
                            taken=counts[:num_strata], sums=sums,
                            sumsqs=sumsqs)
