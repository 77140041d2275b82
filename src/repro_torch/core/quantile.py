"""Nonlinear approximate queries I: weighted quantiles over OASRS samples.

Counterpart of the reference's ``core/quantile.py``:

* **Point estimate** — the generalized inverse of the HT-weighted
  empirical CDF, by one of two schemes: ``weighted_quantile`` (one stable
  sort of the slot buffer, then a search of the cumulative weights) or
  ``quantile_refine`` (R rounds of B-bin weighted histograms that narrow
  the bracket B-fold per round, then interpolation inside the last bin;
  on the card each histogram is the hand-written ``weighted_hist``
  kernel).
* **Error bounds** — a stratified bootstrap: slots are resampled with
  replacement within each cell from the port's threefry ``randint``, bit
  for bit the reference's draws; replicate ``r`` uses ``split(key, R)[r]``
  as ``jax.vmap`` over ``jax.random.split`` does. Replicates run one after
  another, so one ``[G, N]`` replicate is alive at a time.

Every cumulative sum here is :func:`fixed_order_cumsum`, a fixed-shape
tree scan: ``torch.cumsum`` of floats on the card sums in an order that
may change from run to run, and a search over its output would then pick
another slot or bin. A tree scan is not monotone to the last ulp, so the
searches count the prefix sums below each target (:func:`_search`)
instead of bisecting them. The reference's ``jnp.cumsum`` is a different
tree again, so the two may pick neighbouring slots where a target falls
within rounding of a cumulative weight (the parity tests say so). No
value is read back to the host: brackets, targets and masses stay on the
device across rounds.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import prng
from repro_torch.core import error as err
from repro_torch.core.oasrs import OASRSState
from repro_torch.kernels import ops

_BIG = 3.0e38   # +inf stand-in that survives float32 arithmetic


@dataclasses.dataclass
class SampleView:
    """``G`` independently sampled cells: ``values [G, N]`` f32 slot
    payloads, ``counts [G]`` int32 arrivals ``C_g``, ``taken [G]`` int32
    live sample sizes ``Y_g`` (slots ``>= Y_g`` are dead)."""
    values: torch.Tensor
    counts: torch.Tensor
    taken: torch.Tensor

    def weights(self) -> torch.Tensor:
        """Per-cell HT weight ``W_g`` (Eq. 1)."""
        c = self.counts.to(torch.float32)
        y = torch.clamp(self.taken, min=1).to(torch.float32)
        return torch.where(self.counts > self.taken, c / y, 1.0)

    def slot_mask(self) -> torch.Tensor:
        slots = torch.arange(self.values.shape[1], dtype=torch.int32,
                             device=self.values.device)
        return slots[None, :] < self.taken[:, None]

    def flat(self):
        """``(x, w, valid, cell_ids)`` flattened over all slots."""
        g, n = self.values.shape
        x = self.values.reshape(-1)
        w = self.weights()[:, None].expand(g, n).reshape(-1)
        valid = self.slot_mask().reshape(-1)
        gid = torch.arange(g, dtype=torch.int32, device=x.device)
        return x, w, valid, gid[:, None].expand(g, n).reshape(-1)


def sample_view(state: OASRSState) -> SampleView:
    """Project one OASRS state onto its weighted sample."""
    return SampleView(values=state.values.to(torch.float32),
                      counts=state.counts, taken=state.taken())


def _levels(qs, device) -> torch.Tensor:
    return torch.as_tensor(qs, dtype=torch.float32,
                           device=device).reshape(-1)


def fixed_order_cumsum(x: torch.Tensor,
                       seg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inclusive prefix sums of ``x [M]`` by a Hillis-Steele scan.

    ``ceil(log2 M)`` elementwise passes of one fixed shape: the same bits
    on every run and device, and tree-shaped rounding. With ``seg`` (a
    non-decreasing segment id per element) the scan restarts at every
    segment, so each segment's last element holds the segment's sum.
    Neighbouring outputs come from different trees, so even over
    non-negative inputs they may dip by an ulp (:func:`_search` does not
    mind).
    """
    y, n, d = x, x.shape[0], 1
    while d < n:
        add = y[:-d]
        if seg is not None:
            add = torch.where(seg[d:] == seg[:-d], add, 0)
        y = torch.cat([y[:d], y[d:] + add])
        d *= 2
    return y


def _search(cum: torch.Tensor, targets: torch.Tensor,
            valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[Q]`` index of each target among prefix sums ``cum``: how many
    (``valid``) entries lie below it. For non-decreasing ``cum`` this is
    ``searchsorted(side="left")``; for a tree scan's ulp dips it still
    lands where the sums cross the target, and it never counts past the
    last valid entry at a target equal to its prefix. One pass per level,
    in integers: the same on every run."""
    below = cum[None, :] < targets[:, None]
    if valid is not None:
        below &= valid[None, :]
    return torch.sum(below, dim=1)


# ---------------------------------------------------------------------------
# Point estimators.
# ---------------------------------------------------------------------------

def weighted_quantile(x: torch.Tensor, w: torch.Tensor, valid: torch.Tensor,
                      qs) -> torch.Tensor:
    """Sorted-cumulative-weight inverse of the weighted empirical CDF.

    ``x, w, valid`` are flat slot buffers; ``qs [Q]`` in ``(0, 1]``.
    Returns the ``[Q]`` sample quantiles.
    """
    qs = _levels(qs, x.device)
    xk = torch.where(valid, x, _BIG)
    order = torch.argsort(xk, stable=True)
    xs = xk[order]
    live = valid[order]
    cw = fixed_order_cumsum(torch.where(live, w[order], 0.0))
    # The total at the last VALID slot: the dead slots sorted after it add
    # zeros, which in a tree scan can still round the running sum, and
    # q = 1 must not land on them.
    last = torch.clamp(torch.sum(valid, dtype=torch.int64) - 1, min=0)
    total = torch.clamp(cw[last], min=1e-20)
    idx = _search(cw, qs * total, live)
    return xs[torch.clamp(idx, 0, xs.shape[0] - 1)]


def _unit_edges(num_bins: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, B + 1)`` in f32: ``i / B``, then 1."""
    steps = torch.arange(num_bins, dtype=torch.float32, device=device)
    return torch.cat([steps / num_bins,
                      torch.ones(1, dtype=torch.float32, device=device)])


def quantile_refine(view: SampleView, qs, num_bins: int = 32,
                    num_steps: int = 4) -> torch.Tensor:
    """Sort-free histogram-refinement quantile estimator.

    Per round, one weighted histogram of the whole slot buffer over the
    current bracket (``ops.weighted_histogram``: the kernel on the card)
    finds the bin holding the target cumulative weight, and the bracket
    narrows to it. The carried ``below`` mass keeps ``below = Ŵ{x < lo}``,
    so the only approximation is the last within-bin interpolation.
    ``Q · num_steps`` histograms in all.
    """
    x, w, valid, gid = view.flat()
    qs = _levels(qs, x.device)
    total = torch.sum(torch.where(valid, w, 0.0))
    lo0 = torch.min(torch.where(valid, x, _BIG)).reshape(1)
    hi0 = torch.max(torch.where(valid, x, -_BIG)).reshape(1)
    unit = _unit_edges(num_bins, x.device)
    out = []
    for i in range(qs.shape[0]):
        target = (qs[i] * total).reshape(1)
        lo, hi = lo0, hi0
        below = torch.zeros(1, dtype=torch.float32, device=x.device)
        for _ in range(num_steps):
            edges = lo + torch.clamp(hi - lo, min=1e-20) * unit
            whist, _ = ops.weighted_histogram(x, gid, w, valid, edges,
                                              view.values.shape[0])
            h = torch.sum(whist, dim=0)
            cum = below + fixed_order_cumsum(h)
            b = torch.clamp(_search(cum, target), 0, num_bins - 1)
            prev = cum[torch.clamp(b - 1, min=0)]
            below = below + torch.where(b > 0, prev - below, 0.0)
            lo, hi, mass = edges[b], edges[b + 1], h[b]
        frac = (target - below) / torch.clamp(mass, min=1e-20)
        out.append(torch.clamp(lo + torch.clamp(frac, 0.0, 1.0) * (hi - lo),
                               lo0, hi0))
    return torch.cat(out)


def cell_counts(view: SampleView, edges: torch.Tensor) -> err.Estimate:
    """Per-bin COUNT estimates of a weighted sample (Eq. 6 per bin): one
    ``ops.weighted_histogram`` pass of the slot counts, then
    :func:`~repro_torch.core.error.estimate_counts`."""
    x, _, valid, gid = view.flat()
    _, n_gb = ops.weighted_histogram(x, gid, torch.ones_like(x), valid,
                                     edges, view.values.shape[0])
    return err.estimate_counts(n_gb, view.counts, view.taken)


def invert_weighted_cdf(hist: torch.Tensor, edges: torch.Tensor,
                        below: torch.Tensor,
                        targets: torch.Tensor) -> torch.Tensor:
    """Invert a binned weighted CDF with within-bin interpolation.

    ``hist [B]`` is the weighted mass per bin of ``edges [B+1]``,
    ``below`` the mass strictly left of ``edges[0]``, ``targets [Q]``
    absolute cumulative-weight targets.
    """
    targets = targets.reshape(-1)
    cum = below + fixed_order_cumsum(hist)
    b = torch.clamp(_search(cum, targets), 0, hist.shape[0] - 1)
    prev = torch.where(b > 0, cum[torch.clamp(b - 1, min=0)], below)
    frac = torch.clamp((targets - prev) / torch.clamp(hist[b], min=1e-20),
                       0.0, 1.0)
    return edges[b] + frac * (edges[b + 1] - edges[b])


# ---------------------------------------------------------------------------
# Stratified bootstrap.
# ---------------------------------------------------------------------------

def bootstrap_resample(view: SampleView, key: torch.Tensor) -> torch.Tensor:
    """One bootstrap replicate: slots resampled within each cell, ``[G, N]``
    (counts, taken and weights are the replicate's design constants)."""
    g, n = view.values.shape
    idx = prng.randint(key, (g, n), 0,
                       torch.clamp(view.taken, min=1)[:, None])
    return torch.gather(view.values, 1, idx.long())


def bootstrap_quantiles(view: SampleView, qs, num_replicates: int,
                        key: torch.Tensor) -> torch.Tensor:
    """``[R, Q]`` bootstrap replicates of the weighted quantiles."""
    _, w, valid, _ = view.flat()
    keys = prng.split(key, num_replicates)
    return torch.stack([
        weighted_quantile(bootstrap_resample(view, keys[r]).reshape(-1), w,
                          valid, qs)
        for r in range(num_replicates)])


# ---------------------------------------------------------------------------
# Public query.
# ---------------------------------------------------------------------------

def query_quantile(source, qs, method: str = "sort", num_bins: int = 32,
                   num_steps: int = 4, num_replicates: int = 64,
                   key: Optional[torch.Tensor] = None) -> err.Estimate:
    """Approximate stream quantiles with bootstrap error bounds.

    ``source`` is an :class:`OASRSState` (the key then defaults to a fold
    of its key) or a :class:`SampleView` (pass ``key=``). ``method`` is
    ``"sort"`` or ``"hist"``; ``num_replicates=0`` reports zero variance.
    Returns ``value [Q]`` and the bootstrap ``variance [Q]``.
    """
    if isinstance(source, OASRSState):
        if key is None:
            key = prng.fold_in(source.key, 0x51A17)
        view = sample_view(source)
    else:
        view = source
        if key is None and num_replicates > 0:
            raise ValueError("pass key= when querying a bare SampleView")
    if method == "sort":
        x, w, valid, _ = view.flat()
        value = weighted_quantile(x, w, valid, qs)
    elif method == "hist":
        value = quantile_refine(view, qs, num_bins=num_bins,
                                num_steps=num_steps)
    else:
        raise ValueError(f"unknown method {method!r}")
    if num_replicates > 0:
        reps = bootstrap_quantiles(view, qs, num_replicates, key)
        variance = torch.var(reps, dim=0, correction=1)
    else:
        variance = torch.zeros_like(value)
    return err.Estimate(value=value, variance=variance)
