"""Error estimation for approximate linear queries, paper §3.3 (Eqs. 5-9).

Counterpart of the reference's ``core/error.py``. Everything reads the
per-stratum summary :class:`StratumStats`; on the card that summary comes
from the hand-written stats kernel (``kernels/stratified_stats``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.prng import _fma
from repro_torch.utils import rank_within_stratum

#: z multipliers of the paper's "68-95-99.7" rule.
Z_FOR_CONFIDENCE = {0.68: 1.0, 0.95: 2.0, 0.997: 3.0}


@dataclasses.dataclass
class Estimate:
    """An approximate query result ``value ± error`` (Algorithm 2)."""
    value: torch.Tensor
    variance: torch.Tensor

    def error_bound(self, confidence: float = 0.95) -> torch.Tensor:
        z = Z_FOR_CONFIDENCE.get(confidence)
        if z is None:
            raise ValueError(
                f"confidence must be one of {sorted(Z_FOR_CONFIDENCE)} "
                "(the paper's 68-95-99.7 rule)")
        return z * torch.sqrt(torch.clamp(self.variance, min=0.0))

    def interval(self, confidence: float = 0.95):
        e = self.error_bound(confidence)
        return self.value - e, self.value + e


@dataclasses.dataclass
class StratumStats:
    """Per-stratum sufficient statistics of the sampled items.

    ``counts`` is ``C_i`` (arrivals, int32), ``taken`` is ``Y_i`` (sample
    size, int32), ``sums``/``sumsqs`` the f32 moments of the samples.
    """
    counts: torch.Tensor
    taken: torch.Tensor
    sums: torch.Tensor
    sumsqs: torch.Tensor

    def mean(self) -> torch.Tensor:
        """Per-stratum sample mean (Eq. 7), 0 where ``Y_i = 0``."""
        y = torch.clamp(self.taken, min=1).to(torch.float32)
        return torch.where(self.taken > 0, self.sums / y, 0.0)

    def s2(self) -> torch.Tensor:
        """Unbiased per-stratum sample variance (Eq. 7), 0 where Y_i < 2."""
        y = self.taken.to(torch.float32)
        mean = self.mean()
        # The reference's compiled emission fuses the subtraction and the
        # last product into one multiply-add.
        ss = _fma(y * mean, -mean, self.sumsqs)
        return torch.where(self.taken > 1,
                           torch.clamp(ss, min=0.0)
                           / torch.clamp(y - 1.0, min=1.0),
                           0.0)


def stratum_stats_from_sample(xs: torch.Tensor, counts: torch.Tensor,
                              taken: torch.Tensor,
                              slot_mask: torch.Tensor) -> StratumStats:
    """:class:`StratumStats` of reservoir contents ``xs [G, N]``.

    One stats pass over the ``[G, N]`` view, each row a stratum and the
    slot mask the item mask (``ops.stratified_stats_rows``): the
    hand-written kernel on the card, its plain version on the CPU.
    """
    _, sums, sumsqs = ops.stratified_stats_rows(xs.to(torch.float32),
                                                slot_mask)
    return StratumStats(counts=counts, taken=taken, sums=sums,
                        sumsqs=sumsqs)


def var_sum(stats: StratumStats) -> torch.Tensor:
    """Eq. 6: ``Var(SUM) = Σ_i C_i (C_i − Y_i) s_i² / Y_i``."""
    c = stats.counts.to(torch.float32)
    y = torch.clamp(stats.taken, min=1).to(torch.float32)
    per = c * torch.clamp(c - y, min=0.0) * stats.s2() / y
    return torch.sum(per)


def var_mean(stats: StratumStats) -> torch.Tensor:
    """Eq. 9: ``Var(MEAN) = Σ_i ω_i² (s_i²/Y_i) (C_i−Y_i)/C_i``."""
    c = stats.counts.to(torch.float32)
    total = torch.clamp(torch.sum(c), min=1.0)
    omega = c / total
    y = torch.clamp(stats.taken, min=1).to(torch.float32)
    fpc = torch.where(c > 0, torch.clamp(c - y, min=0.0)
                      / torch.clamp(c, min=1.0), 0.0)
    per = omega * omega * stats.s2() / y * fpc
    return torch.sum(per)


def estimate_sum(stats: StratumStats) -> Estimate:
    """Eqs. 2-3: ``SUM = Σ_i W_i Σ_j I_ij`` with Eq. 6 variance."""
    c = stats.counts.to(torch.float32)
    n = torch.clamp(stats.taken, min=1).to(torch.float32)
    w = torch.where(stats.counts > stats.taken, c / n, 1.0)
    return Estimate(value=torch.sum(w * stats.sums), variance=var_sum(stats))


def estimate_mean(stats: StratumStats) -> Estimate:
    """Eq. 4 / Eq. 8 with Eq. 9 variance."""
    total = torch.clamp(torch.sum(stats.counts, dtype=torch.int32),
                        min=1).to(torch.float32)
    return Estimate(value=estimate_sum(stats).value / total,
                    variance=var_mean(stats))


def estimate_counts(n: torch.Tensor, counts: torch.Tensor,
                    taken: torch.Tensor) -> Estimate:
    """Vectorized per-cell COUNT estimates (Eqs. 2-3, 6 on indicators).

    ``n [S, B]`` is the number of sampled items of stratum ``s`` falling
    in cell ``b`` (a histogram bin, a candidate key, ...). Each cell is a
    linear query on its 0/1 indicator, whose per-stratum moments are
    ``sums = sumsqs = n``; returns ``[B]`` values and Eq. 6 variances.
    """
    n = n.to(torch.float32)
    c = counts.to(torch.float32)[:, None]
    y = torch.clamp(taken, min=1).to(torch.float32)[:, None]
    w = torch.where(counts[:, None] > taken[:, None], c / y, 1.0)
    value = torch.sum(w * n, dim=0)
    # Indicator variance: ss = Σ1² − Y·mean² = n − n²/Y (Eq. 7 on 0/1s).
    ss = torch.clamp(n - n * n / y, min=0.0)
    s2 = torch.where(taken[:, None] > 1, ss / torch.clamp(y - 1.0, min=1.0),
                     0.0)
    per = c * torch.clamp(c - y, min=0.0) * s2 / y
    return Estimate(value=value, variance=torch.sum(per, dim=0))


def _group_sum(x: torch.Tensor, group_ids: torch.Tensor,
               num_groups: int) -> torch.Tensor:
    """``out[g] = Σ x[i]`` over ``group_ids[i] == g``, ``[num_groups]``.

    The reference's scatter-add order: each group's items added one by
    one in index order. Every item is placed at (its group, its rank in
    the group) of a ``[num_groups, G]`` table, whose columns are then
    added in turn (the zeros past a group's end change nothing); a fixed
    order on every device, where a float scatter-add on the card would
    sum in atomic order. Nothing is read back to the host.
    """
    g = x.shape[0]
    table = torch.zeros((num_groups, g), dtype=x.dtype, device=x.device)
    table[group_ids.long(), rank_within_stratum(group_ids).long()] = x
    out = torch.zeros(num_groups, dtype=x.dtype, device=x.device)
    for j in range(g):
        out = out + table[:, j]
    return out


def estimate_sum_grouped(stats: StratumStats, group_ids: torch.Tensor,
                         num_groups: int) -> Estimate:
    """Per-group SUM estimates (Eqs. 2-3, 6) over a partition of cells.

    ``group_ids [G]`` assigns each cell to one of ``num_groups`` disjoint
    windows (e.g. the per-key windows: cells grouped by stratum key);
    each group is its own stratified estimate. Returns ``[num_groups]``.
    """
    c = stats.counts.to(torch.float32)
    y = torch.clamp(stats.taken, min=1).to(torch.float32)
    w = torch.where(stats.counts > stats.taken, c / y, 1.0)
    per_var = c * torch.clamp(c - y, min=0.0) * stats.s2() / y
    return Estimate(value=_group_sum(w * stats.sums, group_ids, num_groups),
                    variance=_group_sum(per_var, group_ids, num_groups))


def estimate_mean_grouped(stats: StratumStats, group_ids: torch.Tensor,
                          num_groups: int) -> Estimate:
    """Per-group MEAN estimates (Eq. 4 / Eq. 8 with Eq. 9 variance).

    The weights ``ω_i = C_i / C_group`` are normalized within each group,
    so each entry equals :func:`estimate_mean` on that group's cells
    alone. Groups with no arrivals report 0 ± 0.
    """
    c = stats.counts.to(torch.float32)
    tot = torch.clamp(_group_sum(c, group_ids, num_groups), min=1.0)
    omega = c / tot[group_ids.long()]
    y = torch.clamp(stats.taken, min=1).to(torch.float32)
    w = torch.where(stats.counts > stats.taken, c / y, 1.0)
    value = _group_sum(w * stats.sums, group_ids, num_groups) / tot
    fpc = torch.where(c > 0, torch.clamp(c - y, min=0.0)
                      / torch.clamp(c, min=1.0), 0.0)
    per = omega * omega * stats.s2() / y * fpc
    return Estimate(value=value,
                    variance=_group_sum(per, group_ids, num_groups))


def merge_stats(*stats: StratumStats) -> StratumStats:
    """Concatenate independent stratum summaries (Eq. 5: variances add)."""
    return StratumStats(
        counts=torch.cat([s.counts for s in stats]),
        taken=torch.cat([s.taken for s in stats]),
        sums=torch.cat([s.sums for s in stats]),
        sumsqs=torch.cat([s.sumsqs for s in stats]))


def required_sample_size_mean(counts: torch.Tensor, s2: torch.Tensor,
                              target_half_width: torch.Tensor,
                              z: torch.Tensor, min_per_stratum: int = 8,
                              max_per_stratum: Optional[int] = None,
                              ) -> torch.Tensor:
    """Neyman allocation solving Eq. 9 for a target CI half-width on MEAN.

    ``target_half_width`` and ``z`` are f32 0-dim tensors, so every step
    rounds in f32 as the reference's does. ``[W, S]`` counts allocate
    each row on its own (one controller per shard).
    """
    c = counts.to(torch.float32)
    total = torch.clamp(torch.sum(c, dim=-1, keepdim=True), min=1.0)
    s = torch.sqrt(torch.clamp(s2, min=0.0))
    v = target_half_width / z
    v_target = v * v
    omega = c / total
    a = torch.sum(omega * s, dim=-1, keepdim=True)
    b = torch.sum(omega * omega * s2 / torch.clamp(c, min=1.0), dim=-1,
                  keepdim=True)
    n_total = (a * a) / torch.clamp(v_target + b, min=1e-20)
    alloc = n_total * torch.where(a > 0, omega * s / torch.clamp(a, min=1e-20),
                                  1.0 / counts.shape[-1])
    alloc = torch.ceil(alloc).to(torch.int32)
    alloc = torch.clamp(alloc, min=min_per_stratum)
    alloc = torch.minimum(alloc, torch.clamp(counts, min=min_per_stratum))
    if max_per_stratum is not None:
        alloc = torch.clamp(alloc, max=max_per_stratum)
    return alloc
