"""Dispatch between the CUDA kernels and their plain versions.

The one rule: a tensor on the CPU goes to the plain PyTorch version in
``kernels/ref.py``; a tensor on the card goes to the hand-written kernel,
which launches or raises. There is no fallback from one to the other and
no path that moves data between devices.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import one_shot as _one_shot
from repro_torch.kernels import ref
from repro_torch.kernels import reservoir as _reservoir
from repro_torch.kernels import stratified_stats as _stats
from repro_torch.kernels import weighted_hist as _whist
from repro_torch.utils import tree_flatten


def _on_cpu(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cpu":
        return True
    if t.is_cuda:
        return False
    raise ValueError(f"{name}: no kernel for device {t.device}")


def reservoir_fold(stratum_ids, payload, u_accept, u_slot, mask, counts,
                   capacity, values) -> torch.Tensor:
    """Fold a chunk into ``values [S, N_max, ...]`` in place; new counts
    out. ``payload`` and ``values`` a tensor each or two trees of one
    structure. The call may be batched over W·K folds (``counts [W, K,
    S]``, ``values [W, K, S, N_max, ...]``, ``mask [W, K, M]``, the
    items ``[W, M]``, ``ref.fold_lead``): one call, each fold's result
    its own unbatched call's."""
    leaves = tree_flatten(values)[0]
    if not leaves or _on_cpu(leaves[0], "reservoir_fold"):
        return ref.reservoir_fold(stratum_ids, payload, u_accept, u_slot,
                                  mask, counts, capacity, values)
    return _reservoir.reservoir_fold(stratum_ids, payload, u_accept, u_slot,
                                     mask, counts, capacity, values)


def stratified_stats(values, stratum_ids, mask, num_strata: int):
    """Per-stratum ``(count, Σx, Σx²)`` over masked items, f32 ``[S]``."""
    if _on_cpu(values, "stratified_stats"):
        return ref.stratified_stats(values, stratum_ids, mask, num_strata)
    return _stats.stratified_stats(values, stratum_ids, mask, num_strata)


def stratified_stats_rows(values, mask):
    """Per-row ``(count, Σx, Σx²)`` of a ``[G, N]`` slot view whose
    strata are its rows, f32 ``[G]``; a view is made contiguous first."""
    values, mask = values.contiguous(), mask.contiguous()
    if _on_cpu(values, "stratified_stats_rows"):
        return ref.stratified_stats_rows(values, mask)
    return _stats.stratified_stats_rows(values, mask)


def one_shot_ingest(times, stratum_ids, payload, mask, u_accept, u_slot,
                    **state) -> ref.OneShotResult:
    """The whole ingest of one chunk, in place on the carried tensors;
    ``payload`` and ``values`` a tensor each or two trees of one
    structure. Every tensor may lead with a shard axis ``[W]`` (``times
    [W, M]``): one call for all W shards, each shard's result its own
    unbatched call's."""
    leaves = tree_flatten(state["values"])[0]
    if not leaves or _on_cpu(leaves[0], "one_shot_ingest"):
        return ref.one_shot_ingest(times, stratum_ids, payload, mask,
                                   u_accept, u_slot, **state)
    return _one_shot.one_shot_ingest(times, stratum_ids, payload, mask,
                                     u_accept, u_slot, **state)


def weighted_histogram(values, stratum_ids, weights, mask, edges,
                       num_strata: int):
    """Per-(cell, bin) ``(whist, counts)``, both f32 ``[G, B]``."""
    if _on_cpu(values, "weighted_histogram"):
        return ref.weighted_hist(values, stratum_ids, weights, mask, edges,
                                 num_strata)
    return _whist.weighted_hist(values, stratum_ids, weights, mask, edges,
                                num_strata)


def weighted_histogram_rows(values, row_weights, mask, edges):
    """Per-(row, bin) ``(whist, counts)``, both f32 ``[G, B]``, of a
    ``[G, N]`` slot view whose cells are its rows, row ``g`` weighing
    ``row_weights[g]``; a view is made contiguous first."""
    values, mask = values.contiguous(), mask.contiguous()
    if _on_cpu(values, "weighted_histogram_rows"):
        return ref.weighted_hist_rows(values, row_weights, mask, edges)
    return _whist.weighted_hist_rows(values, row_weights.contiguous(), mask,
                                     edges)


_WRAPPERS = {"reservoir_fold": _reservoir.reservoir_fold,
             "stratified_stats": _stats.stratified_stats,
             "one_shot_ingest": _one_shot.one_shot_ingest,
             "weighted_hist": _whist.weighted_hist}


def launch_counts() -> dict:
    """Launches of each kernel wrapper since the last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def form_counts() -> dict:
    """Launches of each form of every wrapper since the last reset: the
    stats and histogram ``small``, ``row`` and ``parted``, the fold and
    one-shot ``small`` and ``parted``."""
    return {name: dict(fn.forms) for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
        for form in getattr(fn, "forms", ()):
            fn.forms[form] = 0
