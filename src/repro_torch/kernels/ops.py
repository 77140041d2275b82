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


def _on_cpu(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cpu":
        return True
    if t.is_cuda:
        return False
    raise ValueError(f"{name}: no kernel for device {t.device}")


def reservoir_fold(stratum_ids, payload, u_accept, u_slot, mask, counts,
                   capacity, values) -> torch.Tensor:
    """Fold a chunk into ``values [S, N_max]`` in place; new counts out."""
    if _on_cpu(values, "reservoir_fold"):
        return ref.reservoir_fold(stratum_ids, payload, u_accept, u_slot,
                                  mask, counts, capacity, values)
    return _reservoir.reservoir_fold(stratum_ids, payload, u_accept, u_slot,
                                     mask, counts, capacity, values)


def stratified_stats(values, stratum_ids, mask, num_strata: int):
    """Per-stratum ``(count, Σx, Σx²)`` over masked items, f32 ``[S]``."""
    if _on_cpu(values, "stratified_stats"):
        return ref.stratified_stats(values, stratum_ids, mask, num_strata)
    return _stats.stratified_stats(values, stratum_ids, mask, num_strata)


def one_shot_ingest(times, stratum_ids, payload, mask, u_accept, u_slot,
                    **state) -> ref.OneShotResult:
    """The whole ingest of one chunk, in place on the carried tensors."""
    if _on_cpu(state["values"], "one_shot_ingest"):
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


_WRAPPERS = {"reservoir_fold": _reservoir.reservoir_fold,
             "stratified_stats": _stats.stratified_stats,
             "one_shot_ingest": _one_shot.one_shot_ingest,
             "weighted_hist": _whist.weighted_hist}


def launch_counts() -> dict:
    """Launches of each kernel wrapper since the last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
