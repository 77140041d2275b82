"""Shared small utilities: device choice, ranking, counting, key labels,
and the one walker of payload trees."""
from __future__ import annotations

from typing import Any, Callable, Optional, Union

import torch

from repro_torch import prng

DeviceLike = Optional[Union[str, torch.device]]


class NoCudaDeviceError(RuntimeError):
    """An entry point was asked for the card (the default) and none is
    present. Pass ``device="cpu"`` to run on the CPU on purpose."""


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDeviceError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev


def rank_within_stratum(stratum_ids: torch.Tensor) -> torch.Tensor:
    """``r[j]`` = number of ``k < j`` with ``stratum_ids[k] == stratum_ids[j]``.

    Stable sort, then each item's position minus the start of its group
    (the group's first position in the sorted ids, by ``searchsorted``:
    ``torch.cummax`` is a one-block scan on the card), scattered back to
    item order. int32 out, like the reference.
    """
    m = stratum_ids.shape[0]
    order = torch.argsort(stratum_ids, stable=True)
    sorted_ids = stratum_ids[order].contiguous()
    idx = torch.arange(m, dtype=torch.int64, device=stratum_ids.device)
    group_start = torch.searchsorted(sorted_ids, sorted_ids)
    rank = torch.empty(m, dtype=torch.int32, device=stratum_ids.device)
    rank[order] = (idx - group_start).to(torch.int32)
    return rank


def bincount(stratum_ids: torch.Tensor, num_strata: int) -> torch.Tensor:
    """Fixed-length int32 bincount. ``torch.bincount`` reads the largest
    id back to the host on CUDA; a scatter-add never leaves the device."""
    out = torch.zeros(num_strata, dtype=torch.int32,
                      device=stratum_ids.device)
    ones = torch.ones_like(stratum_ids, dtype=torch.int32)
    return out.index_add_(0, stratum_ids.long(), ones)


def fold_in_str(key: torch.Tensor, label: str) -> torch.Tensor:
    """Deterministically fold a string label into a PRNG key."""
    h = 0
    for ch in label:
        h = (h * 131 + ord(ch)) % (2**31 - 1)
    return prng.fold_in(key, h)


def tree_flatten(tree) -> tuple:
    """The leaves of a tree and its structure, as
    ``jax.tree_util.tree_flatten`` takes them: dict keys sorted, tuple
    and list items in order, anything else a leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
        kind = ("dict", tuple(keys))
    elif isinstance(tree, (tuple, list)):
        parts = [tree_flatten(v) for v in tree]
        kind = (type(tree).__name__, len(tree))
    else:
        return [tree], "*"
    return ([leaf for p in parts for leaf in p[0]],
            (kind, tuple(p[1] for p in parts)))


def tree_unflatten(structure, leaves) -> Any:
    """The tree of ``structure`` (from :func:`tree_flatten`) holding
    ``leaves`` in their flattened order."""
    it = iter(leaves)

    def build(st):
        if st == "*":
            return next(it)
        (kind, arg), subs = st
        items = [build(sub) for sub in subs]
        if kind == "dict":
            return dict(zip(arg, items))
        return tuple(items) if kind == "tuple" else list(items)
    return build(structure)


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of each tree of ``rest`` at
    the same place; a tree of another structure raises ``ValueError``, as
    ``jax.tree.map`` does."""
    leaves, structure = tree_flatten(tree)
    others = []
    for other in rest:
        o_leaves, o_structure = tree_flatten(other)
        if o_structure != structure:
            raise ValueError(f"tree structure {o_structure} != "
                             f"{structure}")
        others.append(o_leaves)
    return tree_unflatten(structure,
                          [fn(*xs) for xs in zip(leaves, *others)])
