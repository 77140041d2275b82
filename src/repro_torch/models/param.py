"""Parameter skeletons: one definition for init, counting and carry-over.

Counterpart of the reference's ``models/param.py``. A model's
``skeleton(cfg)`` is a nested dict of :class:`ParamSpec`; from it
:func:`init_params` materialises the reference's weights bit for bit for
the same key, :func:`count_params` / :func:`param_bytes` size it, and
:func:`params_from_reference` / :func:`params_to_reference` carry weights
between the packages. A params tree is a tree of dicts and lists of
tensors whose paths are the reference's tree paths
(``dense_layers.attn.wq``, ``blocks.3.w_up``), with the reference's
stacked ``[L, ...]`` layouts and its per-block lists (the ssm and hybrid
families hold ``blocks`` as a list of dicts of different structure).

For the dry-run, :func:`abstract_params` gives ``meta`` tensors of the
skeleton's shapes and dtypes (nothing allocated), :func:`param_specs`
the reference's ``PartitionSpec`` per leaf (as tuples) and
:func:`param_shardings` a ``NamedSharding`` per leaf on a
``DeviceMesh``, the counterparts of the reference's functions of the
same names.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.distributed import sharding as shd
from repro_torch.utils import DeviceLike, resolve_device

#: Elements drawn per slice of one leaf's normals: a slice's temporaries
#: (int64 counters and hash words, f64 multiply-adds) stay near 1 GiB
#: whatever the leaf's size.
INIT_SLICE = 1 << 24


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    logical: tuple                    # logical axis name per dim
    dtype: Any = torch.float32
    init: str = "fan_in"              # fan_in | normal | zeros | ones
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(
                f"shape {self.shape} / logical {self.logical} rank mismatch")


def _children(tree) -> Iterator[Tuple[Any, Any]]:
    """``(key, child)`` of a dict (keys sorted, as ``jax.tree_util``
    sorts them) or a list (by index)."""
    if isinstance(tree, dict):
        return ((k, tree[k]) for k in sorted(tree))
    return enumerate(tree)


def leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` of a tree of dicts and lists in the reference's
    flattening order: dict keys sorted, list items by index. A list item's
    path part is its index (``blocks.10.ln.scale``), walked as a number:
    block 10 comes after block 2."""
    for k, v in _children(tree):
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, (dict, list)):
            yield from leaves(v, path)
        else:
            yield path, v


def map_tree(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """A tree of ``fn(path, leaf)`` with ``tree``'s structure (its dicts
    and lists, the dicts' key order kept)."""
    def one(k, v):
        path = f"{prefix}.{k}" if prefix else str(k)
        return (map_tree(fn, v, path) if isinstance(v, (dict, list))
                else fn(path, v))
    if isinstance(tree, list):
        return [one(i, v) for i, v in enumerate(tree)]
    return {k: one(k, v) for k, v in tree.items()}


def abstract_params(skeleton: dict, device="meta") -> dict:
    """Tensors of the skeleton's shapes and dtypes on ``device`` (``meta``
    by default: nothing is allocated)."""
    return map_tree(lambda _p, s: torch.empty(s.shape, dtype=s.dtype,
                                              device=device), skeleton)


def param_specs(skeleton: dict, mesh=None) -> dict:
    """The resolved spec of every leaf (``sharding.resolve_spec``)."""
    return map_tree(lambda _p, s: shd.resolve_spec(s.logical, s.shape, mesh),
                    skeleton)


def param_shardings(skeleton: dict, mesh=None) -> dict:
    """A ``sharding.NamedSharding`` per leaf (None leaves without a
    mesh)."""
    return map_tree(lambda _p, s: shd.named_sharding(s.logical, s.shape,
                                                     mesh), skeleton)


def _numel(shape) -> int:
    return int(np.prod(shape, dtype=np.int64))


def init_std(spec: ParamSpec) -> float:
    """The f32 factor of a normal init (``scale`` or ``scale /
    sqrt(fan_in)``), rounded to f32 as the reference's weak-typed product
    rounds it."""
    if spec.init == "normal":
        return float(np.float32(spec.scale))
    fan_in = spec.shape[0] if len(spec.shape) == 1 else _numel(
        spec.shape[:-1])
    return float(np.float32(spec.scale / math.sqrt(max(fan_in, 1))))


def _init_one(spec: ParamSpec, key: torch.Tensor,
              device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init not in ("normal", "fan_in"):
        raise ValueError(f"unknown init {spec.init}")
    std = init_std(spec)
    out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
    flat = out.view(-1)
    n = flat.numel()
    # The f32 product first, then the cast, as ``.astype`` after the
    # product; each slice is elements [start, start + m) of one draw.
    for start in range(0, n, INIT_SLICE):
        m = min(INIT_SLICE, n - start)
        flat[start:start + m] = (prng.normal(key, m, start) * std).to(
            spec.dtype)
    return out


def init_params(skeleton: dict, key: torch.Tensor,
                device: DeviceLike = None) -> dict:
    """The reference's ``init_params(skeleton, key)``, bit for bit: one
    key per leaf from ``split(key, n_leaves)`` in the sorted flattening
    order, normals drawn in slices of :data:`INIT_SLICE` elements. On the
    card unless ``device`` says otherwise."""
    dev = resolve_device(device)
    paths = [p for p, _ in leaves(skeleton)]
    keys = prng.split(key.to(dev), len(paths))
    index = {p: i for i, p in enumerate(paths)}
    return map_tree(lambda p, s: _init_one(s, keys[index[p]], dev),
                    skeleton)


def count_params(skeleton: dict) -> int:
    return int(sum(_numel(s.shape) for _, s in leaves(skeleton)))


def param_bytes(skeleton: dict) -> int:
    return int(sum(_numel(s.shape) * s.dtype.itemsize
                   for _, s in leaves(skeleton)))


# ---------------------------------------------------------------------------
# Weights carried between the packages.
# ---------------------------------------------------------------------------

def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)                   # a writable host copy
    if str(a.dtype) == "bfloat16":
        # numpy has no bfloat16: move the 16-bit words.
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_reference(tree: Dict[str, Any],
                          device: DeviceLike = None) -> dict:
    """The reference's params tree (dicts and lists of numpy or JAX arrays,
    e.g. ``jax.device_get(params)``) as the port's: the same paths, the
    same layouts and bits (no transposes, no renames). On the card unless
    ``device`` says otherwise."""
    dev = resolve_device(device)
    return map_tree(lambda _p, a: _tensor(a, dev), tree)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_reference(params: dict) -> dict:
    """The port's params as the reference's tree of numpy arrays
    (bfloat16 leaves as ``ml_dtypes.bfloat16``, the dtype JAX gives)."""
    return map_tree(lambda _p, t: _array(t), params)
