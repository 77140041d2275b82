"""CUDA wrapper of the per-(cell, bin) weighted histogram
(``csrc/weighted_hist.cu``).

Counterpart of the reference's ``kernels/weighted_hist.py::weighted_hist``
with its flat signature: ``values [M]``, ``stratum_ids [M]`` (the cell of
each slot), ``weights [M]``, ``mask [M]``, ``edges [B+1]``, ``G`` →
``(whist, counts)``, both f32 ``[G, B]``. Edges are non-decreasing, as the
reference's are. Takes CUDA tensors only; ``kernels/ops.py`` sends CPU
tensors to the plain version in ``kernels/ref.py``. The inputs may be
views that start on any element. One launch per call: the block rows of
partial sums, the tickets of the cross-block sum and the count totals
are kept in ``kernels/_workspace`` per device and stream (tickets and
totals 0 between calls), not allocated per call.

The order of the f32 sums is fixed by ``M`` and by where ``values``
starts within 16 bytes (the kernel's 4-item vectors are aligned to that
address): the same data at the same 16-byte phase gives the same bits on
any H100, while a copy at another phase may differ in the last bits.
The port's callers pass whole flattened tensors, so a run and its repeat
see the same phase.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _workspace

#: 8 warps' rows of G*B f32 sums, G*B int32 counts, the bin table and
#: the edges in the shared memory of a block.
MAX_CELLS_BINS = 3200


def weighted_hist(values: torch.Tensor, stratum_ids: torch.Tensor,
                  weights: torch.Tensor, mask: torch.Tensor,
                  edges: torch.Tensor, num_strata: int):
    """Deterministic one-launch weighted histogram on the card."""
    if not values.is_cuda:
        raise ValueError("weighted_hist kernel needs CUDA tensors; "
                         "kernels.ops dispatches CPU tensors")
    m = values.shape[0]
    dev = values.device
    for name, t, dtype in (("values", values, torch.float32),
                           ("stratum_ids", stratum_ids, torch.int32),
                           ("weights", weights, torch.float32),
                           ("mask", mask, torch.bool)):
        if t.dtype != dtype:
            raise TypeError(f"weighted_hist: {name} has dtype {t.dtype}, "
                            f"expected {dtype}")
        if tuple(t.shape) != (m,) or t.device != dev:
            raise ValueError(f"weighted_hist: {name} must be [{m}] on "
                             f"{dev}, got {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"weighted_hist: {name} is not contiguous")
    if edges.dtype != torch.float32 or edges.ndim != 1 or \
            edges.shape[0] < 2 or edges.device != dev or \
            not edges.is_contiguous():
        raise ValueError(f"weighted_hist: edges must be contiguous f32 "
                         f"[B+1] with B >= 1 on {dev}, got {edges.dtype} "
                         f"{tuple(edges.shape)} on {edges.device}")
    nb = edges.shape[0] - 1
    keys = num_strata * nb
    if num_strata < 1 or keys > MAX_CELLS_BINS:
        raise ValueError(f"G*B = {num_strata}*{nb} = {keys} outside "
                         f"[1, MAX_CELLS_BINS = {MAX_CELLS_BINS}] (shared "
                         "memory of a block)")
    lib = _build.build().lib
    out = torch.empty((2, num_strata, nb), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = _workspace.for_reduce(
        lib, dev, stream, words=lib.sa_whist_scratch_words(m, keys), keys=keys)
    with torch.cuda.device(dev):
        status = lib.sa_weighted_hist(
            values.data_ptr(), stratum_ids.data_ptr(), weights.data_ptr(),
            mask.data_ptr(), edges.data_ptr(), m, num_strata, nb,
            ws.rows.data_ptr(), ws.tickets.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), stream)
    if status != 0:
        _workspace.drop(dev, stream)
    _build.check(status, "weighted_hist")
    weighted_hist.launches += 1
    return out[0], out[1]


weighted_hist.launches = 0
