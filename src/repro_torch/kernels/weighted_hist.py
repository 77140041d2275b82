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

Past :data:`MAX_CELLS_BINS` keys ``G·B`` a block's shared memory no
longer holds its warps' rows, and the wrapper takes the kernel's parted
form (``csrc/parted_reduce.cuh``): each item's key ``cell·B + bin`` (the
same bin table) is (part, low bits), the low bits at most
:data:`PARTED_LO_KEYS` keys, the items in a bin partitioned stably by
part as ``(key, w)``, each part's tiles summed over its low bits as the
one-launch form sums its keys, in 2 + the plan's partition passes
launches (3 up to 2**20 keys) and scratch that grows with ``M + G·B``.
Its sums' order is fixed by the data and ``M`` alone.

The order of the small-key form's f32 sums is fixed by ``M`` and by where
``values`` starts within 16 bytes (the kernel's 4-item vectors are aligned to that
address): the same data at the same 16-byte phase gives the same bits on
any H100, while a copy at another phase may differ in the last bits.
The port's callers pass whole flattened tensors, so a run and its repeat
see the same phase.

:func:`weighted_hist_rows` takes the emission's ``[G, N]`` slot view,
whose cells are its rows, and one weight per row, and picks one of three
forms by ``(G, B)`` alone (:func:`hist_form`): up to
:data:`MAX_CELLS_BINS` keys the one-launch form above on the flat view
with row ids and row weights (the bits of a flat call); past it, up to
:data:`MAX_ROW_BINS` bins, the row form, one launch that counts each
row's bins where the row lies and multiplies by its weight (no sort, no
ids, no per-slot weights; ``csrc/row_reduce.cuh``); past that, whose
counts no longer fit a block's shared memory, the parted form on the
flat view.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _workspace
from repro_torch.kernels.ref import row_ids
from repro_torch.kernels.stratified_stats import check_inputs, parted_scratch

#: The most keys G*B of the one-launch form, which keeps 8 warps' rows of
#: G*B f32 sums, G*B int32 counts, the bin table and the edges in the
#: shared memory of a block; past it, the parted form.
MAX_CELLS_BINS = 3200
#: The most bins of the row form, whose block keeps a row's B int32
#: counts, the bin table and the edges (about 82 KB at 4,096 bins) in
#: shared memory (``kMaxRowBins`` in ``csrc/row_reduce.cuh``); past it,
#: a ``[G, N]`` view takes the parted form.
MAX_ROW_BINS = 4096
#: The most low keys of the parted form: a power of two whose 8 warps'
#: rows fit a block as the one-launch form's MAX_CELLS_BINS do, at most
#: the look-back's 1,024.
PARTED_LO_KEYS = 1024


def hist_form(g: int, nb: int) -> str:
    """The form a histogram call over a ``[G, N]`` row view and ``nb``
    bins takes: ``"small"`` up to :data:`MAX_CELLS_BINS` keys ``G·B``,
    else ``"row"`` up to :data:`MAX_ROW_BINS` bins, else ``"parted"``.
    ``N`` does not enter."""
    if g * nb <= MAX_CELLS_BINS:
        return "small"
    return "row" if nb <= MAX_ROW_BINS else "parted"


def flat_form(g: int, nb: int) -> str:
    """The form a flat histogram call over ``g`` cells and ``nb`` bins
    takes: ``"small"`` up to :data:`MAX_CELLS_BINS` keys, else
    ``"parted"``."""
    return "small" if g * nb <= MAX_CELLS_BINS else "parted"


def _check_edges(edges: torch.Tensor, dev) -> int:
    """``B`` of contiguous f32 ``edges [B+1]`` on ``dev``; raises else."""
    if edges.dtype != torch.float32 or edges.ndim != 1 or \
            edges.shape[0] < 2 or edges.device != dev or \
            not edges.is_contiguous():
        raise ValueError(f"weighted_hist: edges must be contiguous f32 "
                         f"[B+1] with B >= 1 on {dev}, got {edges.dtype} "
                         f"{tuple(edges.shape)} on {edges.device}")
    return edges.shape[0] - 1


def weighted_hist(values: torch.Tensor, stratum_ids: torch.Tensor,
                  weights: torch.Tensor, mask: torch.Tensor,
                  edges: torch.Tensor, num_strata: int):
    """Deterministic one-launch weighted histogram on the card."""
    if not values.is_cuda:
        raise ValueError("weighted_hist kernel needs CUDA tensors; "
                         "kernels.ops dispatches CPU tensors")
    m = values.shape[0]
    dev = values.device
    check_inputs("weighted_hist", (m,), dev,
                 ("values", values, torch.float32),
                 ("stratum_ids", stratum_ids, torch.int32),
                 ("weights", weights, torch.float32),
                 ("mask", mask, torch.bool))
    nb = _check_edges(edges, dev)
    keys = num_strata * nb
    if num_strata < 1:
        raise ValueError(f"G = {num_strata}: the histogram needs a cell")
    form = flat_form(num_strata, nb)
    small = form == "small"
    if not small and keys >= 2**31 - 1:
        raise ValueError(f"G*B = {keys} does not fit the parted form's "
                         "int32 keys")
    lib = _build.build().lib
    out = torch.empty((2, num_strata, nb), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = _workspace.for_reduce(
        lib, dev, stream,
        words=lib.sa_whist_scratch_words(m, keys) if small else 0,
        keys=keys if small else 0)
    parted = (None, None) if small else parted_scratch(
        ws, m, keys, PARTED_LO_KEYS, 1)
    with torch.cuda.device(dev):
        status = lib.sa_weighted_hist(
            values.data_ptr(), stratum_ids.data_ptr(), weights.data_ptr(),
            mask.data_ptr(), edges.data_ptr(), m, num_strata, nb,
            ws.rows.data_ptr(), ws.tickets.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), *parted, stream)
    if status != 0:
        _workspace.drop(dev, stream)
    _build.check(status, "weighted_hist")
    weighted_hist.launches += 1
    weighted_hist.forms[form] += 1
    return out[0], out[1]


def weighted_hist_rows(values: torch.Tensor, row_weights: torch.Tensor,
                       mask: torch.Tensor, edges: torch.Tensor):
    """Per-(row, bin) ``(whist, counts)`` of a ``[G, N]`` view whose row
    ``g`` weighs ``row_weights[g]``, both f32 ``[G, B]``, on the card:
    the form :func:`hist_form` names."""
    if not values.is_cuda:
        raise ValueError("weighted_hist kernel needs CUDA tensors; "
                         "kernels.ops dispatches CPU tensors")
    if values.ndim != 2:
        raise ValueError(f"weighted_hist_rows: values must be [G, N], got "
                         f"{tuple(values.shape)}")
    g, n = values.shape
    dev = values.device
    check_inputs("weighted_hist_rows", (g, n), dev,
                 ("values", values, torch.float32),
                 ("mask", mask, torch.bool))
    check_inputs("weighted_hist_rows", (g,), dev,
                 ("row_weights", row_weights, torch.float32))
    nb = _check_edges(edges, dev)
    if g < 1:
        raise ValueError(f"G = {g}: the histogram needs a row")
    form = hist_form(g, nb)
    if form != "row":
        return weighted_hist(values.reshape(-1), row_ids(g, n, dev),
                             row_weights.repeat_interleave(n),
                             mask.reshape(-1), edges, g)
    lib = _build.build().lib
    out = torch.empty((2, g, nb), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = _workspace.get(dev, stream).reserve_rows(
        words=0, tickets=lib.sa_whist_rows_zeroed(g, n, nb))
    with torch.cuda.device(dev):
        status = lib.sa_whist_rows(
            values.data_ptr(), mask.data_ptr(), row_weights.data_ptr(),
            edges.data_ptr(), g, n, nb, ws.tickets.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), stream)
    if status != 0:
        _workspace.drop(dev, stream)
    _build.check(status, "weighted_hist_rows")
    weighted_hist.launches += 1
    weighted_hist.forms["row"] += 1
    return out[0], out[1]


weighted_hist.launches = 0
#: Launches of each form since the last reset.
weighted_hist.forms = {"small": 0, "row": 0, "parted": 0}
