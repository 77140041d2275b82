"""CUDA wrapper of the per-stratum stats pass (``csrc/stratified_stats.cu``).

Counterpart of the reference's ``kernels/stratified_stats.py::
stratified_stats`` with its flat signature: ``values [M]``, ``sid [M]``,
``mask [M]``, ``S`` → ``(counts, sums, sumsqs)``, three f32 ``[S]``.
Takes CUDA tensors only; ``kernels/ops.py`` sends CPU tensors to the
plain version in ``kernels/ref.py``. The inputs may be views that start on
any element. One launch per call: the block rows of partial sums, the
tickets of the cross-block sum and the count totals are kept in
``kernels/_workspace`` per device and stream (tickets and totals 0
between calls), not allocated per call.

Past :data:`MAX_STRATA` strata a block's shared memory no longer holds
its warps' rows, and the wrapper takes the kernel's large-key form: each
live item's stratum sorted stably (``csrc/key_sort.cu``), then each
stratum's run of sorted items summed by a fixed tree, with scratch that
grows with ``M + S``. Its sums' order is fixed by the data alone.

The order of the small-key form's f32 sums is fixed by ``M`` and by where
``values`` starts within 16 bytes (the kernel's 4-item vectors are aligned to that
address): the same data at the same 16-byte phase gives the same bits on
any H100, while a copy at another phase may differ in the last bits.
The port's callers pass whole flattened tensors, so a run and its repeat
see the same phase.

:func:`stratified_stats_rows` takes the emission's ``[G, N]`` slot view,
whose strata are its rows, and picks one of three forms by ``G`` alone
(:func:`stats_form`): up to :data:`MAX_STRATA` rows the one-launch form
above on the flat view with row ids (the bits of a flat call); past it
the row form, one launch that sums each row where it lies (no sort, no
ids, no cap on ``G``; ``csrc/row_reduce.cuh``). The sorted large-key
form stays for flat callers whose ids are arbitrary.
"""
from __future__ import annotations

import torch

import ctypes

from repro_torch.kernels import _build, _workspace
from repro_torch.kernels.ref import row_ids

#: The most strata of the one-launch form, which keeps 8 warps' rows of S
#: (f32, f32) sums and S int32 counts in shared memory; past it, the
#: large-key form.
MAX_STRATA = 512
#: Items of the large-key forms of the stats and the histogram: their
#: sorted positions and tiles are int32.
LARGE_MAX_ITEMS = 2**31 - 4096


def check_inputs(fn: str, shape: tuple, device, *named) -> None:
    """Raise unless each ``(name, tensor, dtype)`` of ``named`` is a
    contiguous tensor of that dtype and ``shape`` on ``device``."""
    for name, t, dtype in named:
        if t.dtype != dtype:
            raise TypeError(f"{fn}: {name} has dtype {t.dtype}, expected "
                            f"{dtype}")
        if tuple(t.shape) != shape or t.device != device:
            raise ValueError(f"{fn}: {name} must be {list(shape)} on "
                             f"{device}, got {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")


def stats_form(g: int) -> str:
    """The form a stats call over a ``[G, N]`` row view takes: ``"small"``
    (the one-launch form on the flat view) up to :data:`MAX_STRATA` rows,
    else ``"row"``. ``N`` does not enter."""
    return "small" if g <= MAX_STRATA else "row"


def stratified_stats(values: torch.Tensor, stratum_ids: torch.Tensor,
                     mask: torch.Tensor, num_strata: int):
    """Deterministic one-launch segmented reduction on the card."""
    if not values.is_cuda:
        raise ValueError("stratified_stats kernel needs CUDA tensors; "
                         "kernels.ops dispatches CPU tensors")
    m = values.shape[0]
    dev = values.device
    check_inputs("stratified_stats", (m,), dev,
                 ("values", values, torch.float32),
                 ("stratum_ids", stratum_ids, torch.int32),
                 ("mask", mask, torch.bool))
    if num_strata < 1:
        raise ValueError(f"S = {num_strata}: the stats need a stratum")
    large = num_strata > MAX_STRATA
    if large and m > LARGE_MAX_ITEMS:
        raise ValueError(f"M = {m} does not fit the large-key form's int32 "
                         "sort positions")
    lib = _build.build().lib
    out = torch.empty((3, num_strata), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = _workspace.for_reduce(
        lib, dev, stream,
        words=0 if large else lib.sa_stats_scratch_words(m, num_strata),
        keys=0 if large else num_strata)
    lg = ws.large(lib, m=m, keys=num_strata,
                  part=lib.sa_stats_part_words(m)) if large else None
    with torch.cuda.device(dev):
        status = lib.sa_stratified_stats(
            values.data_ptr(), stratum_ids.data_ptr(), mask.data_ptr(), m,
            num_strata, ws.rows.data_ptr(), ws.tickets.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(),
            ctypes.addressof(lg) if large else None, stream)
    if status != 0:
        _workspace.drop(dev, stream)
    _build.check(status, "stratified_stats")
    stratified_stats.launches += 1
    stratified_stats.forms["sorted" if large else "small"] += 1
    return out[0], out[1], out[2]


def stratified_stats_rows(values: torch.Tensor, mask: torch.Tensor):
    """Per-row ``(count, Σx, Σx²)`` of a ``[G, N]`` view on the card,
    three f32 ``[G]``: the form :func:`stats_form` names."""
    if not values.is_cuda:
        raise ValueError("stratified_stats kernel needs CUDA tensors; "
                         "kernels.ops dispatches CPU tensors")
    if values.ndim != 2:
        raise ValueError(f"stratified_stats_rows: values must be [G, N], "
                         f"got {tuple(values.shape)}")
    g, n = values.shape
    dev = values.device
    check_inputs("stratified_stats_rows", (g, n), dev,
                 ("values", values, torch.float32),
                 ("mask", mask, torch.bool))
    if g < 1:
        raise ValueError(f"G = {g}: the stats need a row")
    if stats_form(g) == "small":
        return stratified_stats(values.reshape(-1), row_ids(g, n, dev),
                                mask.reshape(-1), g)
    lib = _build.build().lib
    out = torch.empty((3, g), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = _workspace.get(dev, stream).reserve_rows(
        words=lib.sa_stats_rows_part_words(g, n),
        tickets=lib.sa_stats_rows_zeroed(g, n))
    with torch.cuda.device(dev):
        status = lib.sa_stats_rows(
            values.data_ptr(), mask.data_ptr(), g, n, ws.rows.data_ptr(),
            ws.tickets.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            stream)
    if status != 0:
        _workspace.drop(dev, stream)
    _build.check(status, "stratified_stats_rows")
    stratified_stats.launches += 1
    stratified_stats.forms["row"] += 1
    return out[0], out[1], out[2]


stratified_stats.launches = 0
#: Launches of each form since the last reset.
stratified_stats.forms = {"small": 0, "row": 0, "sorted": 0}
