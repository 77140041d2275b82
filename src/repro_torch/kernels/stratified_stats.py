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
its warps' rows, and the wrapper takes the kernel's parted form
(``csrc/parted_reduce.cuh``): a stratum is (part, low bits), the low bits
at most :data:`MAX_STRATA` keys (:func:`_workspace.parted_plan`), the live
items' ``(stratum, x)`` partitioned stably by part, each part's tiles
summed over its low bits as the one-launch form sums its strata, in 2 +
the plan's partition passes launches (3 up to 2**19 strata) and scratch
that grows with ``M + S``. Its sums' order is fixed by the data and
``M`` alone.

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
ids, no cap on ``G``; ``csrc/row_reduce.cuh``). The parted form serves
flat callers whose ids are arbitrary (``query.exact_stats``, SRS / STS).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _workspace
from repro_torch.kernels.ref import row_ids

#: The most strata of the one-launch form, which keeps 8 warps' rows of S
#: (f32, f32) sums and S int32 counts in shared memory; past it, the
#: parted form.
MAX_STRATA = 512
#: Items of the parted forms of the stats and the histogram: their
#: partitioned positions and tiles are int32.
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


def flat_form(num_strata: int) -> str:
    """The form a flat stats call over ``num_strata`` strata takes:
    ``"small"`` up to :data:`MAX_STRATA`, else ``"parted"``. ``M`` and
    the ids do not enter."""
    return "small" if num_strata <= MAX_STRATA else "parted"


def parted_scratch(ws, m: int, keys: int, lo_keys: int, nf: int) -> tuple:
    """The parted form's plan ints and scratch pointers (``ctypes``
    arrays) for ``m`` items over ``keys`` keys and at most ``lo_keys``
    low keys, ``ws``'s scratch grown for them; raises past
    :data:`LARGE_MAX_ITEMS` items."""
    if m > LARGE_MAX_ITEMS:
        raise ValueError(f"M = {m} does not fit the parted form's int32 "
                         "positions")
    return ws.parted_reduce(_workspace.parted_plan(keys, m, lo_keys), m, nf)


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
    form = flat_form(num_strata)
    lib = _build.build().lib
    out = torch.empty((3, num_strata), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    small = form == "small"
    ws = _workspace.for_reduce(
        lib, dev, stream,
        words=lib.sa_stats_scratch_words(m, num_strata) if small else 0,
        keys=num_strata if small else 0)
    parted = (None, None) if small else parted_scratch(
        ws, m, num_strata, MAX_STRATA, 2)
    with torch.cuda.device(dev):
        status = lib.sa_stratified_stats(
            values.data_ptr(), stratum_ids.data_ptr(), mask.data_ptr(), m,
            num_strata, ws.rows.data_ptr(), ws.tickets.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), *parted, stream)
    if status != 0:
        _workspace.drop(dev, stream)
    _build.check(status, "stratified_stats")
    stratified_stats.launches += 1
    stratified_stats.forms[form] += 1
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
stratified_stats.forms = {"small": 0, "row": 0, "parted": 0}
