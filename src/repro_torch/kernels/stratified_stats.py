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
"""
from __future__ import annotations

import torch

import ctypes

from repro_torch.kernels import _build, _workspace

#: The most strata of the one-launch form, which keeps 8 warps' rows of S
#: (f32, f32) sums and S int32 counts in shared memory; past it, the
#: large-key form.
MAX_STRATA = 512
#: Items of the large-key forms of the stats and the histogram: their
#: sorted positions and tiles are int32.
LARGE_MAX_ITEMS = 2**31 - 4096


def stratified_stats(values: torch.Tensor, stratum_ids: torch.Tensor,
                     mask: torch.Tensor, num_strata: int):
    """Deterministic one-launch segmented reduction on the card."""
    if not values.is_cuda:
        raise ValueError("stratified_stats kernel needs CUDA tensors; "
                         "kernels.ops dispatches CPU tensors")
    m = values.shape[0]
    dev = values.device
    for name, t, dtype in (("values", values, torch.float32),
                           ("stratum_ids", stratum_ids, torch.int32),
                           ("mask", mask, torch.bool)):
        if t.dtype != dtype:
            raise TypeError(f"stratified_stats: {name} has dtype {t.dtype}, "
                            f"expected {dtype}")
        if tuple(t.shape) != (m,) or t.device != dev:
            raise ValueError(f"stratified_stats: {name} must be [{m}] on "
                             f"{dev}, got {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"stratified_stats: {name} is not contiguous")
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
    return out[0], out[1], out[2]


stratified_stats.launches = 0
