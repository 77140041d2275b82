"""CUDA wrapper of the per-stratum stats pass (``csrc/stratified_stats.cu``).

Counterpart of the reference's ``kernels/stratified_stats.py::
stratified_stats`` with its flat signature: ``values [M]``, ``sid [M]``,
``mask [M]``, ``S`` → ``(counts, sums, sumsqs)``, three f32 ``[S]``.
Takes CUDA tensors only; ``kernels/ops.py`` sends CPU tensors to the
plain version in ``kernels/ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: 8 warps x S x (int, f32, f32) partials must fit 48 KB of shared memory.
MAX_STRATA = 512


def stratified_stats(values: torch.Tensor, stratum_ids: torch.Tensor,
                     mask: torch.Tensor, num_strata: int):
    """Deterministic two-pass segmented reduction on the card."""
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
    if not 1 <= num_strata <= MAX_STRATA:
        raise ValueError(f"S = {num_strata} outside [1, {MAX_STRATA}] "
                         "(shared memory of the partials pass)")
    lib = _build.build().lib
    n_blocks = max(-(-m // lib.sa_stats_tile_items()), 1)
    part_cnt = torch.empty((num_strata, n_blocks), dtype=torch.int32,
                           device=dev)
    part = torch.empty((2, num_strata, n_blocks), dtype=torch.float32,
                       device=dev)
    out = torch.empty((3, num_strata), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        status = lib.sa_stratified_stats(
            values.data_ptr(), stratum_ids.data_ptr(), mask.data_ptr(), m,
            num_strata, part_cnt.data_ptr(), part[0].data_ptr(),
            part[1].data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr(), stream)
    _build.check(status, "stratified_stats")
    stratified_stats.launches += 1
    return out[0], out[1], out[2]


stratified_stats.launches = 0
