"""CUDA wrapper of the reservoir fold (``csrc/reservoir_fold.cu``).

Counterpart of the reference's ``kernels/reservoir.py::reservoir_fold``
with the same signature: pre-drawn uniforms in, ``values [S, N_max]``
updated in place. Takes CUDA tensors only; ``kernels/ops.py`` sends CPU
tensors to the plain version in ``kernels/ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: Shared memory of the rank pass holds 8 warps x (S + 1) int32 counts.
MAX_STRATA = 1024
_TILE = 256


def _check(name, t, dtype, shape, device):
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"reservoir_fold: {name} has dtype {t.dtype}, "
                        f"expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"reservoir_fold: {name} has shape "
                         f"{tuple(t.shape)}, expected {shape}")
    if t.device != device:
        raise ValueError(f"reservoir_fold: {name} is on {t.device}, "
                         f"values on {device}")
    if not t.is_contiguous():
        raise ValueError(f"reservoir_fold: {name} is not contiguous")


def reservoir_fold(stratum_ids: torch.Tensor, payload: torch.Tensor,
                   u_accept: torch.Tensor, u_slot: torch.Tensor,
                   mask: torch.Tensor, counts: torch.Tensor,
                   capacity: torch.Tensor,
                   values: torch.Tensor) -> torch.Tensor:
    """Fold an ``[M]`` chunk into ``values`` (in place) on the card.

    ``stratum_ids`` int32 ``[M]`` in ``[0, S)``, ``payload`` ``[M]`` of
    ``values``' dtype (f32 or i32), ``u_accept``/``u_slot`` f32 ``[M]``,
    ``mask`` bool ``[M]``, ``counts``/``capacity`` int32 ``[S]``. Returns
    the new ``[S]`` int32 counts.
    """
    if not values.is_cuda:
        raise ValueError("reservoir_fold kernel needs CUDA tensors; "
                         "kernels.ops dispatches CPU tensors")
    if values.ndim != 2:
        raise ValueError(f"values must be [S, N_max], got {values.shape}")
    s_cnt, n_max = values.shape
    m = stratum_ids.shape[0]
    dev = values.device
    _check("values", values, (torch.float32, torch.int32), (s_cnt, n_max),
           dev)
    _check("stratum_ids", stratum_ids, torch.int32, (m,), dev)
    _check("payload", payload, values.dtype, (m,), dev)
    _check("u_accept", u_accept, torch.float32, (m,), dev)
    _check("u_slot", u_slot, torch.float32, (m,), dev)
    _check("mask", mask, torch.bool, (m,), dev)
    _check("counts", counts, torch.int32, (s_cnt,), dev)
    _check("capacity", capacity, torch.int32, (s_cnt,), dev)
    if s_cnt * n_max + 1 >= 2**31:
        raise ValueError(f"S*N_max+1 = {s_cnt * n_max + 1} does not fit "
                         "the kernel's int32 cell index")
    if m >= 2**31:
        raise ValueError(f"M = {m} does not fit an int32 item index")
    if not 1 <= s_cnt <= MAX_STRATA:
        raise ValueError(f"S = {s_cnt} outside [1, {MAX_STRATA}] "
                         "(shared memory of the rank pass)")
    n_tiles = -(-m // _TILE)
    i32 = dict(dtype=torch.int32, device=dev)
    counts_out = torch.empty(s_cnt, **i32)
    tile_counts = torch.empty((s_cnt, max(n_tiles, 1)), **i32)
    tile_offsets = torch.empty((s_cnt, max(n_tiles, 1)), **i32)
    cell = torch.empty(max(m, 1), **i32)
    winner = torch.empty(s_cnt * n_max, **i32)
    lib = _build.build().lib
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        status = lib.sa_reservoir_fold(
            stratum_ids.data_ptr(), payload.data_ptr(), u_accept.data_ptr(),
            u_slot.data_ptr(), mask.data_ptr(), counts.data_ptr(),
            capacity.data_ptr(), values.data_ptr(), counts_out.data_ptr(),
            tile_counts.data_ptr(), tile_offsets.data_ptr(),
            cell.data_ptr(), winner.data_ptr(), m, s_cnt, n_max, stream)
    _build.check(status, "reservoir_fold")
    reservoir_fold.launches += 1
    return counts_out


reservoir_fold.launches = 0
