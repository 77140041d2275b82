"""CUDA wrapper of the reservoir fold (``csrc/reservoir_fold.cu``).

Counterpart of the reference's ``kernels/reservoir.py::reservoir_fold``
(the TPU kernel ``_fold_kernel``) with the same signature: pre-drawn
uniforms in, ``values [S, N_max]`` updated in place. Takes CUDA tensors
only; ``kernels/ops.py`` sends CPU tensors to the plain version in
``kernels/ref.py``.

The fold is bound by memory: it must read the mask of every item, the
stratum of each live item, ``u_accept`` of each live item past its
cell's capacity, ``u_slot`` of each such item accepted and the payload
of each ring cell won, and write that cell. The kernel is two launches:
a single-pass look-back scan that ranks, decides and claims ring cells
with ``atomicMax`` (it reads the stratum, mask and both uniforms of
every item once), and a write of the winners. Its winner table (4 B per
ring cell) is never cleared per call: it is all -1 between calls, kept
with the rest of the scratch in ``kernels/_workspace`` per device and
stream, and dropped if a launch reports an error.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _workspace

#: The claim keeps 16 warps x (S + 1) + 3 S int32 in shared memory.
MAX_STRATA = 1024


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
                         "(shared memory of the claim)")
    lib = _build.build().lib
    counts_out = torch.empty(s_cnt, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = _workspace.for_call(lib, dev, stream, m=m, cells=s_cnt,
                             table=s_cnt * n_max)
    with torch.cuda.device(dev):
        status = lib.sa_reservoir_fold(
            stratum_ids.data_ptr(), payload.data_ptr(), u_accept.data_ptr(),
            u_slot.data_ptr(), mask.data_ptr(), counts.data_ptr(),
            capacity.data_ptr(), values.data_ptr(), counts_out.data_ptr(),
            ws.winner.data_ptr(), ws.status.data_ptr(), ws.lists.data_ptr(),
            ws.list_n.data_ptr(), ws.counters.data_ptr(), m, s_cnt, n_max,
            stream)
    if status != 0:
        _workspace.drop(dev, stream)
    _build.check(status, "reservoir_fold")
    reservoir_fold.launches += 1
    return counts_out


reservoir_fold.launches = 0
