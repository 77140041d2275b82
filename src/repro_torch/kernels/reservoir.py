"""CUDA wrapper of the reservoir fold (``csrc/reservoir_fold.cu``).

Counterpart of the reference's ``kernels/reservoir.py::reservoir_fold``
(the TPU kernel ``_fold_kernel``) with the same signature: pre-drawn
uniforms in, ``values [S, N_max]`` updated in place. Takes CUDA tensors
only; ``kernels/ops.py`` sends CPU tensors to the plain version in
``kernels/ref.py``. Unlike the reference's kernel, which refuses a
payload tree, it also takes one: ``values`` a tree of ``[S, N_max,
*item]`` leaves of any dtype and ``payload`` the same tree of ``[M,
*item]`` leaves.

The fold is bound by memory: it must read the mask of every item, the
stratum of each live item, ``u_accept`` of each live item past its
cell's capacity, ``u_slot`` of each such item accepted and the payload
of each ring cell won, and write that cell. The kernel is two launches:
a single-pass look-back scan that ranks, decides and claims ring cells
with ``atomicMax`` (it reads the stratum, mask and both uniforms of
every item once), and a write of the winners. A payload other than one
4-byte scalar leaf takes the same claim and one write launch per group of
at most :data:`MAX_LEAVES` leaves, each copying every winner's row of
its leaves. Its winner table (4 B per ring cell) is never cleared per
call: it is all -1 between calls, kept with the rest of the scratch in
``kernels/_workspace`` per device and stream, and dropped if a launch
reports an error.

Past :data:`MAX_STRATA` strata the claim's per-stratum tables no longer
fit a block's shared memory, and the wrapper takes the kernel's parted
form (``csrc/parted_claim.cuh``, its split from
:func:`~repro_torch.kernels._workspace.parted_plan`): a stratum is (part,
low bits); the live items are counted per part, partitioned stably by
part, and each part's tiles ranked and claimed over the low bits alone,
with the small form's verdicts, lists and write launches. That is 4
launches up to 2**20 strata (one partition pass more for each further 10
bits), every look-back over at most 1,024 keys, and scratch that grows
with ``M + S``. The form is chosen by ``S`` alone; :attr:`forms` counts
each form's calls. Both forms compute the plain version's result bit for
bit; the only configuration refused for size is a ring whose cell index
does not fit int32.

A call may be batched over W·K folds, as the reference's masked ingest
``vmap``s its kernel over the K ring slots and its sharded core over the
W shards: ``counts``/``capacity`` ``[W, K, S]``, each values leaf ``[W,
K, S, N_max, ...]``, ``mask`` ``[W, K, M]`` and the items ``[W, M]``
(:func:`~repro_torch.kernels.ref.fold_lead`). The kernel takes the fold
as a grid axis of each launch, every fold with its own scratch; the K
folds of a shard read its item row (no copy of the items per fold). So
the call is the same 2 or 4 launches and one count whatever W·K is; its
form is chosen by ``S`` and each fold's int32 limit and bits are those
of its unbatched call.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, _workspace
from repro_torch.kernels.ref import check_fold_payload, fold_lead

#: The most strata of the small-key claim, which keeps 16 warps x
#: (S + 1) + 3 S int32 in shared memory; past it, the parted form.
MAX_STRATA = 1024
#: Leaves of one write launch of a payload tree (``kMaxLeaves`` in
#: ``csrc/fold_device.cuh``); more go in groups.
MAX_LEAVES = 8


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


def reservoir_fold(stratum_ids: torch.Tensor, payload,
                   u_accept: torch.Tensor, u_slot: torch.Tensor,
                   mask: torch.Tensor, counts: torch.Tensor,
                   capacity: torch.Tensor, values) -> torch.Tensor:
    """Fold an ``[M]`` chunk into ``values`` (in place) on the card, or
    W·K folds in one call.

    ``stratum_ids`` int32 ``[M]`` in ``[0, S)``, ``payload`` ``[M]`` of
    ``values``' dtype (f32 or i32) into ``values [S, N_max]``, or a tree
    of ``[M, *item]`` leaves into the same tree of ``[S, N_max, *item]``
    leaves of their dtypes; ``u_accept``/``u_slot`` f32 ``[M]``, ``mask``
    bool ``[M]``, ``counts``/``capacity`` int32 ``[S]``. Returns the new
    ``[S]`` int32 counts. Batched (module docstring), the same with a
    leading ``[W, K]`` on the folds' tensors and ``[W]`` on the items'.
    """
    lead = fold_lead(stratum_ids, u_accept, u_slot, mask, counts, capacity)
    w, k = lead or (1, 1)
    m = stratum_ids.shape[-1]
    leaves = check_fold_payload(payload, values, m, lead)
    val0 = leaves[0][1]
    if not val0.is_cuda:
        raise ValueError("reservoir_fold kernel needs CUDA tensors; "
                         "kernels.ops dispatches CPU tensors")
    n = len(lead)
    s_cnt, n_max = val0.shape[n:n + 2]
    dev = val0.device
    scalar = len(leaves) == 1 and val0.dim() == n + 2 and val0.dtype in (
        torch.float32, torch.int32)
    for i, (pay, val) in enumerate(leaves):
        _check(f"values leaf {i}", val, val.dtype, tuple(val.shape), dev)
        _check(f"payload leaf {i}", pay, val.dtype, tuple(pay.shape), dev)
    _check("stratum_ids", stratum_ids, torch.int32, lead[:1] + (m,), dev)
    _check("u_accept", u_accept, torch.float32, lead[:1] + (m,), dev)
    _check("u_slot", u_slot, torch.float32, lead[:1] + (m,), dev)
    _check("mask", mask, torch.bool, lead + (m,), dev)
    _check("counts", counts, torch.int32, lead + (s_cnt,), dev)
    _check("capacity", capacity, torch.int32, lead + (s_cnt,), dev)
    if s_cnt * n_max + 1 >= 2**31:
        raise ValueError(f"S*N_max+1 = {s_cnt * n_max + 1} does not fit "
                         "the kernel's int32 cell index")
    if m >= 2**31:
        raise ValueError(f"M = {m} does not fit an int32 item index")
    if s_cnt < 1:
        raise ValueError(f"S = {s_cnt}: the fold needs a stratum")
    plan = _workspace.parted_plan(s_cnt, m) if s_cnt > MAX_STRATA else None
    lib = _build.build().lib
    counts_out = torch.empty(lead + (s_cnt,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = _workspace.for_call(lib, dev, stream, m=m, cells=s_cnt,
                             table=s_cnt * n_max, plan=plan, shards=w * k)
    if plan is not None:
        plan_c, pt = ws.parted(plan, shards=w * k)
    scratch = (counts_out.data_ptr(), ws.winner.data_ptr(),
               ws.status.data_ptr(), ws.lists.data_ptr(),
               ws.list_n.data_ptr(), ws.counters.data_ptr(),
               None if plan is None else ctypes.addressof(plan_c),
               None if plan is None else ctypes.addressof(pt))
    with torch.cuda.device(dev):
        if scalar:
            status = lib.sa_reservoir_fold(
                stratum_ids.data_ptr(), leaves[0][0].data_ptr(),
                u_accept.data_ptr(), u_slot.data_ptr(), mask.data_ptr(),
                counts.data_ptr(), capacity.data_ptr(), val0.data_ptr(),
                *scratch, m, s_cnt, n_max, w, k, stream)
        else:
            ptrs = ctypes.c_void_p * len(leaves)
            pays = ptrs(*(pay.data_ptr() for pay, _ in leaves))
            vals = ptrs(*(val.data_ptr() for _, val in leaves))
            rows = (ctypes.c_longlong * len(leaves))(*(
                math.prod(val.shape[n + 2:]) * val.element_size()
                for _, val in leaves))
            status = lib.sa_reservoir_fold_rows(
                stratum_ids.data_ptr(), ctypes.addressof(pays),
                u_accept.data_ptr(), u_slot.data_ptr(), mask.data_ptr(),
                counts.data_ptr(), capacity.data_ptr(),
                ctypes.addressof(vals), ctypes.addressof(rows), *scratch, m,
                s_cnt, n_max, len(leaves), w, k, stream)
    if status != 0:
        _workspace.drop(dev, stream)
    _build.check(status, "reservoir_fold")
    reservoir_fold.launches += 1
    reservoir_fold.forms["small" if plan is None else "parted"] += 1
    return counts_out


reservoir_fold.launches = 0
reservoir_fold.forms = {"small": 0, "parted": 0}
