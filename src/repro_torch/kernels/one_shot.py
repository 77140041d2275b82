"""CUDA wrapper of the one-shot ingest (``csrc/one_shot_ingest.cu``).

Counterpart of the reference's ``kernels/reservoir.py::one_shot_ingest``
(the TPU kernel ``_one_shot_kernel``) with the same keyword surface: one
chunk's watermark routing, ring-slot reset, (slot, stratum) cell
assignment, Vitter fold and obs counter rows in one call. Every carried
tensor (the ring, cell counts and capacities, the slot table, the
watermark scalars, the chunk/item totals and the ``[6, S]`` counter
rows) is updated IN PLACE, and the returned
:class:`~repro_torch.kernels.ref.OneShotResult` holds those same tensors.
Takes CUDA tensors only; ``kernels/ops.py`` sends CPU tensors to the
plain version in ``kernels/ref.py``. The payload is a tensor or, as the
reference's, a tree of ``[M]`` leaves (f32 and i32 may be mixed) with
the ring's structure: the fold's decisions are taken once and the write
launches copy every leaf at each winner's cell, :data:`MAX_LEAVES` leaves
a launch.

The ingest is bound by memory: it must read the mask of every item, the
time and stratum of each masked-in item, and then what the fold needs
(``kernels/reservoir``) of the live ones. The kernel is three launches,
one per real grid-wide dependency: the frontier maxima; the routing with
the fold's single-pass look-back scan and claims, in which every tile
works out the slot reset itself and the last tile writes the new counts
to scratch, the replaced and occupancy rows and ``chunks``; and the write
of the winners, whose block 0 writes the carried counts, capacities,
slot table, frontier and newest interval. Its scratch, the 4 B per ring
cell winner table included, is kept per device and stream in
``kernels/_workspace`` and never cleared per call; it is dropped if a
launch reports an error.

Past :data:`MAX_CELLS` cells ``K·S`` the route-and-claim launch's
per-cell tables and per-warp counter rows no longer fit a block's shared
memory, and the wrapper takes the kernel's parted form
(``csrc/parted_claim.cuh``, its split from
:func:`~repro_torch.kernels._workspace.parted_plan`): the routing adds
the ingested and late rows per block in shared memory (one global add
per nonzero word; warp-aggregated global atomics past 4,096 strata; the
accepted and dropped rows follow from the cells' new counts in the last
launch), counts the live items per part of the cell and resets the slots
into scratch; the live items are partitioned stably by part, and each
part's tiles ranked and claimed over the cell's low bits alone, with the
small form's verdicts and lists. That is 5 launches up to 2**20 cells
(one partition pass more for each further 10 bits), every look-back over
at most 1,024 keys, and scratch that grows with ``M + K·S``. The form is
chosen by ``K·S`` alone; :attr:`forms` counts each form's calls. Both
forms compute the plain version's result bit for bit; the only
configuration refused for size is a ring whose index does not fit
int32.

A call may be batched over W shards, as the reference's sharded core
``vmap``s its kernel into one call whose grid leads with the shard: every
tensor then leads with ``[W]`` (``times [W, M]``, ``counts [W, K, S]``,
...). The kernel takes the shard as a grid axis of each launch, every
shard with its own scratch, so the call is the same 3 or 5 launches and
one count whatever W is; each shard's form, plan, int32 limit and bits
are those of its unbatched call.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build, _workspace
from repro_torch.kernels.ref import (OneShotResult, check_one_shot_payload,
                                     one_shot_lead)

#: The most cells K*S of the small-key form, whose route-and-claim launch
#: keeps 16 warps x (K*S + 1) + 4 K*S int32 and per-warp counter rows of
#: 32 S + 4 int32 in shared memory; past it, the parted form.
MAX_CELLS = 1024
#: Payload leaves of one write launch, which takes their pointers by
#: value (``kMaxLeaves`` in ``csrc/fold_device.cuh``); more go in groups.
MAX_LEAVES = 8


def _check(name, t, dtype, shape, device):
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"one_shot_ingest: {name} has dtype {t.dtype}, "
                        f"expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"one_shot_ingest: {name} has shape "
                         f"{tuple(t.shape)}, expected {shape}")
    if t.device != device:
        raise ValueError(f"one_shot_ingest: {name} is on {t.device}, "
                         f"values on {device}")
    if not t.is_contiguous():
        raise ValueError(f"one_shot_ingest: {name} is not contiguous")


def one_shot_ingest(times, stratum_ids, payload, mask, u_accept, u_slot, *,
                    max_time, open_interval, on_time, late, dropped, chunks,
                    items, slot_interval, adopt, counts, capacity, values,
                    counters, span: float,
                    allowed_lateness: float) -> OneShotResult:
    """Ingest one ``[M]`` chunk, or one ``[W, M]`` chunk of W shards, on
    the card, in place.

    ``adopt`` is the ``[S]`` capacity a reset slot adopts, already clamped
    to ``N_max`` by the caller, as the reference's wrapper takes it.
    """
    state = dict(max_time=max_time, open_interval=open_interval,
                 on_time=on_time, late=late, dropped=dropped, chunks=chunks,
                 items=items, slot_interval=slot_interval, adopt=adopt,
                 counts=counts, capacity=capacity, values=values,
                 counters=counters)
    lead = one_shot_lead(times, dict(
        stratum_ids=stratum_ids, payload=payload, mask=mask,
        u_accept=u_accept, u_slot=u_slot, **state))
    k, s_cnt = counts.shape[-2:]
    m = times.shape[-1]
    leaves = check_one_shot_payload(payload, values, m, k, s_cnt, lead)
    dev = leaves[0][1].device
    if not leaves[0][1].is_cuda:
        raise ValueError("one_shot_ingest kernel needs CUDA tensors; "
                         "kernels.ops dispatches CPU tensors")
    n_max = leaves[0][1].shape[-1]
    i32, f32 = torch.int32, torch.float32
    for i, (pay, val) in enumerate(leaves):
        _check(f"values leaf {i}", val, (f32, i32),
               lead + (k, s_cnt, n_max), dev)
        _check(f"payload leaf {i}", pay, val.dtype, lead + (m,), dev)
    _check("times", times, f32, lead + (m,), dev)
    _check("stratum_ids", stratum_ids, i32, lead + (m,), dev)
    _check("mask", mask, torch.bool, lead + (m,), dev)
    _check("u_accept", u_accept, f32, lead + (m,), dev)
    _check("u_slot", u_slot, f32, lead + (m,), dev)
    _check("max_time", max_time, f32, lead, dev)
    for name, t in (("open_interval", open_interval), ("on_time", on_time),
                    ("late", late), ("dropped", dropped),
                    ("chunks", chunks), ("items", items)):
        _check(name, t, i32, lead, dev)
    _check("slot_interval", slot_interval, i32, lead + (k,), dev)
    _check("adopt", adopt, i32, lead + (s_cnt,), dev)
    _check("counts", counts, i32, lead + (k, s_cnt), dev)
    _check("capacity", capacity, i32, lead + (k, s_cnt), dev)
    _check("counters", counters, i32, lead + (6, s_cnt), dev)
    shards = lead[0] if lead else 1
    cells = k * s_cnt
    if cells < 1:
        raise ValueError(f"K*S = {cells}: the ingest needs a cell")
    if cells * n_max + 1 >= 2**31:
        raise ValueError(f"K*S*N_max+1 = {cells * n_max + 1} does not fit "
                         "the kernel's int32 ring index")
    if m >= 2**31:
        raise ValueError(f"M = {m} does not fit an int32 item index")
    lib = _build.build().lib
    recip = np.float32(1.0) / np.float32(span)
    stream = torch.cuda.current_stream(dev).cuda_stream
    plan = _workspace.parted_plan(cells, m) if cells > MAX_CELLS else None
    ws = _workspace.for_call(lib, dev, stream, m=m, cells=cells,
                             table=cells * n_max, aux=cells, plan=plan,
                             shards=shards)
    if plan is not None:
        plan_c, pt = ws.parted(plan, cells=cells, strata=s_cnt,
                               shards=shards)
    ptrs = ctypes.c_void_p * len(leaves)
    pays = ptrs(*(pay.data_ptr() for pay, _ in leaves))
    vals = ptrs(*(val.data_ptr() for _, val in leaves))
    with torch.cuda.device(dev):
        status = lib.sa_one_shot_ingest(
            times.data_ptr(), stratum_ids.data_ptr(), ctypes.addressof(pays),
            mask.data_ptr(), u_accept.data_ptr(), u_slot.data_ptr(),
            max_time.data_ptr(), open_interval.data_ptr(),
            on_time.data_ptr(), late.data_ptr(), dropped.data_ptr(),
            chunks.data_ptr(), items.data_ptr(), slot_interval.data_ptr(),
            adopt.data_ptr(), counts.data_ptr(), capacity.data_ptr(),
            ctypes.addressof(vals), counters.data_ptr(),
            ws.winner.data_ptr(), ws.status.data_ptr(), ws.lists.data_ptr(),
            ws.list_n.data_ptr(), ws.counters.data_ptr(), ws.aux.data_ptr(),
            None if plan is None else ctypes.addressof(plan_c),
            None if plan is None else ctypes.addressof(pt), m, k, s_cnt,
            n_max, len(leaves), shards, ctypes.c_float(float(recip)),
            ctypes.c_float(float(np.float32(allowed_lateness))), stream)
    if status != 0:
        _workspace.drop(dev, stream)
    _build.check(status, "one_shot_ingest")
    one_shot_ingest.launches += 1
    one_shot_ingest.forms["small" if plan is None else "parted"] += 1
    return OneShotResult.of(state)


one_shot_ingest.launches = 0
one_shot_ingest.forms = {"small": 0, "parted": 0}
