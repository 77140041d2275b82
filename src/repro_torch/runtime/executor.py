"""The streaming executors: batched (Spark mode) and pipelined (Flink mode).

Counterpart of the reference's ``runtime/executor.py``. Both executors
share one ingest core (``_ingest_chunk``: watermark routing, ring-slot
reset, the reservoir fold over the flattened ``[K·S]`` (ring slot ×
stratum) cells and the device counters), so their sampling trajectories
are identical chunk for chunk; they differ only in when the core runs
and where the host waits:

* :class:`BatchedExecutor` — chunks accumulate on the host; every
  ``batch_chunks`` arrivals a flush ingests them in order, answers the
  standing queries and applies the controller, then waits once (the
  micro-batch barrier).
* :class:`PipelinedExecutor` — every chunk is ingested as it arrives and
  ``push`` reads no device value back; every ``emit_every`` chunks an
  emission waits, answers the queries and updates the controller.

The ingest has the reference's three paths (``RuntimeConfig.ingest``),
bitwise interchangeable: ``"fused"`` (one fold over the ``K·S`` cells),
``"masked"`` (one fold per ring slot, the proof harness) and
``"onekernel"`` (the whole ingest in one call of the one-shot kernel).
Emission is on chunk cadence or on the watermark (``emission``): under
``"watermark"`` interval ``j`` is answered exactly once, when a host
mirror of the event-time frontier says the watermark passed its close.

Sharding (``num_shards = W > 1``, paper §3.2): each shard holds
reservoirs of ``N_i / W`` and ingests its row of a ``[W, M]`` chunk with
no collective; an emission merges the (shard × interval × stratum)
cells (Eq. 5). Two placements, bitwise interchangeable:

* ``placement="vmap"`` — every state leaf has a leading ``[W]`` axis on
  one device, and one code path runs over that axis: the ``fused``
  ingest is ONE fold over the flattened ``[W·K·S]`` cells (no cell mixes
  shards, so it is bitwise W separate folds), ``onekernel`` one call
  batched over the W shards, ``masked`` one fold call batched over the
  W·K (shard, slot) folds; the emission's merged view is a view of the
  ring. The oracle.
* ``placement="mesh"`` — one process per shard over ``torch.distributed``
  (``launch/mesh.make_stream_mesh``): rank ``r`` holds shard ``r`` as a
  ``[1]``-leading state, ``push`` takes the full ``[W, M]`` chunk and
  ingests row ``r`` with no collective, and each emission and ad hoc
  ``query()`` performs exactly ONE all_gather (``dist.gather_cells``) of
  the cells and of what the record needs from the other shards.

Where the reference's compiled steps donate the state, these executors
update the ``[K, S, N_max]`` ring IN PLACE, and the one-shot kernel also
the cell counters, slot table, watermark scalars and counter rows.

Exactly-once recovery: a ``Checkpointer`` (``runtime/checkpoint.py``)
passed as ``checkpointer=`` snapshots the executor at the end of a push,
after any emission; ``snapshot()`` / ``restore()`` are the hooks, on
every placement. On the mesh a snapshot is a collective (one all_gather
of every rank's shard), so every rank takes it at the same offsets, and
a restore keeps the rank's row of the ``[W]``-leading payload; payloads
move between the placements, and ``checkpoint.migrate`` moves them
between shard counts. A ``Telemetry`` (``obs/metrics.py``) passed as
``telemetry=`` hears every emission, flush, checkpoint and restore, all
where the host already waits.

Retrace sentinels (``obs/sentinel.py``): each step the reference
compiles keeps the input signatures it has run at, and a new one is a
trace of its :class:`~repro_torch.obs.sentinel.RetraceSentinel`, with the
reference's names and budgets: ``pipelined.step`` and ``.emit`` 1,
``{mode}.emit_interval`` and ``{mode}.query`` 1, ``batched.window_step``
0 plus one per new micro-batch count. A trace past the budget warns and
logs a ``retrace`` event, or raises under strict mode.

Refused for size (raises :class:`UnsupportedConfigError`): a ring whose
cells times ``N_max`` do not fit the kernels' int32 ring index. Past the
key counts a block's shared memory holds, each kernel takes its
large-key form, so every other ``W·K·S`` runs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Dict, Iterable, List, Optional, Union

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import distributed as dist
from repro_torch.core import error as err
from repro_torch.core import oasrs
from repro_torch.core import window as win
from repro_torch.kernels import ops
from repro_torch.obs import metrics as obm
from repro_torch.obs.sentinel import (RetraceSentinel, SignatureCache,
                                      signature)
from repro_torch.runtime import controller as ctl
from repro_torch.runtime import watermark as wmk
from repro_torch.runtime.records import TimestampedChunk
from repro_torch.runtime.registry import (EmissionContext,
                                          QueryRegistry, Result)
from repro_torch.utils import DeviceLike, resolve_device

if TYPE_CHECKING:
    from repro_torch.launch.mesh import StreamMesh
    from repro_torch.runtime.checkpoint import (Checkpointer,
                                                RuntimeCheckpoint)

INGEST_PATHS = ("fused", "masked", "onekernel")
EMISSION_MODES = ("cadence", "watermark")
PLACEMENTS = ("vmap", "mesh")


class UnsupportedConfigError(NotImplementedError):
    """A configuration the reference runs but this port does not yet."""


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Static description of one runtime instance (the reference's
    fields)."""
    num_strata: int
    capacity: int                      # per-stratum reservoir capacity N_i
    num_intervals: int = 4             # ring size K (window = K intervals)
    interval_span: float = 1.0         # event-time units per interval
    allowed_lateness: float = 0.5      # watermark lag (event-time units)
    max_capacity: Optional[int] = None  # reservoir allocation N_max
    num_shards: int = 1                # W workers, each with N_i / W
    placement: str = "vmap"            # one of PLACEMENTS
    controller: ctl.ControllerConfig = ctl.ControllerConfig()
    accuracy_query: Optional[str] = None
    batch_chunks: int = 4              # batched: chunks per flush
    max_batch_chunks: int = 32
    emit_every: int = 4                # pipelined cadence: chunks/emission
    backend: Optional[str] = None      # see check_supported
    ingest: str = "fused"              # one of INGEST_PATHS
    emission: str = "cadence"          # one of EMISSION_MODES


def check_supported(cfg: RuntimeConfig) -> None:
    """Raise on a configuration outside the port."""
    if cfg.num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {cfg.num_shards}")
    if cfg.placement not in PLACEMENTS:
        raise ValueError(f"unknown placement {cfg.placement!r}; expected "
                         "'vmap' or 'mesh'")
    if cfg.placement == "mesh" and cfg.num_shards < 2:
        raise ValueError(
            "placement='mesh' deploys one process per shard; it needs "
            f"num_shards > 1 (got {cfg.num_shards}); use the default "
            "placement='vmap' for single-shard runs")
    if cfg.ingest not in INGEST_PATHS:
        raise ValueError(f"unknown ingest path {cfg.ingest!r}; one of "
                         f"{INGEST_PATHS}")
    # The reference's ``backend`` forces its fold ("jnp" | "pallas") or
    # leaves the choice to the platform (None | "auto"). The port always
    # chooses by the tensors' device: the CUDA kernel on the card, the
    # plain version on the CPU. So only the platform's choice converts.
    if cfg.backend in ("jnp", "pallas"):
        raise UnsupportedConfigError(
            f"backend={cfg.backend!r}: the port picks the fold by device "
            "and has no forced route; use None or 'auto'")
    if cfg.backend not in (None, "auto"):
        raise ValueError(f"unknown backend {cfg.backend!r}; one of "
                         "None, 'auto', 'jnp', 'pallas'")


def _check_kernel_limits(cfg: RuntimeConfig, n_max: int) -> None:
    """The kernels' one limit per launch, checked before any state exists:
    the ring index of every cell a fold or one-shot call takes must fit
    int32. The CPU's plain versions have no limit, but the check is the
    same on every device, so that the CPU refuses what the card cannot
    run: the fused fold takes every cell of the state (all W shards' on
    the vmap placement, one shard's on a mesh rank), the one-shot one
    shard's ``K·S``, the masked path's one call each of its W·K folds'
    ``S`` (a batched call's limit is its fold's). Past the key counts
    shared memory holds (the fold's and one-shot's 1,024 cells, the stats'
    512 rows, the histogram's 3,200 keys), each kernel takes its large-key
    form, so no other count is refused."""
    cells = cfg.num_intervals * cfg.num_strata
    if cfg.ingest == "fused" and cfg.placement == "vmap":
        cells *= cfg.num_shards
    if cfg.ingest == "masked":
        cells = cfg.num_strata
    if cells * n_max + 1 >= 2 ** 31:
        raise UnsupportedConfigError(
            f"ingest={cfg.ingest!r}: {cells} cells x N_max {n_max} + 1 = "
            f"{cells * n_max + 1} does not fit the kernel's int32 ring "
            "index (limit 2**31)")


@dataclasses.dataclass
class RuntimeState:
    """Device-resident runtime state (every leaf with a leading shard
    axis when sharded)."""
    window: win.WindowState       # ring of K per-interval OASRS states
    slot_interval: torch.Tensor   # [K] i32 — event interval held per slot
    open_interval: torch.Tensor   # () i32 — newest interval seen
    wm: wmk.WatermarkState
    ctrl: ctl.ControllerState
    metrics: obm.MetricsState


@dataclasses.dataclass
class Emission:
    """One emission: query answers + watermark accounting."""
    index: int
    results: Dict[str, Result]
    watermark: float
    open_interval: int
    on_time: int
    late: int
    dropped: int
    capacity: np.ndarray          # [S] i32 controller capacity after update
    #                               (summed over shards)
    latency_s: float              # measured latency fed back
    items: int                    # items pushed since previous emission
    interval: Optional[int] = None  # watermark emission: the interval it
    #                                 closed (None under cadence)


def init_state(cfg: RuntimeConfig, key: torch.Tensor,
               device: DeviceLike = None,
               shard: Optional[int] = None) -> RuntimeState:
    """Fresh runtime state on ``device`` (``None`` means the card).

    Sharded, shard ``w`` starts from key ``split(key, W)[w]`` with the
    per-shard capacity ``split_capacity(capacity, W)``; ``shard`` builds
    that one shard as a ``[1]``-leading state (a mesh rank's), otherwise
    all W are stacked.
    """
    dev = resolve_device(device)
    check_supported(cfg)
    k, s = cfg.num_intervals, cfg.num_strata
    cap = torch.full((s,), cfg.capacity, dtype=torch.int32, device=dev)
    if cfg.num_shards > 1:
        # Paper §3.2: each of W workers holds reservoirs of N_i / W.
        cap = dist.split_capacity(cap, cfg.num_shards)
    max_cap = cfg.max_capacity
    if max_cap is None:
        max_cap = cfg.capacity                  # the largest entry of cap
        if cfg.num_shards > 1:
            max_cap = max(-(-cfg.capacity // cfg.num_shards), 1)
        if cfg.controller.budget is not None:
            # The accuracy feedback may raise capacity to the budget's
            # ceiling; N_max must cover it (capacity <= N_max).
            max_cap = max(max_cap, cfg.controller.budget.max_per_stratum)
    _check_kernel_limits(cfg, max_cap)
    keys = key.to(dev)
    if cfg.num_shards > 1:
        keys = prng.split(keys, cfg.num_shards)
        if shard is not None:
            keys = keys[shard:shard + 1]
    lead = tuple(keys.shape[:-1])
    slots = torch.arange(k, dtype=torch.int32, device=dev)
    return RuntimeState(
        window=win.init(k, s, cap, keys, max_capacity=max_cap, device=dev),
        slot_interval=(-torch.remainder(-slots, k)).expand(
            lead + (k,)).clone(),                    # intervals 1-K ... 0
        open_interval=torch.zeros(lead, dtype=torch.int32, device=dev),
        wm=wmk.init(dev, lead),
        ctrl=ctl.init(cap.expand(lead + (s,))),
        metrics=obm.init(s, dev, lead))


def _shards(state: RuntimeState) -> int:
    """Shards a state holds on its leading axis (1 for an unsharded
    state)."""
    lead = state.slot_interval.shape[:-1]
    return lead[0] if lead else 1


# ---------------------------------------------------------------------------
# The ingest.
# ---------------------------------------------------------------------------

def _route_and_reset(cfg: RuntimeConfig, state: RuntimeState,
                     chunk: TimestampedChunk):
    """Advance the watermark and reassign ring slots.

    Interval ``j`` lives in slot ``j mod K``; a slot whose occupant
    changed has its counts zeroed and adopts the controller's capacity,
    clamped to ``N_max``.
    """
    k = cfg.num_intervals
    r = wmk.route_chunk(state.wm, state.open_interval, chunk.times,
                        chunk.mask, cfg.interval_span, cfg.allowed_lateness,
                        k)
    slots = torch.arange(k, dtype=torch.int32, device=chunk.times.device)
    new_open = r.open_interval[..., None]
    desired = new_open - torch.remainder(new_open - slots, k)
    reset = (desired != state.slot_interval)[..., None]
    iv = state.window.intervals
    adopt = torch.clamp(state.ctrl.capacity, max=iv.max_capacity)
    iv = dataclasses.replace(
        iv, counts=torch.where(reset, 0, iv.counts),
        capacity=torch.where(reset, adopt[..., None, :], iv.capacity))
    return r, iv, desired


def _finish_ingest(cfg: RuntimeConfig, state: RuntimeState,
                   chunk: TimestampedChunk, r, iv, desired,
                   counts_before) -> RuntimeState:
    k = cfg.num_intervals
    window = win.WindowState(
        intervals=iv, cursor=torch.remainder(r.open_interval + 1, k),
        filled=torch.clamp(r.open_interval + 1, max=k))
    metrics = obm.ingest_update(
        state.metrics, cfg.num_strata, chunk.stratum_ids, chunk.mask,
        r.accept, r.target_interval, state.open_interval, counts_before,
        iv.counts, iv.capacity)
    return RuntimeState(window=window, slot_interval=desired,
                        open_interval=r.open_interval, wm=r.wm,
                        ctrl=state.ctrl, metrics=metrics)


def _draw_uniforms(iv: oasrs.OASRSState, m: int):
    """The fold's key schedule on each ring's lead key: split three ways,
    two ``[M]`` uniforms per shard (one draw over every shard's keys);
    returns the ring keys with the lead advanced."""
    keys = prng.split(iv.key[..., 0, :], 3)
    u_accept = prng.uniform(keys[..., 1, :], m)
    u_slot = prng.uniform(keys[..., 2, :], m)
    ring_keys = torch.cat([keys[..., 0:1, :], iv.key[..., 1:, :]], dim=-2)
    return ring_keys, u_accept, u_slot


def _ingest_chunk(cfg: RuntimeConfig, state: RuntimeState,
                  chunk: TimestampedChunk) -> RuntimeState:
    """Fold one chunk (``[W, M]`` for a sharded state) by the configured
    ingest path. No path performs a collective."""
    if cfg.ingest == "masked":
        return _ingest_chunk_masked(cfg, state, chunk)
    if cfg.ingest == "onekernel":
        return _ingest_chunk_onekernel(cfg, state, chunk)
    return _ingest_chunk_fused(cfg, state, chunk)


def _ingest_chunk_fused(cfg: RuntimeConfig, state: RuntimeState,
                        chunk: TimestampedChunk) -> RuntimeState:
    """Fold one chunk: route, reset slots, one fold over every cell.

    Each accepted item is routed once to its (slot, stratum) cell: its
    rank within that cell equals its rank within the stratum of its
    interval, so the flat fold is Algorithm 1 per cell. Sharded, the
    cells are ``[W·K·S]``, cell ``w·K·S + slot·S + s``, and the items
    ``[W·M]`` in shard-major order with each shard's own uniforms: no
    cell mixes shards, so the one fold is bitwise W separate folds. The
    ring's flat form is a VIEW of it: the fold writes the ring in place.
    """
    k, s_cnt = cfg.num_intervals, cfg.num_strata
    w = _shards(state)
    r, iv, desired = _route_and_reset(cfg, state, chunk)
    counts_before = iv.counts
    tgt_slot = torch.remainder(r.target_interval, k)
    live = r.accept & (torch.gather(desired, -1, tgt_slot.long())
                       == r.target_interval)
    flat_sid = tgt_slot * s_cnt + chunk.stratum_ids.to(torch.int32)
    if flat_sid.dim() > 1:
        shard = torch.arange(w, dtype=torch.int32, device=flat_sid.device)
        flat_sid = flat_sid + (shard * (k * s_cnt))[:, None]
    ring = iv.values.view(w * k * s_cnt, iv.max_capacity)
    if ring.data_ptr() != iv.values.data_ptr():
        raise RuntimeError("flattened ring is not a view of the ring")
    keys, u_accept, u_slot = _draw_uniforms(iv, chunk.times.shape[-1])
    flat = oasrs.OASRSState(values=ring, counts=iv.counts.reshape(-1),
                            capacity=iv.capacity.reshape(-1),
                            key=keys)
    counts = oasrs.apply_chunk_uniforms(
        flat, flat_sid.reshape(-1), chunk.values.reshape(-1),
        live.reshape(-1), u_accept.reshape(-1), u_slot.reshape(-1)).counts
    iv = dataclasses.replace(iv, counts=counts.view(iv.counts.shape),
                             key=keys)
    return _finish_ingest(cfg, state, chunk, r, iv, desired, counts_before)


def _ingest_chunk_masked(cfg: RuntimeConfig, state: RuntimeState,
                         chunk: TimestampedChunk) -> RuntimeState:
    """Fold every ring slot's masked view of the chunk: W·K folds of M
    items (each shard's chunk row into each of its K slots), in ONE call
    batched over the ``[W, K]`` folds, as the reference's nested ``vmap``
    of its kernel over the slots and the shards is one program. Slot
    ``j``'s mask is ``accept & (target == desired[j])``, as the
    reference builds it, and the uniforms are the fused path's: each item
    is masked into exactly one slot, so the state is bitwise the fused
    path's. The call writes the ``[W, K, S, N_max]`` view of the ring in
    place; an unsharded state is ``W = 1``, a mesh rank's
    ``[1]``-leading state its own."""
    k, s_cnt = cfg.num_intervals, cfg.num_strata
    w = _shards(state)
    r, iv, desired = _route_and_reset(cfg, state, chunk)
    counts_before = iv.counts
    m = chunk.times.shape[-1]
    keys, u_accept, u_slot = _draw_uniforms(iv, m)

    def rows(t, *tail):
        return t.reshape((w,) + tail)
    slot_masks = (rows(r.accept, m)[:, None, :]
                  & (rows(r.target_interval, m)[:, None, :]
                     == rows(desired, k)[:, :, None]))        # [W, K, M]
    ring = iv.values.view(w, k, s_cnt, iv.max_capacity)
    folds = oasrs.OASRSState(values=ring, counts=rows(iv.counts, k, s_cnt),
                             capacity=rows(iv.capacity, k, s_cnt),
                             key=keys)
    counts = oasrs.apply_chunk_uniforms(
        folds, rows(chunk.stratum_ids, m), rows(chunk.values, m),
        slot_masks, rows(u_accept, m), rows(u_slot, m)).counts
    iv = dataclasses.replace(iv, counts=counts.view(iv.counts.shape),
                             key=keys)
    return _finish_ingest(cfg, state, chunk, r, iv, desired, counts_before)


def _ingest_chunk_onekernel(cfg: RuntimeConfig, state: RuntimeState,
                            chunk: TimestampedChunk) -> RuntimeState:
    """The whole ingest in ONE call of the one-shot kernel (its plain
    version on the CPU), with the fused path's key schedule: bitwise the
    fused path's state.

    The call is batched over the state's W shards (an unsharded state is
    one, a mesh rank's ``[1]``-leading state its own): the reference's
    ``vmap`` of its kernel, one call whose launches take the shard as a
    grid axis. It updates IN PLACE the ``[W, ...]`` ring, cell counts and
    capacities, slot tables, watermark scalars, chunk/item totals and a
    ``[W, 6, S]`` stack of the counter rows, which is then split into
    rows of their own; the ring is checked once to have been written in
    place. Each shard's result is bit for bit its own unbatched call's.
    """
    k, s_cnt = cfg.num_intervals, cfg.num_strata
    w = _shards(state)
    iv, wm, mt = state.window.intervals, state.wm, state.metrics
    m = chunk.times.shape[-1]
    keys, u_accept, u_slot = _draw_uniforms(iv, m)
    adopt = torch.clamp(state.ctrl.capacity, max=iv.max_capacity)
    counters = obm.stack_counters(mt)

    def rows(t, *tail):
        return t.view((w,) + tail)
    sid = chunk.stratum_ids.to(torch.int32)
    args = [rows(t, m) for t in (chunk.times, sid, chunk.values,
                                 chunk.mask, u_accept, u_slot)]
    carried = dict(
        max_time=rows(wm.max_time), open_interval=rows(state.open_interval),
        on_time=rows(wm.on_time), late=rows(wm.late),
        dropped=rows(wm.dropped), chunks=rows(mt.chunks),
        items=rows(mt.items), slot_interval=rows(state.slot_interval, k),
        adopt=rows(adopt, s_cnt), counts=rows(iv.counts, k, s_cnt),
        capacity=rows(iv.capacity, k, s_cnt),
        values=rows(iv.values, k, s_cnt, iv.max_capacity),
        counters=rows(counters, 6, s_cnt))
    out = ops.one_shot_ingest(*args, **carried, span=cfg.interval_span,
                              allowed_lateness=cfg.allowed_lateness)
    if out.values.data_ptr() != carried["values"].data_ptr():
        raise RuntimeError("one-shot ingest did not write the ring in place")
    window = win.WindowState(
        intervals=oasrs.OASRSState(values=iv.values, counts=iv.counts,
                                   capacity=iv.capacity, key=keys),
        cursor=torch.remainder(state.open_interval + 1, k),
        filled=torch.clamp(state.open_interval + 1, max=k))
    metrics = obm.unstack_counters(counters, chunks=mt.chunks,
                                   items=mt.items)
    return RuntimeState(window=window, slot_interval=state.slot_interval,
                        open_interval=state.open_interval, wm=wm,
                        ctrl=state.ctrl, metrics=metrics)


# ---------------------------------------------------------------------------
# The emission.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _GatherAux:
    """What the mesh emission needs from every shard besides its cells,
    carried by the emission's one all_gather (the reference's
    ``_GatherAux`` and what its host record reads from the global
    state): ``[W]``-leading rows, shard ``w``'s in row ``w``."""
    lead_key: torch.Tensor        # [2] shard 0's interval-0 ring key
    slot_interval: torch.Tensor   # [W, K] i32
    live: torch.Tensor            # [W, K] bool ring liveness
    counts_pos: torch.Tensor      # [W, K, S] bool raw cell counts > 0
    wm: wmk.WatermarkState        # [W] frontier and accounting
    open_interval: torch.Tensor   # [W] i32
    ctrl: ctl.ControllerState     # [W] rows, before this emission's step
    latency: torch.Tensor         # [W] f32 latency each rank measured


def _words(*parts: torch.Tensor) -> torch.Tensor:
    """Flat i32 words of i32 / f32 / bool / u32-in-i64 tensors (floats by
    their bit patterns)."""
    out = []
    for p in parts:
        p = p.reshape(-1)
        if p.dtype == torch.float32:
            p = p.contiguous().view(torch.int32)
        out.append(p.to(torch.int32))
    return torch.cat(out)


def _pack_aux(cfg: RuntimeConfig, state: RuntimeState,
              latency: float) -> torch.Tensor:
    """This rank's aux words (its state is ``[1]``-leading)."""
    window = state.window
    lat = torch.full((1,), latency, dtype=torch.float32,
                     device=state.open_interval.device)
    return _words(window.intervals.key[0, 0], state.slot_interval[0],
                  win._live_mask(window)[0], window.intervals.counts[0] > 0,
                  state.wm.max_time, state.wm.on_time, state.wm.late,
                  state.wm.dropped, state.open_interval,
                  state.ctrl.capacity[0], state.ctrl.base_capacity[0],
                  state.ctrl.latency_ema, state.ctrl.pressure, lat)


def _unpack_aux(cfg: RuntimeConfig, aux_all: torch.Tensor) -> _GatherAux:
    k, s = cfg.num_intervals, cfg.num_strata
    w = aux_all.shape[0]
    words = aux_all.to(torch.int32)
    at = [0]

    def take(n, dtype=torch.int32):
        part = words[:, at[0]:at[0] + n]
        at[0] += n
        if dtype == torch.float32:
            return part.contiguous().view(torch.float32)
        return part if dtype == torch.int32 else part.to(dtype)
    lead_key = aux_all[0, :2]
    at[0] = 2
    slot_interval, live = take(k), take(k, torch.bool)
    counts_pos = take(k * s, torch.bool).view(w, k, s)
    max_time, on_time, late, dropped, open_iv = (
        take(1, torch.float32), take(1), take(1), take(1), take(1))
    cap, base = take(s), take(s)
    ema, pressure, latency = (take(1, torch.float32) for _ in range(3))
    return _GatherAux(
        lead_key=lead_key, slot_interval=slot_interval, live=live,
        counts_pos=counts_pos,
        wm=wmk.WatermarkState(max_time=max_time[:, 0],
                              on_time=on_time[:, 0], late=late[:, 0],
                              dropped=dropped[:, 0]),
        open_interval=open_iv[:, 0],
        ctrl=ctl.ControllerState(capacity=cap, base_capacity=base,
                                 latency_ema=ema[:, 0],
                                 pressure=pressure[:, 0]),
        latency=latency[:, 0])


def _merged_view(cfg: RuntimeConfig, state: RuntimeState,
                 mesh: Optional["StreamMesh"] = None, latency: float = 0.0):
    """The merged view (the ``K·S`` cells, or the ``W·K·S`` cells of
    every shard) and, on the mesh, the gathered aux (one all_gather),
    else ``None``."""
    if mesh is None:
        return win.sample_view(state.window), None
    view, aux_all = dist.gather_cells(
        win.sample_view(state.window), _pack_aux(cfg, state, latency),
        num_shards=cfg.num_shards)
    return view, _unpack_aux(cfg, aux_all)


def _view_stats(view) -> err.StratumStats:
    """The shared sample pass's stats (one kernel)."""
    return err.stratum_stats_from_sample(view.values, view.counts,
                                         view.taken, view.slot_mask())


def _emission_key(state: RuntimeState,
                  aux: Optional[_GatherAux] = None) -> torch.Tensor:
    """The bootstrap key of a cadence emission: shard 0's interval-0 ring
    key folded with ``0xE717`` (the reference's ``_emission_key``)."""
    lead = (aux.lead_key if aux is not None
            else state.window.intervals.key.reshape(-1, 2)[0])
    return prng.fold_in(lead, 0xE717)


def _window_ctx(cfg: RuntimeConfig, state: RuntimeState, view,
                aux: Optional[_GatherAux] = None) -> EmissionContext:
    """The cell structure the per-key and session windows evaluate
    against: the slots' event intervals and the live cells with items.
    Every shard holds the same slot table (all shards see the same
    event-time ramp), so a sharded state reads shard 0's, with the
    activity pooled over the shards."""
    if cfg.num_shards == 1:
        slot_interval = state.slot_interval
        activity = win.activity_mask(state.window)
    elif aux is not None:
        slot_interval = aux.slot_interval[0]
        activity = aux.live[0][:, None] & torch.any(aux.counts_pos, dim=0)
    else:
        slot_interval = state.slot_interval[0]
        activity = win._live_mask(state.window)[0][:, None] & torch.any(
            state.window.intervals.counts > 0, dim=0)
    return EmissionContext(
        num_strata=cfg.num_strata, num_shards=cfg.num_shards,
        interval_span=cfg.interval_span, slot_interval=slot_interval,
        activity=activity, view=view)


def _evaluate_merged(cfg: RuntimeConfig, registry: QueryRegistry,
                     state: RuntimeState,
                     mesh: Optional["StreamMesh"] = None,
                     latency: float = 0.0):
    """Every standing query on the current state: ``(results, stats,
    aux)``, ``aux`` being the mesh's gathered aux (else ``None``)."""
    view, aux = _merged_view(cfg, state, mesh, latency)
    stats = _view_stats(view)
    results = registry.evaluate_view(view, stats, _emission_key(state, aux),
                                     ctx=_window_ctx(cfg, state, view, aux))
    return results, stats, aux


def _evaluate(cfg: RuntimeConfig, registry: QueryRegistry,
              state: RuntimeState):
    """Every standing query on a state of this process: ``(results,
    stats)``."""
    return _evaluate_merged(cfg, registry, state)[:2]


def _interval_cell_mask(cfg: RuntimeConfig, state: RuntimeState,
                        interval: int,
                        aux: Optional[_GatherAux] = None) -> torch.Tensor:
    """Cell mask of one event interval in the merged view's order: slot
    ``interval mod K``, and only while the slot still HOLDS that interval
    (a recycled slot never leaks its new occupant), per shard."""
    k, s = cfg.num_intervals, cfg.num_strata
    slot = interval % k
    cells = torch.arange(k * s, dtype=torch.int32,
                         device=state.slot_interval.device)
    sel = (cells // s) == slot
    if cfg.num_shards == 1:
        return sel & (state.slot_interval[slot] == interval)
    table = aux.slot_interval if aux is not None else state.slot_interval
    holds = table[:, slot] == interval                       # [W]
    return (holds[:, None] & sel[None, :]).reshape(-1)


def _evaluate_interval(cfg: RuntimeConfig, registry: QueryRegistry,
                       state: RuntimeState, interval: int,
                       base_key: torch.Tensor,
                       mesh: Optional["StreamMesh"] = None,
                       latency: float = 0.0):
    """Watermark emission body: every standing query on the CLOSED
    interval's cells (merged kinds and per-key panes restrict to it;
    session windows read the full ring through the context, limited to
    intervals up to the closing one, since open intervals still fill).

    ``base_key`` is folded with the interval id, not with the ring's lead
    key, whose fold count depends on how many chunks an executor had
    ingested when it emitted: both executors draw the same bootstrap
    bits for the same interval.
    """
    view, aux = _merged_view(cfg, state, mesh, latency)
    ctx = _window_ctx(cfg, state, view, aux)
    ctx.activity = ctx.activity & (ctx.slot_interval <= interval)[:, None]
    iview = win.restrict_view(view, _interval_cell_mask(cfg, state,
                                                        interval, aux))
    istats = _view_stats(iview)
    results = registry.evaluate_view(iview, istats,
                                     prng.fold_in(base_key, interval),
                                     ctx=ctx)
    return results, istats, aux


def _pooled_stats(cfg: RuntimeConfig,
                  stats: err.StratumStats) -> err.StratumStats:
    """Pool the interval × stratum cells per stratum (``[K·S] → [S]``;
    sharded ``[W·K·S] → [W, S]``, each shard's own window)."""
    k, s = cfg.num_intervals, cfg.num_strata

    def pool(leaf):
        if cfg.num_shards > 1:
            return leaf.reshape(cfg.num_shards, k, s).sum(dim=1,
                                                          dtype=leaf.dtype)
        return leaf.reshape(k, s).sum(dim=0, dtype=leaf.dtype)

    return err.StratumStats(counts=pool(stats.counts),
                            taken=pool(stats.taken), sums=pool(stats.sums),
                            sumsqs=pool(stats.sumsqs))


def _controller_step(cfg: RuntimeConfig, ctrl: ctl.ControllerState,
                     results, stats: err.StratumStats,
                     latency_s: torch.Tensor,
                     intervals: Optional[int] = None) -> ctl.ControllerState:
    """One controller step; ``intervals`` (default K) turns the window's
    allocation into the per-interval capacity. Sharded, every shard's
    controller takes its own pooled row and the global realized width."""
    realized = None
    if cfg.controller.budget is not None:
        realized = (results[cfg.accuracy_query] if cfg.accuracy_query
                    else err.estimate_mean(stats))
    k = cfg.num_intervals if intervals is None else intervals
    return ctl.update(ctrl, cfg.controller, _pooled_stats(cfg, stats),
                      realized, latency_s, intervals=k)


# ---------------------------------------------------------------------------
# The executors.
# ---------------------------------------------------------------------------

class _ExecutorBase:
    """Shared plumbing: state, emission bookkeeping, the watermark mirror,
    ad hoc queries."""

    mode = "base"

    def __init__(self, cfg: RuntimeConfig, registry: QueryRegistry,
                 key: torch.Tensor, device: DeviceLike = None, *,
                 checkpointer: Optional["Checkpointer"] = None,
                 telemetry: Optional[obm.Telemetry] = None):
        check_supported(cfg)
        self.mesh: Optional["StreamMesh"] = None
        if cfg.placement == "mesh":
            from repro_torch.launch import mesh as lmesh
            self.mesh = lmesh.make_stream_mesh(cfg.num_shards)
            if device is None:
                device = f"cuda:{self.mesh.rank}"
        self.device = resolve_device(device)
        if len(registry) == 0:
            raise ValueError("register at least one standing query")
        if cfg.emission not in EMISSION_MODES:
            raise ValueError(f"unknown emission mode {cfg.emission!r}; "
                             f"expected one of {EMISSION_MODES}")
        if cfg.emission == "watermark" and (
                cfg.allowed_lateness
                >= (cfg.num_intervals - 1) * cfg.interval_span):
            raise ValueError(
                "emission='watermark' needs allowed_lateness < "
                "(num_intervals - 1) * interval_span (got lateness="
                f"{cfg.allowed_lateness} vs "
                f"{(cfg.num_intervals - 1) * cfg.interval_span}): an "
                "interval must close while its slot is still in the ring, "
                "or its answers would be evicted before they were emitted")
        if cfg.accuracy_query is not None:
            match = [q for q in registry.queries
                     if q.name == cfg.accuracy_query]
            if not match:
                raise ValueError(f"accuracy_query {cfg.accuracy_query!r} "
                                 "is not registered")
            if match[0].kind not in ("sum", "mean", "count"):
                raise ValueError(
                    f"accuracy_query {cfg.accuracy_query!r} has kind "
                    f"{match[0].kind!r}; the controller's feedback needs a "
                    "scalar linear estimate (sum/mean/count)")
            if match[0].window != "merged":
                raise ValueError(
                    f"accuracy_query {cfg.accuracy_query!r} has window "
                    f"{match[0].window!r}; the controller's feedback needs "
                    "a scalar estimate")
        self.cfg = cfg
        self.registry = registry
        registry.freeze()
        self.checkpointer: Optional["Checkpointer"] = None
        self.telemetry: Optional[obm.Telemetry] = None
        # One retrace sentinel per step the reference compiles, with its
        # budget: a step run at a new input signature is a trace.
        self._sentinels: Dict[str, RetraceSentinel] = {}
        self._signatures: Dict[str, SignatureCache] = {}
        if cfg.emission == "watermark":
            self._sentinel("emit_interval", allowed=1)
        self._sentinel("query", allowed=1)
        self._make_sentinels()
        self.reset(key)
        self.checkpointer = checkpointer
        if telemetry is not None:
            self.attach_telemetry(telemetry)

    @property
    def _watermark_mode(self) -> bool:
        return self.cfg.emission == "watermark"

    def _make_sentinels(self) -> None:
        """The mode's own steps' sentinels."""

    def _sentinel(self, name: str, allowed: int) -> RetraceSentinel:
        s = RetraceSentinel(f"{self.mode}.{name}", allowed=allowed,
                            on_violation=self._on_retrace)
        self._sentinels[name] = s
        self._signatures[name] = SignatureCache(s)
        return s

    def _on_retrace(self, name: str, traces: int, allowed: int) -> None:
        if self.telemetry is not None:
            self.telemetry.on_retrace(name, traces, allowed)

    def _run_at(self, step: str, *inputs) -> None:
        """Step ``step`` runs on the state and ``inputs``: a new
        signature is a trace of its sentinel."""
        self._signatures[step].see((self._state_sig,) + signature(*inputs))

    @property
    def emit_trace_count(self) -> int:
        """Traces of the per-interval-close emission step (watermark
        mode): 1 after warmup, forever."""
        s = self._sentinels.get("emit_interval")
        return 0 if s is None else s.traces

    def reset(self, key: torch.Tensor) -> None:
        """Restart on a fresh stream."""
        w = self.cfg.num_shards
        self.state = init_state(self.cfg, key, self.device,
                                None if self.mesh is None else
                                self.mesh.rank)
        self._state_sig = signature(self.state)
        self.emissions: List[Emission] = []
        self.chunks_pushed = 0
        self._emission_cursor = 0
        self._items_since_emit = 0
        self._last_latency = 0.0
        # The controller rows of every shard after the last emission
        # (the mesh's come from its gather; the telemetry reads them).
        self._ctrl_rows = self.state.ctrl
        # Watermark emission, host side: the per-interval base key (folded
        # with each closed interval's id for its bootstrap draws), the
        # frontier mirror (one entry per shard, advanced from chunk times,
        # never from the in-flight state) and the exactly-once
        # emitted-through cursor.
        self._emit_base_key = prng.fold_in(key.to(self.device), 0xE31)
        self._host_frontier = np.full((w,), wmk.NEG_TIME, np.float32)
        self._emitted_through = -1
        self.mirror_wait_s = 0.0      # host time spent on the mirror read
        if self.device.type == "cuda":
            self._mirror_host = torch.empty(() if w == 1 else (w,),
                                            dtype=torch.float32,
                                            pin_memory=True)
            self._mirror_event = torch.cuda.Event()
        if self.checkpointer is not None:
            # A new stream: the old one's snapshots must not be recovered
            # into it (the offset dedupe would even skip re-saving).
            self.checkpointer.clear()

    def attach_telemetry(self, telemetry: obm.Telemetry) -> None:
        """Attach (or swap) the host telemetry hub; logs one ``run_meta``
        event describing this executor."""
        self.telemetry = telemetry
        if telemetry.strict_retrace is not None:
            for s in self._sentinels.values():
                s.strict = telemetry.strict_retrace
        telemetry.on_run_meta(self)

    def snapshot(self) -> "RuntimeCheckpoint":
        """A complete checkpoint of this executor (the state copied to
        the host and the host cursors). Waits for the card: take it at a
        chunk boundary, like an emission. On the mesh every rank calls
        it (one all_gather) and gets the same ``[W]``-leading
        checkpoint."""
        from repro_torch.runtime import checkpoint as ckp
        return ckp.capture(self)

    def payload_template(self) -> RuntimeState:
        """The state a payload of this executor holds: its own, or on the
        mesh every shard's (``[W]``-leading tensors on the meta device,
        shapes and dtypes only)."""
        if self.mesh is None:
            return self.state
        from repro_torch.runtime import convert
        w = self.cfg.num_shards
        return convert.map_leaves(self.state, lambda _p, t: torch.empty(
            (w,) + tuple(t.shape[1:]), dtype=t.dtype, device="meta"))

    def restore(self, ckpt) -> "RuntimeCheckpoint":
        """Restore a :class:`RuntimeCheckpoint` or its payload bytes, then
        replay the chunks from ``ckpt.stream_offset``: the continuation is
        the uninterrupted run's, bit for bit. Returns the checkpoint."""
        from repro_torch.runtime import checkpoint as ckp
        t0 = time.perf_counter()
        if isinstance(ckpt, (bytes, bytearray)):
            ckpt = ckp.from_bytes(bytes(ckpt), self.payload_template())
        ckp.restore_into(self, ckpt)
        self._sync()
        if self.telemetry is not None:
            self.telemetry.on_checkpoint_restore(
                ckpt.stream_offset, time.perf_counter() - t0)
        return ckpt

    def resume(self, state: RuntimeState, chunks_pushed: int,
               emissions_done: int, *, emitted_through: int = -1,
               emit_base_key=None, items_since_emit: int = 0,
               last_latency: float = 0.0) -> None:
        """Continue a stream from a state carried over at a chunk boundary
        (a flush boundary for the batched executor), e.g. converted from
        the reference by ``runtime/convert.py`` or restored from a
        checkpoint: the next emission gets index ``emissions_done``.
        Under watermark emission ``emitted_through`` and
        ``emit_base_key`` (two u32 words) carry the host cursors; the
        frontier mirror restarts from the state's frontier (one entry
        per shard), as the reference's restore does.

        On the mesh ``state`` holds every shard (``[W]``-leading, on any
        device): each rank checks its leaves' shapes and keeps its own
        row, in a fresh allocation on its device."""
        every = state
        if self.mesh is not None:
            state = self._own_row(every)
        self.state = state
        self._state_sig = signature(state)
        self._ctrl_rows = every.ctrl
        # A copy: on the CPU ``numpy()`` shares the state's buffer, which
        # the one-shot ingest updates in place.
        self._host_frontier = every.wm.max_time.cpu().numpy().reshape(
            -1).copy()
        self.chunks_pushed = chunks_pushed
        self._emission_cursor = emissions_done
        self._items_since_emit = items_since_emit
        self._last_latency = last_latency
        self._emitted_through = emitted_through
        if emit_base_key is not None:
            self._emit_base_key = torch.as_tensor(
                np.asarray(emit_base_key, np.int64), device=self.device)

    def _own_row(self, state: RuntimeState) -> RuntimeState:
        """This mesh rank's row of an every-shard state, each leaf checked
        against the rank's own and copied to its device."""
        from repro_torch.runtime import convert
        own = dict(convert.named_leaves(self.state))
        r, w = self.mesh.rank, self.cfg.num_shards

        def row(path, t):
            want = (w,) + tuple(own[path].shape[1:])
            if tuple(t.shape) != want or t.dtype != own[path].dtype:
                raise ValueError(
                    f"state leaf {path} is {tuple(t.shape)} {t.dtype}; a "
                    f"rank of this mesh resumes from every shard's state, "
                    f"{want} {own[path].dtype}")
            return t[r:r + 1].to(self.device, copy=True)
        return convert.map_leaves(state, row)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, chunks: Iterable[TimestampedChunk]) -> List[Emission]:
        for c in chunks:
            self.push(c)
        return self.finalize()

    def push(self, chunk: TimestampedChunk) -> None:
        raise NotImplementedError

    def finalize(self) -> List[Emission]:
        raise NotImplementedError

    def query(self) -> Dict[str, Result]:
        """Every standing query on the current state (ad hoc: no
        controller feedback, no emission record). On the mesh every rank
        calls it: one all_gather."""
        self._run_at("query")
        return _evaluate_merged(self.cfg, self.registry, self.state,
                                self.mesh, self._last_latency)[0]

    def _ingest(self, chunk: TimestampedChunk) -> None:
        """Ingest one arrival unit: on the mesh, this rank's row of the
        full ``[W, M]`` chunk (a ``[1, M]`` view)."""
        if self.mesh is not None:
            r = self.mesh.rank
            chunk = TimestampedChunk(
                *(getattr(chunk, f.name)[r:r + 1]
                  for f in dataclasses.fields(TimestampedChunk)))
        self.state = _ingest_chunk(self.cfg, self.state, chunk)

    # -- the controller and the record --------------------------------------

    def _step_controller(self, results, stats: err.StratumStats,
                         aux: Optional[_GatherAux], latency_s: float,
                         intervals: Optional[int] = None
                         ) -> ctl.ControllerState:
        """One controller step; returns every shard's controller after
        it. On the mesh each rank steps all W controllers from the
        gathered rows, with rank 0's latency, the same bits everywhere,
        and keeps its own row."""
        if aux is None:
            lat = torch.tensor(latency_s, dtype=torch.float32,
                               device=self.device)
            ctrl = _controller_step(self.cfg, self.state.ctrl, results,
                                    stats, lat, intervals)
            self.state = dataclasses.replace(self.state, ctrl=ctrl)
            return ctrl
        rows = _controller_step(self.cfg, aux.ctrl, results, stats,
                                aux.latency[0], intervals)
        r = self.mesh.rank
        own = ctl.ControllerState(**{
            f.name: getattr(rows, f.name)[r:r + 1].clone()
            for f in dataclasses.fields(ctl.ControllerState)})
        self.state = dataclasses.replace(self.state, ctrl=own)
        return rows

    def _wm_totals(self, aux: Optional[_GatherAux]):
        """The watermark fields of a record: sharded, the slowest shard's
        watermark, the newest open interval and the summed accounting
        (the mesh's from the gathered rows)."""
        st = self.state
        wm, open_iv = ((st.wm, st.open_interval) if aux is None
                       else (aux.wm, aux.open_interval))
        wmark = wmk.watermark(wm, self.cfg.allowed_lateness)
        if self.cfg.num_shards == 1:
            ints = torch.stack([open_iv, wm.on_time, wm.late,
                                wm.dropped]).tolist()
            return float(wmark), ints
        ints = torch.stack([torch.max(open_iv), torch.sum(wm.on_time),
                            torch.sum(wm.late),
                            torch.sum(wm.dropped)]).tolist()
        return float(torch.min(wmark)), ints

    def _record(self, results, latency_s: float,
                interval: Optional[int] = None,
                aux: Optional[_GatherAux] = None,
                ctrl: Optional[ctl.ControllerState] = None) -> Emission:
        """Record one emission; ``ctrl`` is every shard's controller after
        the emission's step (the capacity recorded is their sum)."""
        ctrl = self.state.ctrl if ctrl is None else ctrl
        self._ctrl_rows = ctrl
        wmark, ints = self._wm_totals(aux)
        cap = ctrl.capacity
        if self.cfg.num_shards > 1:
            cap = torch.sum(cap, dim=0, dtype=torch.int32)
        em = Emission(
            index=self._emission_cursor, results=results, watermark=wmark,
            open_interval=ints[0], on_time=ints[1], late=ints[2],
            dropped=ints[3], capacity=cap.cpu().numpy(),
            latency_s=latency_s, items=self._items_since_emit,
            interval=interval)
        self.emissions.append(em)
        self._emission_cursor += 1
        self._items_since_emit = 0
        if self.telemetry is not None:
            self.telemetry.on_emission(self, em)
        return em

    # -- the watermark mirror ------------------------------------------------

    @staticmethod
    def _chunk_max(chunk: TimestampedChunk) -> Optional[torch.Tensor]:
        """The chunk's masked max event time (per shard row of a sharded
        chunk), enqueued on its device (``None`` for an empty chunk). Max
        is exact, so the mirror built from it is bitwise
        ``host_frontier`` over the chunk's times."""
        if chunk.times.numel() == 0:
            return None
        return torch.amax(torch.where(chunk.mask, chunk.times,
                                      float(wmk.NEG_TIME)), dim=-1)

    def _advance_frontier(self, chunk_max: Optional[torch.Tensor]) -> None:
        """Fold one chunk's maxima into the host mirror (one read)."""
        w = self._host_frontier.shape[0]
        if chunk_max is None:
            t = np.full(w, wmk.NEG_TIME, np.float32)
        elif chunk_max.dim() == 0:
            t = np.array([chunk_max.item()], np.float32)
        else:
            t = np.asarray(chunk_max.tolist(), np.float32)
        self._host_frontier = wmk.host_frontier(
            self._host_frontier, t[:, None], np.ones((w, 1), bool))

    def _mirror_read(self, chunk: TimestampedChunk):
        """Enqueue the chunk's maxima for the mirror, before its ingest:
        on the card a copy to pinned memory behind an event."""
        chunk_max = self._chunk_max(chunk)
        if chunk_max is not None and self.device.type == "cuda":
            self._mirror_host.copy_(chunk_max, non_blocking=True)
            self._mirror_event.record()
            chunk_max = self._mirror_host
        return chunk_max

    def _closed_through(self) -> int:
        return wmk.host_closed_through(self._host_frontier,
                                       self.cfg.allowed_lateness,
                                       self.cfg.interval_span)

    def _emit_closed(self, latency_s: float) -> int:
        """Emit every newly closed interval, oldest first; returns how
        many. Exactly once: the host cursor ``_emitted_through``."""
        cfg = self.cfg
        closed = self._closed_through()
        open_iv = wmk.host_open_interval(self._host_frontier,
                                         cfg.interval_span)
        emitted = 0
        while self._emitted_through < closed:
            j = self._emitted_through + 1
            if j <= open_iv - cfg.num_intervals:
                raise RuntimeError(
                    f"interval {j} left the ring before the watermark "
                    f"closed it (open interval {open_iv}, ring holds "
                    f"{cfg.num_intervals}): one arrival unit advanced the "
                    "frontier across a whole window, so the closed "
                    "interval's sample was recycled unemitted; grow "
                    "num_intervals or shorten the chunk/micro-batch event "
                    "span")
            self._run_at("emit_interval", self._emit_base_key)
            results, stats, aux = _evaluate_interval(
                cfg, self.registry, self.state, j, self._emit_base_key,
                self.mesh, latency_s)
            # Per-window pressure: the closed interval's own widths, and
            # a capacity sized for one pane (intervals=1).
            ctrl = self._step_controller(results, stats, aux, latency_s,
                                         intervals=1)
            self._sync()
            self._record(results, self._fed_latency(aux, latency_s),
                         interval=j, aux=aux, ctrl=ctrl)
            self._emitted_through = j
            emitted += 1
        return emitted

    @staticmethod
    def _fed_latency(aux: Optional[_GatherAux], latency_s: float) -> float:
        """The latency the controllers took: the mesh's is rank 0's."""
        return latency_s if aux is None else float(aux.latency[0])


class BatchedExecutor(_ExecutorBase):
    """Micro-batch executor (Spark Streaming analog).

    Every ``batch_chunks`` arrivals a flush ingests the pending chunks in
    order (no wait between them). Under cadence emission it then answers
    the registry and applies the controller with the PREVIOUS flush's
    measured latency (one step delayed, as the reference's pure window
    step takes it), and waits once. Under watermark emission the flush is
    ingest only; it waits, advances the frontier mirror over the flushed
    chunks and emits every interval they closed. With a latency budget
    the pressure signal resizes the micro-batch between flushes.
    """

    mode = "batched"

    def _make_sentinels(self) -> None:
        # Budget 0: each NEW micro-batch count declares its trace with
        # allow(1) in _flush, so only a re-trace is a violation.
        self._step_sentinel = self._sentinel("window_step", allowed=0)
        self._batch_counts: set = set()

    def reset(self, key: torch.Tensor) -> None:
        super().reset(key)
        self.batch_chunks = self.cfg.batch_chunks
        self._pending: List[TimestampedChunk] = []

    def resume(self, state: RuntimeState, chunks_pushed: int,
               emissions_done: int, *, batch_chunks: Optional[int] = None,
               **cursors) -> None:
        """As :meth:`_ExecutorBase.resume`, at a flush boundary: nothing
        is pending."""
        super().resume(state, chunks_pushed, emissions_done, **cursors)
        self._pending = []
        if batch_chunks is not None:
            self.batch_chunks = batch_chunks

    def push(self, chunk: TimestampedChunk) -> None:
        self._pending.append(chunk)
        self._items_since_emit += chunk.values.numel()
        self.chunks_pushed += 1
        if len(self._pending) >= self.batch_chunks:
            self._flush()
        if self.checkpointer is not None:
            # After the flush: a snapshot between flushes snaps to the
            # last one (pending chunks are recovered by replay).
            self.checkpointer.maybe(self)

    def _resize(self, closes: int = 0) -> None:
        if self.cfg.controller.latency_budget_s is not None:
            self.batch_chunks = ctl.next_batch_chunks(
                self.batch_chunks, float(self.state.ctrl.pressure.max()),
                self.cfg.max_batch_chunks, closes_per_batch=closes)

    def _flush(self) -> None:
        if not self._pending:
            return
        if len(self._pending) not in self._batch_counts:
            self._batch_counts.add(len(self._pending))
            self._step_sentinel.allow(1)      # declared: a new count
            self._step_sentinel.trace()
        pending, self._pending = self._pending, []
        t0 = time.perf_counter()
        for ch in pending:
            self._ingest(ch)
        if self._watermark_mode:
            self._sync()                     # the micro-batch barrier
            self._last_latency = time.perf_counter() - t0
            for ch in pending:
                self._advance_frontier(self._chunk_max(ch))
            self._resize(self._emit_closed(self._last_latency))
            if self.telemetry is not None:
                self.telemetry.on_flush(self, self.batch_chunks)
            return
        fed = self._last_latency
        results, stats, aux = _evaluate_merged(self.cfg, self.registry,
                                               self.state, self.mesh, fed)
        ctrl = self._step_controller(results, stats, aux, fed)
        self._sync()                         # the micro-batch barrier
        self._last_latency = time.perf_counter() - t0
        self._record(results, self._last_latency, aux=aux, ctrl=ctrl)
        self._resize()
        if self.telemetry is not None:
            self.telemetry.on_flush(self, self.batch_chunks)

    def finalize(self) -> List[Emission]:
        self._flush()
        return self.emissions


class PipelinedExecutor(_ExecutorBase):
    """Pipelined executor (Flink analog).

    ``push`` only enqueues device work. Under cadence emission every
    ``emit_every`` chunks an emission answers the registry and feeds the
    controller the measured per-chunk latency since the previous one.
    Under watermark emission ``push`` reads back exactly one value per
    shard, the chunk's max event time for the frontier mirror; on the
    card it is copied to pinned memory behind a CUDA event recorded
    BEFORE the chunk's ingest is enqueued, so the host waits at most for
    the previous chunk's ingest, never for this one.
    """

    mode = "pipelined"

    def _make_sentinels(self) -> None:
        self._sentinel("step", allowed=1)
        self._sentinel("emit", allowed=1)

    @property
    def trace_count(self) -> int:
        """Signatures the per-chunk step has run at: 1 after warmup,
        forever (guarded by the sentinel)."""
        return self._sentinels["step"].traces

    def reset(self, key: torch.Tensor) -> None:
        super().reset(key)
        self._chunks_since_emit = 0
        self._emit_t0 = time.perf_counter()

    def resume(self, state: RuntimeState, chunks_pushed: int,
               emissions_done: int, *, chunks_since_emit: int = 0,
               **cursors) -> None:
        """As :meth:`_ExecutorBase.resume`; ``chunks_since_emit`` is the
        position in the emission period (a checkpoint may fall inside
        one), so the next emission falls where the original run's did."""
        super().resume(state, chunks_pushed, emissions_done, **cursors)
        self._chunks_since_emit = chunks_since_emit
        self._emit_t0 = time.perf_counter()

    def push(self, chunk: TimestampedChunk) -> None:
        if self._chunks_since_emit == 0:
            # The period's latency clock starts at its FIRST arrival.
            self._emit_t0 = time.perf_counter()
        self._run_at("step", chunk)
        chunk_max = None
        if self._watermark_mode:
            chunk_max = self._mirror_read(chunk)
        self._ingest(chunk)
        self._items_since_emit += chunk.values.numel()
        self._chunks_since_emit += 1
        self.chunks_pushed += 1
        if self._watermark_mode:
            if chunk_max is not None and self.device.type == "cuda":
                t0 = time.perf_counter()
                self._mirror_event.synchronize()
                self.mirror_wait_s += time.perf_counter() - t0
            self._advance_frontier(chunk_max)
            if self._closed_through() > self._emitted_through:
                self._sync()                 # emission boundary
                elapsed = time.perf_counter() - self._emit_t0
                per_chunk = elapsed / max(self._chunks_since_emit, 1)
                self._last_latency = per_chunk
                self._emit_closed(per_chunk)
                self._chunks_since_emit = 0
                self._emit_t0 = time.perf_counter()
        elif self._chunks_since_emit >= self.cfg.emit_every:
            self._emit_now()
        if self.checkpointer is not None:
            # At the cadence only: the capture waits for the card, the
            # other pushes read nothing back.
            self.checkpointer.maybe(self)

    def _emit_now(self) -> None:
        # Emission boundary: the only place the pipeline waits.
        self._sync()
        elapsed = time.perf_counter() - self._emit_t0
        per_chunk = elapsed / max(self._chunks_since_emit, 1)
        self._last_latency = per_chunk
        self._run_at("emit")
        results, stats, aux = _evaluate_merged(self.cfg, self.registry,
                                               self.state, self.mesh,
                                               per_chunk)
        ctrl = self._step_controller(results, stats, aux, per_chunk)
        self._sync()
        self._record(results, self._fed_latency(aux, per_chunk), aux=aux,
                     ctrl=ctrl)
        self._chunks_since_emit = 0
        self._emit_t0 = time.perf_counter()

    def finalize(self) -> List[Emission]:
        # Watermark emission fires only at frontier closes, never at the
        # end of the stream: unclosed intervals stay unemitted (ad hoc
        # ``query()`` answers them), so a resumed stream closes them once.
        if not self._watermark_mode and self._chunks_since_emit:
            self._emit_now()
        return self.emissions


Executor = Union[BatchedExecutor, PipelinedExecutor]
