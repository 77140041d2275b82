"""The streaming executors: batched (Spark mode) and pipelined (Flink mode).

Counterpart of the reference's ``runtime/executor.py`` for one shard.
Both executors share one ingest core (``_ingest_chunk``: watermark
routing, ring-slot reset, the reservoir fold over the flattened
``[K·S]`` (ring slot × stratum) cells and the device counters), so their
sampling trajectories are identical chunk for chunk; they differ only in
when the core runs and where the host waits:

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

Where the reference's compiled steps donate the state, these executors
update the ``[K, S, N_max]`` ring IN PLACE, and the one-shot kernel also
the cell counters, slot table, watermark scalars and counter rows.

Not ported (each raises :class:`UnsupportedConfigError`):
``num_shards > 1`` and ``placement="mesh"`` (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Union

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import distributed as dist
from repro_torch.core import error as err
from repro_torch.core import oasrs
from repro_torch.core import window as win
from repro_torch.kernels import ops
from repro_torch.obs import metrics as obm
from repro_torch.runtime import controller as ctl
from repro_torch.runtime import watermark as wmk
from repro_torch.runtime.records import TimestampedChunk
from repro_torch.runtime.registry import (EmissionContext,
                                          QueryRegistry, Result)
from repro_torch.utils import DeviceLike, resolve_device

INGEST_PATHS = ("fused", "masked", "onekernel")
EMISSION_MODES = ("cadence", "watermark")


class UnsupportedConfigError(NotImplementedError):
    """A configuration the reference runs but this port does not yet."""


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Static description of one runtime instance (the reference's
    fields; the port runs the ones its slices cover)."""
    num_strata: int
    capacity: int                      # per-stratum reservoir capacity N_i
    num_intervals: int = 4             # ring size K (window = K intervals)
    interval_span: float = 1.0         # event-time units per interval
    allowed_lateness: float = 0.5      # watermark lag (event-time units)
    max_capacity: Optional[int] = None  # reservoir allocation N_max
    num_shards: int = 1
    placement: str = "vmap"
    controller: ctl.ControllerConfig = ctl.ControllerConfig()
    accuracy_query: Optional[str] = None
    batch_chunks: int = 4              # batched: chunks per flush
    max_batch_chunks: int = 32
    emit_every: int = 4                # pipelined cadence: chunks/emission
    backend: Optional[str] = None      # see check_supported
    ingest: str = "fused"              # one of INGEST_PATHS
    emission: str = "cadence"          # one of EMISSION_MODES


def check_supported(cfg: RuntimeConfig) -> None:
    """Raise on a configuration outside the port's slices."""
    if cfg.num_shards != 1 or cfg.placement != "vmap":
        raise UnsupportedConfigError(
            f"num_shards={cfg.num_shards}, placement={cfg.placement!r}: "
            "the port runs one shard; sharded placements come with ROADMAP "
            "Queue 1 item 9")
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


@dataclasses.dataclass
class RuntimeState:
    """Device-resident runtime state."""
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
    latency_s: float              # measured latency fed back
    items: int                    # items pushed since previous emission
    interval: Optional[int] = None  # watermark emission: the interval it
    #                                 closed (None under cadence)


def init_state(cfg: RuntimeConfig, key: torch.Tensor,
               device: DeviceLike = None) -> RuntimeState:
    """Fresh runtime state on ``device`` (``None`` means the card)."""
    dev = resolve_device(device)
    check_supported(cfg)
    k = cfg.num_intervals
    cap = torch.full((cfg.num_strata,), cfg.capacity, dtype=torch.int32,
                     device=dev)
    max_cap = cfg.max_capacity
    if max_cap is None:
        max_cap = cfg.capacity
        if cfg.controller.budget is not None:
            # The accuracy feedback may raise capacity to the budget's
            # ceiling; N_max must cover it (capacity <= N_max).
            max_cap = max(max_cap, cfg.controller.budget.max_per_stratum)
    slots = torch.arange(k, dtype=torch.int32, device=dev)
    return RuntimeState(
        window=win.init(k, cfg.num_strata, cap, key, max_capacity=max_cap,
                        device=dev),
        slot_interval=-torch.remainder(-slots, k),   # intervals 1-K ... 0
        open_interval=torch.zeros((), dtype=torch.int32, device=dev),
        wm=wmk.init(dev),
        ctrl=ctl.init(cap),
        metrics=obm.init(cfg.num_strata, dev))


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
    desired = r.open_interval - torch.remainder(r.open_interval - slots, k)
    reset = (desired != state.slot_interval)[:, None]
    iv = state.window.intervals
    adopt = torch.clamp(state.ctrl.capacity, max=iv.max_capacity)
    iv = dataclasses.replace(
        iv, counts=torch.where(reset, 0, iv.counts),
        capacity=torch.where(reset, adopt[None, :], iv.capacity))
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
    """The fold's key schedule on the ring's lead key: split three ways,
    two ``[M]`` uniforms; returns the ring keys with the lead advanced."""
    keys = prng.split(iv.key[0], 3)
    u_accept = prng.uniform(keys[1], m)
    u_slot = prng.uniform(keys[2], m)
    return torch.cat([keys[0][None], iv.key[1:]]), u_accept, u_slot


def _ingest_chunk(cfg: RuntimeConfig, state: RuntimeState,
                  chunk: TimestampedChunk) -> RuntimeState:
    """Fold one chunk by the configured ingest path."""
    if cfg.ingest == "masked":
        return _ingest_chunk_masked(cfg, state, chunk)
    if cfg.ingest == "onekernel":
        return _ingest_chunk_onekernel(cfg, state, chunk)
    return _ingest_chunk_fused(cfg, state, chunk)


def _ingest_chunk_fused(cfg: RuntimeConfig, state: RuntimeState,
                        chunk: TimestampedChunk) -> RuntimeState:
    """Fold one chunk: route, reset slots, one fold over ``K·S`` cells.

    Each accepted item is routed once to its (slot, stratum) cell: its
    rank within that cell equals its rank within the stratum of its
    interval, so the flat fold is Algorithm 1 per cell. The ring's
    ``[K·S, N_max]`` flat form is a VIEW of ``[K, S, N_max]``: the fold
    writes the state's ring in place.
    """
    k, s_cnt = cfg.num_intervals, cfg.num_strata
    r, iv, desired = _route_and_reset(cfg, state, chunk)
    counts_before = iv.counts
    tgt_slot = torch.remainder(r.target_interval, k)
    live = r.accept & (desired[tgt_slot.long()] == r.target_interval)
    flat_sid = tgt_slot * s_cnt + chunk.stratum_ids.to(torch.int32)
    ring = iv.values.view(k * s_cnt, iv.max_capacity)
    if ring.data_ptr() != iv.values.data_ptr():
        raise RuntimeError("flattened ring is not a view of the ring")
    flat = oasrs.OASRSState(values=ring, counts=iv.counts.reshape(-1),
                            capacity=iv.capacity.reshape(-1),
                            key=iv.key[0])
    flat = dist.local_update(flat, flat_sid, chunk.values, live)
    iv = dataclasses.replace(
        iv, counts=flat.counts.view(k, s_cnt),
        key=torch.cat([flat.key[None], iv.key[1:]]))
    return _finish_ingest(cfg, state, chunk, r, iv, desired, counts_before)


def _ingest_chunk_masked(cfg: RuntimeConfig, state: RuntimeState,
                         chunk: TimestampedChunk) -> RuntimeState:
    """One fold per ring slot over the slot's masked view of the chunk (K
    folds of M items), with the fused path's uniforms: each item is
    masked into exactly one slot, so the state is bitwise the fused
    path's. Each slot's ``[S, N_max]`` reservoir is a view of the ring,
    written in place."""
    r, iv, desired = _route_and_reset(cfg, state, chunk)
    counts_before = iv.counts
    keys, u_accept, u_slot = _draw_uniforms(iv, chunk.stratum_ids.shape[0])
    counts = []
    for j in range(cfg.num_intervals):
        slot = oasrs.OASRSState(values=iv.values[j], counts=iv.counts[j],
                                capacity=iv.capacity[j], key=iv.key[j])
        slot_mask = r.accept & (r.target_interval == desired[j])
        counts.append(oasrs.apply_chunk_uniforms(
            slot, chunk.stratum_ids, chunk.values, slot_mask, u_accept,
            u_slot).counts)
    iv = dataclasses.replace(iv, counts=torch.stack(counts), key=keys)
    return _finish_ingest(cfg, state, chunk, r, iv, desired, counts_before)


def _ingest_chunk_onekernel(cfg: RuntimeConfig, state: RuntimeState,
                            chunk: TimestampedChunk) -> RuntimeState:
    """The whole ingest in one call of the one-shot kernel (its plain
    version on the CPU), with the fused path's key schedule: bitwise the
    fused path's state.

    The call updates IN PLACE the ring, cell counts and capacities, the
    slot table, the watermark scalars, the chunk/item totals and a
    ``[6, S]`` stack of the counter rows, which is then split into rows
    of their own.
    """
    k = cfg.num_intervals
    iv = state.window.intervals
    keys, u_accept, u_slot = _draw_uniforms(iv, chunk.stratum_ids.shape[0])
    adopt = torch.clamp(state.ctrl.capacity, max=iv.max_capacity)
    out = ops.one_shot_ingest(
        chunk.times, chunk.stratum_ids.to(torch.int32), chunk.values,
        chunk.mask, u_accept, u_slot,
        max_time=state.wm.max_time, open_interval=state.open_interval,
        on_time=state.wm.on_time, late=state.wm.late,
        dropped=state.wm.dropped, chunks=state.metrics.chunks,
        items=state.metrics.items, slot_interval=state.slot_interval,
        adopt=adopt, counts=iv.counts, capacity=iv.capacity,
        values=iv.values, counters=obm.stack_counters(state.metrics),
        span=cfg.interval_span, allowed_lateness=cfg.allowed_lateness)
    if out.values.data_ptr() != iv.values.data_ptr():
        raise RuntimeError("one-shot ingest did not write the ring in place")
    window = win.WindowState(
        intervals=oasrs.OASRSState(values=out.values, counts=out.counts,
                                   capacity=out.capacity, key=keys),
        cursor=torch.remainder(out.open_interval + 1, k),
        filled=torch.clamp(out.open_interval + 1, max=k))
    wm = wmk.WatermarkState(max_time=out.max_time, on_time=out.on_time,
                            late=out.late, dropped=out.dropped)
    metrics = obm.unstack_counters(out.counters, chunks=out.chunks,
                                   items=out.items)
    return RuntimeState(window=window, slot_interval=out.slot_interval,
                        open_interval=out.open_interval, wm=wm,
                        ctrl=state.ctrl, metrics=metrics)


# ---------------------------------------------------------------------------
# The emission.
# ---------------------------------------------------------------------------

def _merged_view(cfg: RuntimeConfig, state: RuntimeState):
    """Shared sample pass: the merged view and its stats (one kernel)."""
    view = win.sample_view(state.window)
    stats = err.stratum_stats_from_sample(view.values, view.counts,
                                          view.taken, view.slot_mask())
    return view, stats


def _emission_key(state: RuntimeState) -> torch.Tensor:
    """The bootstrap key of a cadence emission: the ring's lead key folded
    with ``0xE717`` (the reference's ``_emission_key``)."""
    return prng.fold_in(state.window.intervals.key[0], 0xE717)


def _window_ctx(cfg: RuntimeConfig, state: RuntimeState,
                view) -> EmissionContext:
    """The cell structure the per-key and session windows evaluate
    against: the slots' event intervals and the live cells with items."""
    return EmissionContext(
        num_strata=cfg.num_strata, num_shards=cfg.num_shards,
        interval_span=cfg.interval_span,
        slot_interval=state.slot_interval,
        activity=win.activity_mask(state.window), view=view)


def _evaluate(cfg: RuntimeConfig, registry: QueryRegistry,
              state: RuntimeState):
    view, stats = _merged_view(cfg, state)
    results = registry.evaluate_view(view, stats, _emission_key(state),
                                     ctx=_window_ctx(cfg, state, view))
    return results, stats


def _interval_cell_mask(cfg: RuntimeConfig, state: RuntimeState,
                        interval: int) -> torch.Tensor:
    """``[K·S]`` cell mask of one event interval in the merged view's
    order: slot ``interval mod K``, and only while the slot still HOLDS
    that interval (a recycled slot never leaks its new occupant)."""
    k, s = cfg.num_intervals, cfg.num_strata
    slot = interval % k
    cells = torch.arange(k * s, dtype=torch.int32,
                         device=state.slot_interval.device)
    return ((cells // s) == slot) & (state.slot_interval[slot] == interval)


def _evaluate_interval(cfg: RuntimeConfig, registry: QueryRegistry,
                       state: RuntimeState, interval: int,
                       base_key: torch.Tensor):
    """Watermark emission body: every standing query on the CLOSED
    interval's cells (merged kinds and per-key panes restrict to it;
    session windows read the full ring through the context, limited to
    intervals up to the closing one, since open intervals still fill).

    ``base_key`` is folded with the interval id, not with the ring's lead
    key, whose fold count depends on how many chunks an executor had
    ingested when it emitted: both executors draw the same bootstrap
    bits for the same interval.
    """
    view = win.sample_view(state.window)
    ctx = _window_ctx(cfg, state, view)
    ctx.activity = ctx.activity & (ctx.slot_interval <= interval)[:, None]
    iview = win.restrict_view(view, _interval_cell_mask(cfg, state,
                                                        interval))
    istats = err.stratum_stats_from_sample(iview.values, iview.counts,
                                           iview.taken, iview.slot_mask())
    results = registry.evaluate_view(iview, istats,
                                     prng.fold_in(base_key, interval),
                                     ctx=ctx)
    return results, istats


def _pooled_stats(cfg: RuntimeConfig,
                  stats: err.StratumStats) -> err.StratumStats:
    """Pool the interval × stratum cells per stratum (``[K·S] → [S]``)."""
    k, s = cfg.num_intervals, cfg.num_strata

    def pool(leaf):
        return leaf.reshape(k, s).sum(dim=0, dtype=leaf.dtype)

    return err.StratumStats(counts=pool(stats.counts),
                            taken=pool(stats.taken), sums=pool(stats.sums),
                            sumsqs=pool(stats.sumsqs))


def _apply_controller(cfg: RuntimeConfig, state: RuntimeState, results,
                      stats: err.StratumStats, latency_s: torch.Tensor,
                      intervals: Optional[int] = None) -> RuntimeState:
    """One controller step; ``intervals`` (default K) turns the window's
    allocation into the per-interval capacity."""
    realized = None
    if cfg.controller.budget is not None:
        realized = (results[cfg.accuracy_query] if cfg.accuracy_query
                    else err.estimate_mean(stats))
    k = cfg.num_intervals if intervals is None else intervals
    ctrl = ctl.update(state.ctrl, cfg.controller, _pooled_stats(cfg, stats),
                      realized, latency_s, intervals=k)
    return dataclasses.replace(state, ctrl=ctrl)


# ---------------------------------------------------------------------------
# The executors.
# ---------------------------------------------------------------------------

class _ExecutorBase:
    """Shared plumbing: state, emission bookkeeping, the watermark mirror,
    ad hoc queries."""

    mode = "base"

    def __init__(self, cfg: RuntimeConfig, registry: QueryRegistry,
                 key: torch.Tensor, device: DeviceLike = None):
        self.device = resolve_device(device)
        check_supported(cfg)
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
        self.reset(key)

    @property
    def _watermark_mode(self) -> bool:
        return self.cfg.emission == "watermark"

    def reset(self, key: torch.Tensor) -> None:
        """Restart on a fresh stream."""
        self.state = init_state(self.cfg, key, self.device)
        self.emissions: List[Emission] = []
        self.chunks_pushed = 0
        self._emission_cursor = 0
        self._items_since_emit = 0
        self._last_latency = 0.0
        # Watermark emission, host side: the per-interval base key (folded
        # with each closed interval's id for its bootstrap draws), the
        # frontier mirror (advanced from chunk times, never from the
        # in-flight state) and the exactly-once emitted-through cursor.
        self._emit_base_key = prng.fold_in(key.to(self.device), 0xE31)
        self._host_frontier = np.full((1,), wmk.NEG_TIME, np.float32)
        self._emitted_through = -1
        self.mirror_wait_s = 0.0      # host time spent on the mirror read
        if self.device.type == "cuda":
            self._mirror_host = torch.empty((), dtype=torch.float32,
                                            pin_memory=True)
            self._mirror_event = torch.cuda.Event()

    def resume(self, state: RuntimeState, chunks_pushed: int,
               emissions_done: int, *, emitted_through: int = -1,
               emit_base_key=None, items_since_emit: int = 0,
               last_latency: float = 0.0) -> None:
        """Continue a stream from a state carried over at a chunk boundary
        (an emission boundary under cadence, a flush boundary for the
        batched executor), e.g. converted from the reference by
        ``runtime/convert.py``: the next emission gets index
        ``emissions_done``. Under watermark emission ``emitted_through``
        and ``emit_base_key`` (two u32 words) carry the host cursors; the
        frontier mirror restarts from the state's frontier, as the
        reference's restore does."""
        self.state = state
        self.chunks_pushed = chunks_pushed
        self._emission_cursor = emissions_done
        self._items_since_emit = items_since_emit
        self._last_latency = last_latency
        self._emitted_through = emitted_through
        if emit_base_key is not None:
            self._emit_base_key = torch.as_tensor(
                np.asarray(emit_base_key, np.int64), device=self.device)
        # A copy: on the CPU ``numpy()`` shares the state's buffer, which
        # the one-shot ingest updates in place.
        self._host_frontier = state.wm.max_time.cpu().numpy().reshape(
            1).copy()

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
        controller feedback, no emission record)."""
        return _evaluate(self.cfg, self.registry, self.state)[0]

    # -- the watermark mirror ------------------------------------------------

    @staticmethod
    def _chunk_max(chunk: TimestampedChunk) -> Optional[torch.Tensor]:
        """The chunk's masked max event time, enqueued on its device
        (``None`` for an empty chunk). Max is exact, so the mirror built
        from it is bitwise ``host_frontier`` over the chunk's times."""
        if chunk.times.numel() == 0:
            return None
        return torch.max(torch.where(chunk.mask, chunk.times,
                                     float(wmk.NEG_TIME)))

    def _advance_frontier(self, chunk_max: Optional[torch.Tensor]) -> None:
        """Fold one chunk's max into the host mirror (one value read)."""
        t = (wmk.NEG_TIME if chunk_max is None
             else np.float32(chunk_max.item()))
        self._host_frontier = wmk.host_frontier(
            self._host_frontier, np.array([t], np.float32),
            np.ones(1, bool))

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
            results, stats = _evaluate_interval(cfg, self.registry,
                                                 self.state, j,
                                                 self._emit_base_key)
            lat = torch.tensor(latency_s, dtype=torch.float32,
                               device=self.device)
            # Per-window pressure: the closed interval's own widths, and
            # a capacity sized for one pane (intervals=1).
            self.state = _apply_controller(cfg, self.state, results, stats,
                                           lat, intervals=1)
            self._sync()
            self._record(results, latency_s, interval=j)
            self._emitted_through = j
            emitted += 1
        return emitted

    def _record(self, results, latency_s: float,
                interval: Optional[int] = None) -> Emission:
        st = self.state
        ints = torch.stack([st.open_interval, st.wm.on_time, st.wm.late,
                            st.wm.dropped]).tolist()
        em = Emission(
            index=self._emission_cursor, results=results,
            watermark=float(wmk.watermark(st.wm, self.cfg.allowed_lateness)),
            open_interval=ints[0], on_time=ints[1], late=ints[2],
            dropped=ints[3], capacity=st.ctrl.capacity.cpu().numpy(),
            latency_s=latency_s, items=self._items_since_emit,
            interval=interval)
        self.emissions.append(em)
        self._emission_cursor += 1
        self._items_since_emit = 0
        return em


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

    def _resize(self, closes: int = 0) -> None:
        if self.cfg.controller.latency_budget_s is not None:
            self.batch_chunks = ctl.next_batch_chunks(
                self.batch_chunks, float(self.state.ctrl.pressure),
                self.cfg.max_batch_chunks, closes_per_batch=closes)

    def _flush(self) -> None:
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        t0 = time.perf_counter()
        for ch in pending:
            self.state = _ingest_chunk(self.cfg, self.state, ch)
        if self._watermark_mode:
            self._sync()                     # the micro-batch barrier
            self._last_latency = time.perf_counter() - t0
            for ch in pending:
                self._advance_frontier(self._chunk_max(ch))
            self._resize(self._emit_closed(self._last_latency))
            return
        results, stats = _evaluate(self.cfg, self.registry, self.state)
        lat = torch.tensor(self._last_latency, dtype=torch.float32,
                           device=self.device)
        self.state = _apply_controller(self.cfg, self.state, results, stats,
                                       lat)
        self._sync()                         # the micro-batch barrier
        self._last_latency = time.perf_counter() - t0
        self._record(results, self._last_latency)
        self._resize()

    def finalize(self) -> List[Emission]:
        self._flush()
        return self.emissions


class PipelinedExecutor(_ExecutorBase):
    """Pipelined executor (Flink analog).

    ``push`` only enqueues device work. Under cadence emission every
    ``emit_every`` chunks an emission answers the registry and feeds the
    controller the measured per-chunk latency since the previous one.
    Under watermark emission ``push`` reads back exactly one value, the
    chunk's max event time for the frontier mirror; on the card it is
    copied to pinned memory behind a CUDA event recorded BEFORE the
    chunk's ingest is enqueued, so the host waits at most for the
    previous chunk's ingest, never for this one.
    """

    mode = "pipelined"

    def reset(self, key: torch.Tensor) -> None:
        super().reset(key)
        self._chunks_since_emit = 0
        self._emit_t0 = time.perf_counter()

    def resume(self, state: RuntimeState, chunks_pushed: int,
               emissions_done: int, **cursors) -> None:
        super().resume(state, chunks_pushed, emissions_done, **cursors)
        self._chunks_since_emit = 0
        self._emit_t0 = time.perf_counter()

    def push(self, chunk: TimestampedChunk) -> None:
        if self._chunks_since_emit == 0:
            # The period's latency clock starts at its FIRST arrival.
            self._emit_t0 = time.perf_counter()
        chunk_max = None
        if self._watermark_mode:
            chunk_max = self._chunk_max(chunk)
            if chunk_max is not None and self.device.type == "cuda":
                self._mirror_host.copy_(chunk_max, non_blocking=True)
                self._mirror_event.record()
                chunk_max = self._mirror_host
        self.state = _ingest_chunk(self.cfg, self.state, chunk)
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

    def _emit_now(self) -> None:
        # Emission boundary: the only place the pipeline waits.
        self._sync()
        elapsed = time.perf_counter() - self._emit_t0
        per_chunk = elapsed / max(self._chunks_since_emit, 1)
        self._last_latency = per_chunk
        results, stats = _evaluate(self.cfg, self.registry, self.state)
        lat = torch.tensor(per_chunk, dtype=torch.float32,
                           device=self.device)
        self.state = _apply_controller(self.cfg, self.state, results, stats,
                                       lat)
        self._sync()
        self._record(results, per_chunk)
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
