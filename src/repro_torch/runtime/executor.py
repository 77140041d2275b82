"""The pipelined (Flink-mode) streaming executor.

Counterpart of the reference's ``runtime/executor.py`` for its main path:
``PipelinedExecutor`` with ``ingest="fused"``, one shard and cadence
emission. Every chunk flows through the ingest as it arrives: watermark
routing, ring-slot reset, one route-once reservoir fold over the
flattened ``[K·S]`` (ring slot × stratum) cells, and the device counters.
Nothing in ``push`` reads a value back to the host; every ``emit_every``
chunks an emission synchronises the device, answers the standing queries
from one shared stats pass and updates the capacity controller.

Where the reference's jitted steps donate the state, this executor
updates the ``[K, S, N_max]`` ring IN PLACE: the fold writes into the
ring tensor, which the next state shares with the previous one.

Not ported in this slice (each raises :class:`UnsupportedConfigError`):
``num_shards > 1`` and ``placement="mesh"`` (ROADMAP Queue 1 item 9),
``emission="watermark"`` and ``ingest`` other than ``"fused"``
(Queue 1 item 6). ``BatchedExecutor`` comes with item 6 too.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.core import distributed as dist
from repro_torch.core import error as err
from repro_torch.core import oasrs
from repro_torch.core import window as win
from repro_torch.obs import metrics as obm
from repro_torch.runtime import controller as ctl
from repro_torch.runtime import watermark as wmk
from repro_torch.runtime.records import TimestampedChunk
from repro_torch.runtime.registry import QueryRegistry, Result
from repro_torch.utils import DeviceLike, resolve_device


class UnsupportedConfigError(NotImplementedError):
    """A configuration the reference runs but this port does not yet."""


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Static description of one runtime instance (the reference's
    fields; the port runs the ones its slice covers)."""
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
    batch_chunks: int = 4
    max_batch_chunks: int = 32
    emit_every: int = 4                # chunks per emission
    backend: Optional[str] = None      # see check_supported
    ingest: str = "fused"
    emission: str = "cadence"


def check_supported(cfg: RuntimeConfig) -> None:
    """Raise on a configuration outside this slice of the port."""
    if cfg.num_shards != 1 or cfg.placement != "vmap":
        raise UnsupportedConfigError(
            f"num_shards={cfg.num_shards}, placement={cfg.placement!r}: "
            "the port runs one shard; sharded placements come with ROADMAP "
            "Queue 1 item 9")
    if cfg.emission != "cadence":
        raise UnsupportedConfigError(
            f"emission={cfg.emission!r}: the port emits on cadence; "
            "watermark emission comes with ROADMAP Queue 1 item 6")
    if cfg.ingest != "fused":
        raise UnsupportedConfigError(
            f"ingest={cfg.ingest!r}: the port runs the fused ingest; the "
            "others come with ROADMAP Queue 1 item 6")
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
    latency_s: float              # measured per-chunk latency fed back
    items: int                    # items pushed since previous emission


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


def _ingest_chunk(cfg: RuntimeConfig, state: RuntimeState,
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


# ---------------------------------------------------------------------------
# The emission.
# ---------------------------------------------------------------------------

def _merged_view(cfg: RuntimeConfig, state: RuntimeState):
    """Shared sample pass: the merged view and its stats (one kernel)."""
    view = win.sample_view(state.window)
    stats = err.stratum_stats_from_sample(view.values, view.counts,
                                          view.taken, view.slot_mask())
    return view, stats


def _evaluate(cfg: RuntimeConfig, registry: QueryRegistry,
              state: RuntimeState):
    view, stats = _merged_view(cfg, state)
    return registry.evaluate_view(view, stats), stats


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
                      stats: err.StratumStats,
                      latency_s: torch.Tensor) -> RuntimeState:
    realized = None
    if cfg.controller.budget is not None:
        realized = (results[cfg.accuracy_query] if cfg.accuracy_query
                    else err.estimate_mean(stats))
    ctrl = ctl.update(state.ctrl, cfg.controller, _pooled_stats(cfg, stats),
                      realized, latency_s, intervals=cfg.num_intervals)
    return dataclasses.replace(state, ctrl=ctrl)


class PipelinedExecutor:
    """Pipelined executor (Flink analog), one shard, cadence emission.

    ``push`` only enqueues device work; every ``emit_every`` chunks an
    emission answers the registry and feeds the controller the measured
    per-chunk latency since the previous emission.
    """

    mode = "pipelined"

    def __init__(self, cfg: RuntimeConfig, registry: QueryRegistry,
                 key: torch.Tensor, device: DeviceLike = None):
        self.device = resolve_device(device)
        check_supported(cfg)
        if len(registry) == 0:
            raise ValueError("register at least one standing query")
        if cfg.accuracy_query is not None and not any(
                q.name == cfg.accuracy_query for q in registry.queries):
            raise ValueError(
                f"accuracy_query {cfg.accuracy_query!r} is not registered")
        self.cfg = cfg
        self.registry = registry
        registry.freeze()
        self.reset(key)

    def reset(self, key: torch.Tensor) -> None:
        """Restart on a fresh stream."""
        self.state = init_state(self.cfg, key, self.device)
        self.emissions: List[Emission] = []
        self.chunks_pushed = 0
        self._emission_cursor = 0
        self._items_since_emit = 0
        self._chunks_since_emit = 0
        self._emit_t0 = time.perf_counter()

    def resume(self, state: RuntimeState, chunks_pushed: int,
               emissions_done: int) -> None:
        """Continue a stream from a state carried over at an emission
        boundary (e.g. converted from the reference by
        ``runtime/convert.py``): the next emission gets index
        ``emissions_done``."""
        self.state = state
        self.chunks_pushed = chunks_pushed
        self._emission_cursor = emissions_done
        self._items_since_emit = 0
        self._chunks_since_emit = 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def push(self, chunk: TimestampedChunk) -> None:
        if self._chunks_since_emit == 0:
            # The period's latency clock starts at its FIRST arrival.
            self._emit_t0 = time.perf_counter()
        self.state = _ingest_chunk(self.cfg, self.state, chunk)
        self._items_since_emit += chunk.values.numel()
        self._chunks_since_emit += 1
        self.chunks_pushed += 1
        if self._chunks_since_emit >= self.cfg.emit_every:
            self._emit_now()

    def _emit_now(self) -> None:
        # Emission boundary: the only place the pipeline touches the host.
        self._sync()
        elapsed = time.perf_counter() - self._emit_t0
        per_chunk = elapsed / max(self._chunks_since_emit, 1)
        results, stats = _evaluate(self.cfg, self.registry, self.state)
        lat = torch.tensor(per_chunk, dtype=torch.float32,
                           device=self.device)
        self.state = _apply_controller(self.cfg, self.state, results, stats,
                                       lat)
        self._sync()
        self._record(results, per_chunk)
        self._chunks_since_emit = 0
        self._emit_t0 = time.perf_counter()

    def _record(self, results, latency_s: float) -> Emission:
        st = self.state
        ints = torch.stack([st.open_interval, st.wm.on_time, st.wm.late,
                            st.wm.dropped]).tolist()
        em = Emission(
            index=self._emission_cursor, results=results,
            watermark=float(wmk.watermark(st.wm, self.cfg.allowed_lateness)),
            open_interval=ints[0], on_time=ints[1], late=ints[2],
            dropped=ints[3], capacity=st.ctrl.capacity.cpu().numpy(),
            latency_s=latency_s, items=self._items_since_emit)
        self.emissions.append(em)
        self._emission_cursor += 1
        self._items_since_emit = 0
        return em

    def finalize(self) -> List[Emission]:
        if self._chunks_since_emit:
            self._emit_now()
        return self.emissions

    def run(self, chunks: Iterable[TimestampedChunk]) -> List[Emission]:
        for c in chunks:
            self.push(c)
        return self.finalize()

    def query(self) -> Dict[str, Result]:
        """Every standing query on the current state (ad hoc: no
        controller feedback, no emission record)."""
        return _evaluate(self.cfg, self.registry, self.state)[0]
