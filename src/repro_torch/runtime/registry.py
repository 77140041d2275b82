"""Standing-query registry: many queries, ONE shared sample pass.

Counterpart of the reference's ``runtime/registry.py``. The merged
:class:`~repro_torch.core.quantile.SampleView` and its
:class:`~repro_torch.core.error.StratumStats` are computed once per
emission and every registered query reads them: the linear kinds
(``sum``/``mean``/``count``) the stats (Eqs. 5–9), ``histogram`` /
``quantile`` / ``heavy_hitters`` / ``distinct`` the view (Eq. 6 per bin
or key, bootstrap bounds). On the card ``histogram`` and
``quantile(method="hist")`` go through the hand-written ``weighted_hist``
kernel.

Windows: ``merged`` (the K-interval ring, Eq. 5 merge), ``per_key`` (each
stratum key's cells kept apart: a vector answer ``[S]``) and ``session``
(each key over its current gap-timeout session). Results are keyed by
query name; a query's bootstrap key is the emission key folded with its
name (and, per key, with the key id), so adding a query never perturbs
another's replicates.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import error as err
from repro_torch.core import quantile as qt
from repro_torch.core import sketches as sk
from repro_torch.core import window as win
from repro_torch.utils import fold_in_str

KINDS = ("sum", "mean", "count", "histogram", "quantile", "heavy_hitters",
         "distinct")

#: ``merged`` is the K-interval tumbling window; ``per_key`` answers per
#: stratum key over the same ring (under watermark emission, over the
#: closed interval: per-key tumbling panes); ``session`` per key over its
#: current gap-timeout session (``core.window.session_intervals``).
WINDOWS = ("merged", "per_key", "session")

#: Kinds evaluable under per-key / session windows: the linear kinds plus
#: quantile (a per-key stratified bootstrap). Heavy hitters and distinct
#: stay merged-only.
GROUPED_KINDS = ("sum", "mean", "count", "quantile")

Result = Union[err.Estimate, sk.HeavyHitters]


@dataclasses.dataclass(frozen=True)
class StandingQuery:
    """One registered query (static spec)."""
    name: str
    kind: str
    predicate: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    edges: Optional[tuple] = None          # histogram bin edges
    qs: Optional[tuple] = None             # quantile levels
    k: int = 8                             # heavy hitters
    num_replicates: int = 32               # bootstrap replicates
    method: str = "sort"                   # quantile estimator
    window: str = "merged"                 # merged | per_key | session
    session_gap: Optional[float] = None    # session gap (event-time units)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown query kind {self.kind!r}; "
                             f"one of {KINDS}")
        if self.kind == "count" and self.predicate is None:
            raise ValueError("count query needs predicate=")
        if self.kind == "histogram" and self.edges is None:
            raise ValueError("histogram query needs edges=")
        if self.kind == "quantile" and self.qs is None:
            raise ValueError("quantile query needs qs=")
        if self.window not in WINDOWS:
            raise ValueError(f"unknown window kind {self.window!r}; "
                             f"one of {WINDOWS}")
        if self.window != "merged" and self.kind not in GROUPED_KINDS:
            raise ValueError(
                f"{self.kind!r} queries support only the merged window "
                f"(per_key/session need a per-group estimator; "
                f"available for {GROUPED_KINDS})")
        if self.window == "session" and self.session_gap is None:
            raise ValueError("session window needs session_gap=")
        if self.session_gap is not None and self.session_gap <= 0:
            raise ValueError(
                f"session_gap must be > 0, got {self.session_gap}")


@dataclasses.dataclass
class EmissionContext:
    """The cell structure the per-key and session windows evaluate
    against: the ring's layout, each slot's event interval, which cells
    saw traffic, and the FULL window's merged view (under watermark
    emission the base view is the closed interval's restriction, while a
    session reads the whole ring)."""
    num_strata: int
    num_shards: int
    interval_span: float
    slot_interval: torch.Tensor   # [K] i32 event interval id per slot
    activity: torch.Tensor        # [K, S] bool, live cells with items
    view: qt.SampleView           # full merged view (unrestricted)

    def gap_intervals(self, session_gap: float) -> int:
        """Event-time gap resolved to ring-interval granularity."""
        return max(1, int(math.ceil(session_gap / self.interval_span)))

    def key_of_cell(self, num_cells: int) -> torch.Tensor:
        """``[G]`` stratum key of each flattened cell."""
        return torch.arange(num_cells, dtype=torch.int32,
                            device=self.activity.device) % self.num_strata

    def tile_cells(self, mask_ks: torch.Tensor) -> torch.Tensor:
        """Broadcast a ``[K, S]`` cell mask over shards to ``[G]``."""
        return mask_ks[None].expand(
            (self.num_shards,) + tuple(mask_ks.shape)).reshape(-1)


def _tolist(x):
    a = np.asarray(x)
    return a.item() if a.ndim == 0 else a.tolist()


def _hw95(est: err.Estimate):
    """95% half-width on the host: ``z·sqrt(max(var, 0))`` as
    ``Estimate.error_bound(0.95)``."""
    z = err.Z_FOR_CONFIDENCE[0.95]
    var = est.variance.detach().cpu().numpy().astype(np.float32)
    return _tolist(z * np.sqrt(np.maximum(var, 0.0)))


def result_summary(results: Dict[str, Result]) -> dict:
    """JSON-serializable view of one emission's answers: value and 95%
    half-width per query (vector answers stay vectors). Reads the results
    back; call it where the emission already synchronized."""
    out = {}
    for name, r in results.items():
        if isinstance(r, sk.HeavyHitters):
            out[name] = {"kind": "heavy_hitters",
                         "keys": _tolist(r.keys.cpu()),
                         "counts": _tolist(r.estimate.value.cpu()),
                         "hw95": _hw95(r.estimate)}
        else:
            out[name] = {"kind": "estimate", "value": _tolist(r.value.cpu()),
                         "hw95": _hw95(r)}
    return out


def describe(registry: "QueryRegistry") -> list:
    """Static query-catalog description."""
    return [{"name": q.name, "kind": q.kind, "window": q.window}
            for q in registry.queries]


class QueryRegistry:
    """Ordered collection of standing queries over one value stream."""

    def __init__(self, queries: Sequence[StandingQuery] = ()):
        self._queries: list[StandingQuery] = list(queries)
        self._frozen = False
        self._consts: dict = {}
        names = [q.name for q in self._queries]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate query names in {names}")

    def register(self, name: str, kind: str, **kw) -> "QueryRegistry":
        """Add a query (chainable); raises once an executor froze it."""
        if self._frozen:
            raise ValueError(
                "registry is frozen (an executor uses it); register "
                "every standing query before constructing executors")
        if any(q.name == name for q in self._queries):
            raise ValueError(f"query {name!r} already registered")
        self._queries.append(StandingQuery(name=name, kind=kind, **kw))
        return self

    def freeze(self) -> None:
        self._frozen = True

    @property
    def queries(self) -> tuple:
        return tuple(self._queries)

    def __len__(self) -> int:
        return len(self._queries)

    def _const(self, q: StandingQuery, field: str,
               device: torch.device) -> torch.Tensor:
        """A query's edges or levels as an f32 tensor on ``device``, made
        once (a host-to-device copy per emission would wait for the
        stream)."""
        key = (q.name, field, str(device))
        if key not in self._consts:
            self._consts[key] = torch.tensor(getattr(q, field),
                                             dtype=torch.float32,
                                             device=device)
        return self._consts[key]

    def evaluate(self, window: win.WindowState, key: torch.Tensor,
                 interval_span: float = 1.0) -> Dict[str, Result]:
        """Answer every registered query from one shared sample pass.

        Outside the runtime the slots' event intervals are unknown, so
        session windows use recency ranks (``interval_span`` converts the
        gap); the executors pass the real ids through their own context.
        """
        view = win.sample_view(window)
        stats = err.stratum_stats_from_sample(view.values, view.counts,
                                              view.taken, view.slot_mask())
        k, s = window.intervals.counts.shape
        slot_interval = torch.remainder(
            torch.arange(k, dtype=torch.int32, device=view.values.device)
            - window.cursor, max(k, 1))
        ctx = EmissionContext(
            num_strata=s, num_shards=1,
            interval_span=interval_span, slot_interval=slot_interval,
            activity=win.activity_mask(window), view=view)
        return self.evaluate_view(view, stats, key, ctx=ctx)

    def evaluate_view(self, view: qt.SampleView, stats: err.StratumStats,
                      key: torch.Tensor,
                      ctx: Optional[EmissionContext] = None,
                      ) -> Dict[str, Result]:
        """Answer every query from an already-materialized shared pass
        ``(view, stats)``; ``ctx`` supplies the cell structure the
        per-key and session windows need."""
        out: Dict[str, Result] = {}
        for q in self._queries:
            if q.window == "merged":
                out[q.name] = self._eval_merged(q, view, stats, key)
            else:
                if ctx is None:
                    raise ValueError(
                        f"query {q.name!r} has window={q.window!r}, which "
                        "needs an EmissionContext (cell structure); "
                        "evaluate through an executor or "
                        "QueryRegistry.evaluate")
                out[q.name] = self._eval_grouped(q, view, key, ctx)
        return out

    def _eval_merged(self, q: StandingQuery, view: qt.SampleView,
                     stats: err.StratumStats, key: torch.Tensor) -> Result:
        dev = view.values.device
        if q.kind == "sum":
            return err.estimate_sum(stats)
        if q.kind == "mean":
            return err.estimate_mean(stats)
        if q.kind == "count":
            ind = q.predicate(view.values).to(torch.float32)
            return err.estimate_sum(err.stratum_stats_from_sample(
                ind, view.counts, view.taken, view.slot_mask()))
        if q.kind == "histogram":
            return qt.cell_counts(view, self._const(q, "edges", dev))
        if q.kind == "quantile":
            return qt.query_quantile(
                view, self._const(q, "qs", dev), method=q.method,
                num_replicates=q.num_replicates,
                key=fold_in_str(key, q.name))
        if q.kind == "heavy_hitters":
            return sk.query_heavy_hitters(view, q.k)
        return sk.query_distinct(view, num_replicates=q.num_replicates,
                                 key=fold_in_str(key, q.name))

    def _eval_grouped(self, q: StandingQuery, view: qt.SampleView,
                      key: torch.Tensor, ctx: EmissionContext) -> Result:
        """Per-key / session evaluation: restrict, group by key, estimate.

        Per-key windows group the BASE view's cells by stratum key (under
        watermark emission the base view is the closed interval). Session
        windows first restrict the FULL ring to each key's current
        session, a function of ring activity alone.
        """
        s = ctx.num_strata
        if q.window == "session":
            smask = win.session_intervals(
                ctx.activity, ctx.slot_interval,
                ctx.gap_intervals(q.session_gap))
            base = win.restrict_view(ctx.view, ctx.tile_cells(smask))
        else:
            base = view
        gid = ctx.key_of_cell(base.counts.shape[0])
        if q.kind == "quantile":
            # Per-key stratified bootstrap: each key keeps its own cells
            # and replicates, keyed fold_in(fold_in_str(key, name), id).
            qkey = fold_in_str(key, q.name)
            qs = self._const(q, "qs", base.values.device)
            per = [qt.query_quantile(
                win.restrict_view(base, gid == key_id), qs,
                method=q.method, num_replicates=q.num_replicates,
                key=prng.fold_in(qkey, key_id)) for key_id in range(s)]
            return err.Estimate(
                value=torch.stack([e.value for e in per]),
                variance=torch.stack([e.variance for e in per]))
        values = base.values
        if q.kind == "count":
            values = q.predicate(values).to(torch.float32)
        gstats = err.stratum_stats_from_sample(
            values, base.counts, base.taken, base.slot_mask())
        if q.kind == "mean":
            return err.estimate_mean_grouped(gstats, gid, s)
        return err.estimate_sum_grouped(gstats, gid, s)
