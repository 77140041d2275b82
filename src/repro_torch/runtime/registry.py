"""Standing-query registry: many queries, ONE shared sample pass.

Counterpart of the reference's ``runtime/registry.py`` for the linear
kinds (``sum``, ``mean``, ``count``) over the merged window. The merged
:class:`SampleView` and its :class:`StratumStats` are computed once per
emission and every query reads them; ``count`` adds one stats pass over
its predicate's 0/1 indicator.

The reference's other kinds and windows are recognised and refused
with :class:`NotImplementedError` naming the roadmap item that brings
them to the port.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch

from repro_torch.core import error as err
from repro_torch.core.quantile import SampleView

KINDS = ("sum", "mean", "count", "histogram", "quantile", "heavy_hitters",
         "distinct")
LINEAR_KINDS = ("sum", "mean", "count")
WINDOWS = ("merged", "per_key", "session")

_NOT_YET = {
    "kind": "ROADMAP Queue 1 item 8 (nonlinear queries on the "
            "weighted_hist kernel)",
    "window": "ROADMAP Queue 1 item 6 (per-key and session windows)",
}

Result = err.Estimate


@dataclasses.dataclass(frozen=True)
class StandingQuery:
    """One registered query (static spec)."""
    name: str
    kind: str
    predicate: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    window: str = "merged"

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown query kind {self.kind!r}; "
                             f"one of {KINDS}")
        if self.window not in WINDOWS:
            raise ValueError(f"unknown window kind {self.window!r}; "
                             f"one of {WINDOWS}")
        if self.kind not in LINEAR_KINDS:
            raise NotImplementedError(
                f"query kind {self.kind!r} is not ported yet: it comes "
                f"with {_NOT_YET['kind']}")
        if self.window != "merged":
            raise NotImplementedError(
                f"window {self.window!r} is not ported yet: it comes with "
                f"{_NOT_YET['window']}")
        if self.kind == "count" and self.predicate is None:
            raise ValueError("count query needs predicate=")


class QueryRegistry:
    """Ordered collection of standing queries over one value stream."""

    def __init__(self, queries: Sequence[StandingQuery] = ()):
        self._queries: list[StandingQuery] = list(queries)
        self._frozen = False
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

    def evaluate_view(self, view: SampleView,
                      stats: err.StratumStats) -> Dict[str, Result]:
        """Answer every query from the shared pass ``(view, stats)``."""
        out: Dict[str, Result] = {}
        for q in self._queries:
            if q.kind == "sum":
                out[q.name] = err.estimate_sum(stats)
            elif q.kind == "mean":
                out[q.name] = err.estimate_mean(stats)
            else:
                ind = q.predicate(view.values).to(torch.float32)
                out[q.name] = err.estimate_sum(
                    err.stratum_stats_from_sample(
                        ind, view.counts, view.taken, view.slot_mask()))
        return out
