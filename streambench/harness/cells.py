"""A cell's files, found by the names in ``BENCHMARK.json``.

* the cell: ``workloads[]`` (its ``config``, ``traffic`` and chips);
* the configuration: the file its ``configs[]`` entry names;
* the traffic mix: ``mixes/<traffic>.json``;
* the standing queries: ``queries/<config>/<mix's "queries">.json``;
* the stream's values: ``sources/<config's "generator">.py``;
* the limits of the comparison: ``limits/<cell>.json``;
* each per-layer metric: ``metrics/<metric>.py``, whose ``read(trace)``
  returns the number or ``None``.

A new cell, mix, configuration, source or metric is a new file and a new
entry; no file here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Optional

import numpy as np

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    queries: list
    limits: dict
    end_to_end: list
    per_layer: list
    root: Path = BENCH

    @property
    def num_strata(self) -> int:
        return len(self.config["strata"])

    @property
    def rate(self) -> float:
        return float(self.mix["items_per_event_s"])

    @property
    def chunk_items(self) -> int:
        return int(self.mix["chunk_items"])

    @property
    def chunk_span(self) -> float:
        span = self.chunk_items / self.rate
        if float(np.float32(span)) != span:
            raise ValueError(f"chunk span {span} s is not an f32 number")
        return span

    @property
    def capacity(self) -> int:
        """Per-stratum reservoir capacity per interval: the configured
        fraction of each stratum's own mean arrivals in an interval. The
        program takes one capacity for every stratum, so the strata's
        shares have to be equal."""
        weights = [float(s["weight"]) for s in self.config["strata"]]
        caps = {int(round(self.config["sample_fraction"] * self.rate
                          * self.config["interval_span_s"] * w
                          / sum(weights))) for w in weights}
        if len(caps) != 1:
            raise ValueError(
                f"the strata's capacities differ ({sorted(caps)}): the "
                "program holds one capacity for every stratum")
        return caps.pop()

    def source(self):
        return load_module(self.root / "sources"
                           / f"{self.config['generator']}.py",
                           f"streambench_source_{self.config['generator']}")


def _for_cell(entries: list, cell: str) -> list:
    return [e for e in entries if cell in e.get("workloads", [cell])]


def resolve(name: str, bench: Optional[dict] = None,
            root: Optional[Path] = None) -> Cell:
    """The cell ``name`` with every file it names loaded, from the tree
    ``root`` (``BENCH`` by default) and the ``BENCHMARK.json`` beside
    it."""
    root = BENCH if root is None else root
    if bench is None:
        bench = load_json(root.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root.parent / configs[w["config"]]["file"])
    mix = load_json(root / "mixes" / f"{w['traffic']}.json")
    queries = load_json(root / "queries" / w["config"]
                        / f"{mix['queries']}.json")
    limits = load_json(root / "limits" / f"{name}.json")
    return Cell(name=name, chips=int(w["chips"]), config=config, mix=mix,
                queries=queries, limits=limits,
                end_to_end=_for_cell(bench["end_to_end"], name),
                per_layer=_for_cell(bench["per_layer"], name), root=root)


def reader(metric: str, root: Optional[Path] = None):
    """The ``read`` function of one per-layer metric."""
    root = BENCH if root is None else root
    return load_module(root / "metrics" / f"{metric}.py",
                       "streambench_metric_" + metric.replace(".", "_")).read
