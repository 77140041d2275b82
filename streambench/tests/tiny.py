"""A copy of the benchmark's cell files at a size a CPU test holds: the
same cells, configurations and queries, each mix cut to 4,096 items a
chunk and an event-s and every second emission checked."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
ITEMS = 4096

for _p in (str(BENCH), str(REPO / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def benchmark() -> dict:
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


def tiny_tree(tmp: Path, items: int = ITEMS) -> tuple:
    """``(bench, root)``: the cell files copied under ``tmp/sb`` with
    every mix cut to ``items`` a chunk, and ``tmp/BENCHMARK.json``
    naming them (write ``bench`` there again after changing it)."""
    root = tmp / "sb"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    for path in (root / "mixes").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update(items_per_event_s=items, chunk_items=items,
                   check_stride=2)
        path.write_text(json.dumps(mix))
    bench = benchmark()
    for c in bench["configs"]:
        c["file"] = c["file"].replace("streambench/", "sb/", 1)
    save(bench, root)
    return bench, root


def save(bench: dict, root: Path) -> None:
    (root.parent / "BENCHMARK.json").write_text(json.dumps(bench))


def use(monkeypatch, tmp: Path, fault=None, cpu: bool = True) -> tuple:
    """Point the harness at the tiny tree (and at the CPU); with
    ``fault``, a function that breaks each executor the harness
    builds."""
    import torch
    from harness import cells, device, program
    bench, root = tiny_tree(tmp)
    monkeypatch.setattr(cells, "BENCH", root)
    if cpu:
        monkeypatch.setattr(device, "card",
                            lambda chips: torch.device("cpu"))
    if fault is not None:
        build = program.executor

        def broken(*args, **kwargs):
            ex = build(*args, **kwargs)
            fault(ex)
            return ex
        monkeypatch.setattr(program, "executor", broken)
    return bench, root


def run(cell: str, tmp: Path, monkeypatch, seed: int = 2 ** 31 + 99,
        seconds: float = 1.0, trace: bool = False, fault=None,
        cpu: bool = True) -> dict:
    import run as entry
    use(monkeypatch, tmp, fault, cpu)
    return entry.run_cell(cell, seed, seconds, trace)
