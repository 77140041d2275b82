"""BENCHMARK.json, its cells' files by name, and what the benchmark may
import and read."""
import ast
import json
import re
from pathlib import Path

import pytest

import tiny
from harness import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_keys_names_and_units():
    b = tiny.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["streambench"]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("streambench/")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  tiny.benchmark()["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    c = cells.resolve(cell)
    assert c.queries and c.limits and c.end_to_end and c.per_layer
    assert callable(c.source().make)
    for m in c.per_layer:
        assert callable(cells.reader(m["name"]))
    assert c.capacity * c.num_strata == round(
        c.config["sample_fraction"] * c.rate * c.config["interval_span_s"])


def test_strata_of_unequal_shares_are_refused():
    c = cells.resolve(tiny.benchmark()["workloads"][0]["name"])
    c.config = dict(c.config, strata=[dict(s, weight=w) for s, w in
                                      zip(c.config["strata"], (5, 3, 2))])
    with pytest.raises(ValueError, match="one capacity"):
        c.capacity


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(p for p in tiny.BENCH.rglob("*.py")
                 if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(tiny.BENCH)))
def test_no_jax_and_nothing_of_the_old_benchmark(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}
    text = path.read_text()
    # The JAX package's benchmark folder and its result files.
    assert not any(w in text for w in ("bench" + "marks/", "BENCH" + "_"))


@pytest.mark.parametrize("path", sorted(
    (tiny.BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert _imports(path) <= {"__future__", "dataclasses", "typing",
                              "numpy", "torch", "reference"}


def test_mixes_configs_and_queries_are_data():
    for sub in ("configs", "mixes", "queries", "limits"):
        for p in (tiny.BENCH / sub).rglob("*"):
            if p.is_file():
                assert p.suffix == ".json"
                json.loads(p.read_text())
