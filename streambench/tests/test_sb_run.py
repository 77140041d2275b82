"""Whole runs on the CPU at a tiny size: the result line, a cell added
as files only, and the comparison failing on a broken program and on the
control."""
import json
import math
import shutil

import pytest
import torch

import tiny

CELLS = [w["name"] for w in tiny.benchmark()["workloads"]]


def test_result_line_schema(tmp_path, monkeypatch):
    r = tiny.run("gauss-bulk", tmp_path, monkeypatch)
    assert list(r)[:3] == ["correct", "attempted", "failed"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-2:] == ["checks", "_stderr"]
    assert set(r["metrics"]) == {"items_per_s", "emit_ms", "emit_p95_ms",
                                 "setup_s"}
    for m in r["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps({k: v for k, v in r.items() if k != "_stderr"})


def test_traced_run_gives_the_per_layer_metrics_it_can_read(tmp_path,
                                                            monkeypatch):
    r = tiny.run("gauss-late", tmp_path, monkeypatch, trace=True)
    assert r["correct"] is True
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["window_s"] > 0
    # No card: the rooflines and shares find nothing to read.
    assert "reservoir_fold_roofline" not in r["metrics"]


def test_a_cell_added_as_files_only_runs(tmp_path, monkeypatch):
    bench, root = tiny.use(monkeypatch, tmp_path)
    mix = json.loads((root / "mixes" / "bulk-linear.json").read_text())
    mix.update(emit_every=3, pool_chunks=12)
    (root / "mixes" / "every-third.json").write_text(json.dumps(mix))
    cfg = json.loads((root / "configs" / "paper-gaussian.json").read_text())
    cfg.update(name="two-streams", strata=cfg["strata"][:2])
    (root / "configs" / "two-streams.json").write_text(json.dumps(cfg))
    shutil.copytree(root / "queries" / "paper-gaussian",
                    root / "queries" / "two-streams")
    (root / "limits" / "two-third.json").write_text(
        (root / "limits" / "gauss-bulk.json").read_text())
    bench["configs"].append({"name": "two-streams", "source": "x",
                             "file": "sb/configs/two-streams.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "two-third", "config": "two-streams",
                               "traffic": "every-third", "chips": 1,
                               "why": "x"})
    tiny.save(bench, root)
    import run as entry
    r = entry.run_cell("two-third", 5, 1.0, False)
    assert r["correct"] is True and r["attempted"] > 0
    assert r["checks"]["checked_emissions"]["value"] >= 1


def _unchanged_state(ex):
    ex._ingest = lambda chunk: None


def _half_batch(ex):
    from repro_torch.runtime.records import TimestampedChunk
    ingest = ex._ingest

    def half(chunk):
        m = chunk.values.shape[-1] // 2
        ingest(TimestampedChunk(chunk.values[:m], chunk.stratum_ids[:m],
                                chunk.times[:m], chunk.mask[:m]))
    ex._ingest = half


def _answer_altered(ex):
    record = ex._record

    def altered(results, *a, **kw):
        name = next(iter(results))
        results[name].value = results[name].value * 1.001
        return record(results, *a, **kw)
    ex._record = altered


def _sample_altered(ex):
    """A tenth of stratum A's sampled items moved by 1 (about 10%) where
    the sample is made: the merged answers move by about 1e-6."""
    ingest = ex._ingest

    def altered(chunk):
        ingest(chunk)
        values = ex.state.window.intervals.values
        values[..., 0, :values.shape[-1] // 10] += 1.0
    ex._ingest = altered


FAULTS = {"state_unchanged": _unchanged_state, "half_batch": _half_batch,
          "answer_altered": _answer_altered,
          "sample_altered": _sample_altered}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_program_is_not_correct(tmp_path, monkeypatch, cell,
                                         fault):
    r = tiny.run(cell, tmp_path, monkeypatch, fault=FAULTS[fault])
    assert r["correct"] is False and r["failed"] > 0


def test_a_sample_altered_fails_the_sample_alone(tmp_path, monkeypatch):
    r = tiny.run("gauss-bulk", tmp_path, monkeypatch,
                 fault=_sample_altered)
    checks = {k: v["value"] for k, v in r["checks"].items()}
    assert checks["sample_off"] > 0
    assert checks["answer_gap"] <= r["checks"]["answer_gap"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_in_bfloat16_is_not_correct(tmp_path, monkeypatch,
                                                cell):
    import control
    tiny.use(monkeypatch, tmp_path)
    out = control.readings(cell, [11, 12, 13], 1.0)
    for seed in out:
        assert out[seed]["program"]["correct"] is True
        assert out[seed]["control"]["correct"] is False
        assert not math.isnan(out[seed]["control"]["answer_gap"])
