"""The port's telemetry hub, event log and exports, on the CPU.

The event log is the reference's schema (round trip, refusals), the
checkpoint costs are logged, staleness read from the log equals the
direct computation, ``counters`` / ``export`` / the Prometheus text are
the reference's for the same state, ``python -m repro_torch.obs.summarize
--smoke --device cpu`` runs, and attaching a ``Telemetry`` and a
``Checkpointer`` adds no read-back to a pipelined cadence push.
"""
import numpy as np
import pytest
import torch

from repro.core.error import Estimate as JEstimate
from repro.obs import export as jobx
from repro.obs import metrics as jobm
from repro.runtime import controller as jctl
from repro.runtime import registry as jreg
from repro.runtime import watermark as jwmk
from repro_torch import prng
from repro_torch.core.error import Estimate as TEstimate
from repro_torch.obs import EventLog, Telemetry, read_events, validate_event
from repro_torch.obs import export as obx
from repro_torch.obs import metrics as obm
from repro_torch.runtime import Checkpointer
from repro_torch.runtime import controller as tctl
from repro_torch.runtime import executor as tex
from repro_torch.runtime import watermark as twmk
from test_torch_checkpoint import (chunks, linear_registry, port_executor,
                                   ref_executor)
from test_torch_runtime import CONFIGS, _chunks, _registries, _tchunk


def _cfg(**kw):
    base = dict(num_strata=3, capacity=16, num_intervals=4,
                interval_span=1.0, allowed_lateness=0.4, emit_every=3)
    base.update(kw)
    return base


def _stream():
    return chunks(seed=5, n=12, chunk_size=96, disorder=0.3)


def test_event_log_jsonl_round_trip(tmp_path):
    path = str(tmp_path / "events.jsonl")
    with EventLog(path) as log:
        ex = port_executor("pipelined", _cfg(emission="watermark",
                                             allowed_lateness=0.25),
                           linear_registry(), 0,
                           checkpointer=Checkpointer(every_chunks=4),
                           telemetry=Telemetry(log))
        ex.run(_stream()[1])
        in_memory = list(log.events)
    back = read_events(path)
    assert back == in_memory
    assert {"run_meta", "emission", "watermark_close", "controller",
            "checkpoint_save"} <= {e["type"] for e in back}
    assert [e["seq"] for e in back] == list(range(len(back)))
    for ev in back:
        validate_event(ev)
    assert read_events(path, type="checkpoint_save") == \
        [e for e in back if e["type"] == "checkpoint_save"]


def test_event_validator_rejects_malformed():
    with pytest.raises(ValueError, match="unknown event type"):
        validate_event({"schema": 1, "type": "nope", "seq": 0})
    with pytest.raises(ValueError, match="missing fields"):
        validate_event({"schema": 1, "type": "checkpoint_save", "seq": 0})
    with pytest.raises(ValueError, match="schema version"):
        validate_event({"schema": 999, "type": "retrace", "seq": 0,
                        "step": "s", "traces": 2, "allowed": 1})
    with pytest.raises(ValueError, match="envelope"):
        validate_event({"type": "retrace"})
    with pytest.raises(ValueError, match="missing fields"):
        EventLog().emit("checkpoint_restore", stream_offset=3)


@pytest.mark.parametrize("mode", ["pipelined", "batched"])
def test_checkpoint_save_restore_events(mode):
    log = EventLog()
    ex = port_executor(mode, _cfg(batch_chunks=3), linear_registry(), 0,
                       checkpointer=Checkpointer(every_chunks=2, keep=None),
                       telemetry=Telemetry(log))
    ex.run(_stream()[1][:8])
    saves = log.of_type("checkpoint_save")
    assert len(saves) == len(ex.checkpointer.saved) > 0
    assert [ev["stream_offset"] for ev in saves] == \
        [off for off, _ in ex.checkpointer.saved]
    for ev, (_, payload) in zip(saves, ex.checkpointer.saved):
        assert ev["bytes"] == len(payload) and ev["serialize_s"] > 0.0
    drift = [ev["drift_chunks"] for ev in saves]
    if mode == "pipelined":
        assert drift == [0] * len(saves)      # exact cadence
    else:          # snapped to the flushes (none before chunk 3)
        assert [ev["stream_offset"] for ev in saves] == [0, 3, 6]
        assert drift == [-2, 1, 1]
    ex.restore(ex.checkpointer.latest)
    restores = log.of_type("checkpoint_restore")
    assert len(restores) == 1 and restores[0]["restore_s"] > 0.0
    assert restores[0]["stream_offset"] == ex.chunks_pushed
    stats = obx.checkpoint_stats(log.events)
    assert stats == jobx.checkpoint_stats(log.events)
    assert stats["saves"] == len(saves) and stats["restores"] == 1
    assert stats["bytes_total"] == sum(ev["bytes"] for ev in saves)
    s = ex.telemetry.summary()
    assert (s["checkpoint_saves"], s["checkpoint_restores"]) == \
        (len(saves), 1)
    assert s["last_recovery_s"] == restores[0]["restore_s"]
    if mode == "batched":
        assert log.of_type("batch_resize") == \
            [dict(log.of_type("batch_resize")[0], batch_chunks=3)]


def test_staleness_from_log_matches_direct_computation():
    cfg = _cfg(emission="watermark", allowed_lateness=0.25)
    stream = chunks(seed=9, n=16, chunk_size=96, disorder=0.3)[1]
    log = EventLog()
    ex = port_executor("pipelined", cfg, linear_registry(), 0,
                       telemetry=Telemetry(log))
    ems = ex.run(stream)
    assert len(ems) > 0
    direct = []
    for em in ems:
        close = np.float32((em.interval + 1) * cfg["interval_span"])
        for e2 in ems:
            if np.float32(e2.watermark) >= close:
                direct.append(float(np.float32(e2.watermark) - close))
                break
    assert obx.staleness_series(log.events) == direct
    assert ex.telemetry.staleness == [ev["staleness"] for ev in
                                      log.of_type("emission")]
    clog = EventLog()
    cex = port_executor("pipelined", _cfg(allowed_lateness=0.25),
                        linear_registry(), 0, telemetry=Telemetry(clog))
    cex.run(stream)
    assert obx.closed_intervals(clog.events) == [em.interval for em in ems]
    hw = obx.half_width_series(log.events, "avg")
    assert hw == pytest.approx([float(em.results["avg"].error_bound(0.95))
                                for em in ems])


def test_counters_exports_and_prometheus_text_match_reference():
    """The same state in both packages: the same counters, exports and
    Prometheus text, string for string."""
    jstream, tstream = _stream()
    je = ref_executor("pipelined", _cfg(), linear_registry(jreg), 0)
    te = port_executor("pipelined", _cfg(), linear_registry(), 0)
    je.run(jstream)
    te.run(tstream)
    jc, tc = jobm.counters(je.state.metrics), obm.counters(te.state.metrics)
    assert jc.keys() == tc.keys()
    for k in jc:
        np.testing.assert_array_equal(np.asarray(jc[k]), tc[k])
        assert type(tc[k]) is (int if k in ("chunks", "items")
                               else np.ndarray)
    assert obm.export(te.state.metrics) == jobm.export(je.state.metrics)
    assert twmk.export(te.state.wm) == jwmk.export(je.state.wm)
    ce, cj = tctl.export(te.state.ctrl), jctl.export(je.state.ctrl)
    assert ce["capacity"] == cj["capacity"]
    assert ce["base_capacity"] == cj["base_capacity"]
    tele = tctl.telemetry(te.state.ctrl)
    assert tele["capacity"] == jctl.telemetry(je.state.ctrl)["capacity"]
    assert obx.prometheus_text(te) == jobx.prometheus_text(je)
    # The host mirrors, set alike in both hubs, render alike.
    hubs = (Telemetry(), jobm.Telemetry())
    for hub in hubs:
        hub.latencies = [0.003, 0.001, 0.002]
        hub.watermark_lag = [0.5, 0.25]
        hub.capacity_traj = [[16, 16, 16], [8, 12, 16]]
        hub.batch_sizes = [4, 8]
        hub.emissions, hub.checkpoint_saves, hub.checkpoint_bytes = 3, 2, 99
    assert hubs[0].summary() == hubs[1].summary()
    assert obx.prometheus_text(te, hubs[0]) == \
        jobx.prometheus_text(je, hubs[1])
    ests = {"avg": ([1.5, 2.25], [0.01, -0.5]), "total": (1234.5, 16.0)}
    tt = {k: TEstimate(value=torch.tensor(v, dtype=torch.float32),
                       variance=torch.tensor(w, dtype=torch.float32))
          for k, (v, w) in ests.items()}
    jj = {k: JEstimate(value=np.asarray(v, np.float32),
                       variance=np.asarray(w, np.float32))
          for k, (v, w) in ests.items()}
    assert obx.estimates_prometheus_text(tt) == \
        jobx.estimates_prometheus_text(jj)


def test_export_round_trips():
    ex = port_executor("pipelined", _cfg(), linear_registry(), 0)
    ex.run(_stream()[1][:5])
    st = ex.state
    m = obm.from_export(obm.export(st.metrics), "cpu")
    wm = twmk.from_export(twmk.export(st.wm), "cpu")
    ctrl = tctl.from_export(tctl.export(st.ctrl), "cpu")
    for a, b in ((m, st.metrics), (wm, st.wm), (ctrl, st.ctrl)):
        for f in type(a).__dataclass_fields__:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and torch.equal(x, y), f


def test_summarize_cli_smoke(tmp_path, capsys):
    from repro_torch.obs import summarize
    path = str(tmp_path / "smoke.jsonl")
    assert summarize.main(["--smoke", path, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "staleness" in out and "hw95" in out and "saves=" in out
    assert summarize.main([path]) == 0
    assert capsys.readouterr().out == out


#: Fields of the smoke log's events that are wall-clock times, or the
#: byte size of each package's own archive of a payload.
_HOST_FIELDS = ("latency_s", "latency_ema", "serialize_s", "restore_s",
                "bytes")


def test_summarize_smoke_log_matches_the_reference(tmp_path):
    """The smoke run on the reference's stream (``ReplayableStream(
    StreamAggregator(GaussianSource(), seed=7), 128, 512.0)``, 16 chunks):
    the same events in the same order, every schedule field, count,
    capacity, watermark and offset equal, estimates within rtol 1e-5 and
    their 95% half-widths within the executors' width rtol 1e-4 (the
    Eq. 6 variance cancels in f32)."""
    from repro.obs import read_events as jread_events
    from repro.obs import summarize as jsummarize
    from repro_torch.obs import summarize
    jpath, tpath = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    jsummarize._smoke_log(jpath)
    summarize._smoke_log(tpath, device="cpu")
    jev, tev = jread_events(jpath), read_events(tpath)
    assert [e["type"] for e in jev] == [e["type"] for e in tev]
    assert sum(e["type"] == "emission" for e in tev) == 3
    for a, b in zip(jev, tev):
        assert a.keys() == b.keys(), a["type"]
        for f in a:
            if f in _HOST_FIELDS:
                continue
            if f == "results":
                assert a[f].keys() == b[f].keys()
                for name, r in a[f].items():
                    np.testing.assert_allclose(b[f][name]["value"],
                                               r["value"], rtol=1e-5)
                    np.testing.assert_allclose(b[f][name]["hw95"],
                                               r["hw95"], rtol=1e-4)
            else:
                assert a[f] == b[f], (a["type"], f)


def test_push_never_reads_back_with_telemetry_and_checkpointer(monkeypatch):
    """``test_torch_runtime``'s read-back check again, with a telemetry
    hub and a checkpointer attached: a pipelined cadence push reads
    nothing back."""
    cfg_kw = dict(CONFIGS["k3"], emit_every=1000)
    stream = _chunks(9, 6, 128, 3, 1.0)
    _, tr = _registries()
    log = EventLog()
    te = tex.PipelinedExecutor(tex.RuntimeConfig(**cfg_kw), tr,
                               prng.PRNGKey(0), device="cpu",
                               checkpointer=Checkpointer(every_chunks=1000),
                               telemetry=Telemetry(log))

    def refuse(*_):
        raise AssertionError("push read a tensor value back to the host")
    for name in ("item", "tolist", "__bool__", "__int__", "__float__",
                 "numpy", "cpu"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    for c in stream:
        te.push(_tchunk(c))
    monkeypatch.undo()
    assert te.chunks_pushed == 6 and not te.emissions
    assert [e["type"] for e in log.events] == ["run_meta"]
    assert len(te.finalize()) == 1
    assert [e["type"] for e in log.events] == ["run_meta", "emission",
                                               "controller"]
