"""The port's retrace sentinel against the reference's, on the CPU.

The sentinel itself (budgets, ``allow``, warnings, strict raises, the
``REPRO_OBS_STRICT`` switch) behaves as the reference's; and on the same
chunks the port's executors log the reference's ``retrace`` events, count
the reference's traces and raise where the reference raises: a chunk of
another shape retraces the pipelined step, a batched run that resizes
its micro-batch under pressure stays inside its declared budget, and the
emission and query steps trace once.
"""
import warnings

import jax
import pytest
import torch

from repro.obs import EventLog as JEventLog
from repro.obs import RetraceError as JRetraceError
from repro.obs import RetraceSentinel as JRetraceSentinel
from repro.obs import Telemetry as JTelemetry
from repro.obs import sentinel as jsentinel
from repro.runtime import controller as jctl
from repro.runtime import registry as jreg
from repro_torch.obs import (EventLog, RetraceError, RetraceSentinel,
                             Telemetry, validate_event)
from repro_torch.obs import sentinel as tsentinel
from repro_torch.runtime import controller as tctl
from repro_torch.runtime.records import TimestampedChunk as TChunk
from test_torch_checkpoint import (chunks, linear_registry, port_executor,
                                   ref_executor)

PACKAGES = {
    "reference": (JRetraceSentinel, JRetraceError, JTelemetry, JEventLog),
    "port": (RetraceSentinel, RetraceError, Telemetry, EventLog),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test: the suite runs several worker
    processes on the same cores, and torch's thread pool contending with
    them makes these many small operations tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    base = dict(num_strata=3, capacity=16, num_intervals=4,
                interval_span=1.0, allowed_lateness=0.4, emit_every=3)
    base.update(kw)
    return base


def _stream(n=4):
    """The same chunks in both packages' types: ``{package: chunks}``."""
    jchunks, tchunks = chunks(seed=5, n=n, chunk_size=96, disorder=0.3)
    return {"reference": jchunks, "port": tchunks}


def _executor(package, mode, cfg):
    if package == "reference":
        return ref_executor(mode, cfg, linear_registry(jreg), 0)
    return port_executor(mode, cfg, linear_registry(), 0)


def _half(package, chunk):
    """The chunk's first half."""
    half = chunk.values.shape[0] // 2
    if package == "reference":
        return jax.tree.map(lambda x: x[:half], chunk)
    return TChunk(*(getattr(chunk, f)[:half]
                    for f in ("values", "stratum_ids", "times", "mask")))


def _retraces(log):
    return [(e["step"], e["traces"], e["allowed"])
            for e in log.of_type("retrace")]


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_sentinel_unit_budget_and_strict(package):
    """The reference's unit test, run on each package's sentinel."""
    Sentinel, Error, _, _ = PACKAGES[package]
    s = Sentinel("t", allowed=1, strict=False)
    s.trace()
    assert s.violations == 0
    with pytest.warns(RuntimeWarning, match="retraced after warmup"):
        s.trace()
    assert s.violations == 1
    s.allow(2)
    s.trace()
    assert s.violations == 1
    fresh = Sentinel("t1", allowed=0, strict=False)
    fresh.allow(1)
    fresh.trace()
    assert fresh.violations == 0
    strict = Sentinel("t2", allowed=0, strict=True)
    with pytest.raises(Error):
        strict.trace()


def test_sentinel_messages_hooks_and_env_switch(monkeypatch):
    """The same warning text, hook calls and repr; ``REPRO_OBS_STRICT``
    read the same way."""
    seen = {}
    for name, (Sentinel, Error, _, _) in PACKAGES.items():
        calls = []
        s = Sentinel("step", allowed=0, strict=False,
                     on_violation=lambda *a, calls=calls: calls.append(a))
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            s.trace()
        strict = Sentinel("step", allowed=0, strict=True)
        with pytest.raises(Error) as err:
            strict.trace()
        seen[name] = ([str(x.message) for x in w], calls, repr(s),
                      str(err.value))
    assert seen["port"] == seen["reference"]
    for value, want in (("", False), ("0", False), ("1", True),
                        ("yes", True)):
        monkeypatch.setenv("REPRO_OBS_STRICT", value)
        assert tsentinel.strict_from_env() is want
        assert jsentinel.strict_from_env() is want
        assert RetraceSentinel("x").strict is want


def test_signature_cache_traces_new_signatures_only():
    s = RetraceSentinel("t", allowed=3, strict=True)
    cache = tsentinel.SignatureCache(s)
    a = torch.zeros(4)
    cache.see(tsentinel.signature(a))
    cache.see(tsentinel.signature(torch.ones(4)))
    assert s.traces == 1
    cache.see(tsentinel.signature(a.double()))
    cache.see(tsentinel.signature(a[:2]))
    assert s.traces == 3 and s.violations == 0
    with pytest.raises(RetraceError):
        cache.see(tsentinel.signature(a[:1]))
    # A trace that raised is not cached: the same signature raises again.
    with pytest.raises(RetraceError):
        cache.see(tsentinel.signature(a[:1]))


@pytest.mark.parametrize("emission", ["cadence", "watermark"])
def test_executor_retrace_detected_and_logged(emission):
    """A chunk of half the size retraces the pipelined step: non-strict,
    both packages warn and log the same ``retrace`` event and count the
    same traces; strict, both raise."""
    stream = _stream()
    cfg = _cfg(emit_every=10_000, emission=emission)
    out = {}
    for name, (_, _, Telem, Log) in PACKAGES.items():
        log = Log()
        ex = _executor(name, "pipelined", cfg)
        ex.attach_telemetry(Telem(log, strict_retrace=False))
        for c in stream[name]:
            ex.push(c)
        assert ex.trace_count == 1
        with pytest.warns(RuntimeWarning, match="retraced after warmup"):
            ex.push(_half(name, stream[name][0]))
        out[name] = (ex.trace_count, _retraces(log), ex.emit_trace_count)
        if name == "port":
            for ev in log.of_type("retrace"):
                validate_event(ev)
    assert out["port"] == out["reference"]
    assert out["port"][:2] == (2, [("pipelined.step", 2, 1)])

    for name, (_, Error, Telem, Log) in PACKAGES.items():
        ex = _executor(name, "pipelined", cfg)
        ex.attach_telemetry(Telem(Log(), strict_retrace=True))
        ex.push(stream[name][0])
        with pytest.raises(Error):
            ex.push(_half(name, stream[name][0]))
        assert ex.chunks_pushed == 1


def test_batched_resize_stays_in_sentinel_budget():
    """Pressure-driven micro-batch resizes run new batch counts, each
    declared with ``allow``: quiet, and the reference's traces."""
    stream = _stream(12)
    got = {}
    for name, cc in (("reference", jctl.ControllerConfig),
                     ("port", tctl.ControllerConfig)):
        log = PACKAGES[name][3]()
        ex = _executor(name, "batched", _cfg(
            batch_chunks=2, max_batch_chunks=8,
            controller=cc(latency_budget_s=1e-9)))
        ex.attach_telemetry(PACKAGES[name][2](log))
        ex.run(stream[name])
        sent = ex._sentinels["window_step"]
        got[name] = (sent.traces, sent.allowed, sent.violations,
                     _retraces(log), [e.items for e in ex.emissions])
        if name == "reference":
            assert sent.traces == len(ex._step_cache)
    assert got["port"] == got["reference"]
    assert got["port"][0] >= 2 and got["port"][2] == 0


@pytest.mark.parametrize("mode", ["pipelined", "batched"])
def test_emission_and_query_steps_trace_once(mode):
    """Every step's traces after a whole run and two ad hoc queries, on
    the watermark and on cadence, are the reference's."""
    stream = _stream(8)
    for emission in ("cadence", "watermark"):
        cfg = _cfg(emission=emission, batch_chunks=2)
        counts = {}
        for name in PACKAGES:
            ex = _executor(name, mode, cfg)
            ex.attach_telemetry(PACKAGES[name][2](strict_retrace=True))
            ex.run(stream[name])
            ex.query()
            ex.query()
            counts[name] = {k: (s.traces, s.allowed, s.violations)
                            for k, s in ex._sentinels.items()}
        assert counts["port"] == counts["reference"], emission
        assert counts["port"]["query"] == (1, 1, 0)
